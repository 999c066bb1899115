"""The port's gRPC service (``…_torch/comms/service.py``) against the JAX
package's, handler by handler: one scripted sequence of request envelopes,
built once, goes straight into the handler methods (``ctx=None``) of a JAX
``ParameterService`` and of the port's, each over its own store built from
the same NumPy params. Every reply must be equal byte for byte and the two
stores' snapshots bit-equal afterwards; the parts of the JAX service this
slice leaves out are refused, naming their ROADMAP item."""

import threading

import numpy as np
import pytest

from distributed_parameter_server_for_ml_training_tpu.comms import \
    service as JS
from distributed_parameter_server_for_ml_training_tpu.comms.wire import \
    encode_tensor_dict as jax_encode
from distributed_parameter_server_for_ml_training_tpu.ops.compression \
    import compress_push as jax_compress_push, fp16_compress
from distributed_parameter_server_for_ml_training_tpu.ps.store import (
    ParameterStore as JaxStore, StoreConfig as JaxConfig)
from distributed_parameter_server_for_ml_training_tpu_torch.comms import \
    service as PS
from distributed_parameter_server_for_ml_training_tpu_torch.ps.store import (
    ParameterStore, StoreConfig)

SHAPES = {"conv/kernel": (3, 3, 3, 8), "conv/bias": (8,),
          "dense/kernel": (8, 10), "dense/bias": (10,)}

#: (mode, push codec, staleness bound) of each scripted run.
CASES = {"sync_fp16": ("sync", "fp16", 5),
         "sync_int8": ("sync", "int8", 5),
         "async_int8": ("async", "int8", 2)}


def _params():
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(seed: int, codec: str) -> dict:
    rng = np.random.default_rng(100 + seed)
    g = {k: (rng.standard_normal(s) * 1e-2).astype(np.float32)
         for k, s in SHAPES.items()}
    if codec == "fp16":
        return fp16_compress(g)
    return jax_compress_push(g, {k: "int8" for k in g})


def script(codec: str) -> list:
    """The request sequence: (rpc, request bytes). Built with the JAX
    package's envelope and frame functions (the port's are byte-equal,
    test_torch_wire.py)."""
    pack = JS.pack_msg

    def push(wid, grads_seed, token, fetched_step=0, corrupt=False):
        frame = bytearray(jax_encode(_grads(grads_seed, codec),
                                     checksum=True))
        if corrupt:
            frame[len(frame) // 2] ^= 0x01
        meta = {"worker_id": wid, "fetched_step": fetched_step}
        if token is not None:
            meta["push_token"] = token
        meta["directives_ack"] = 0
        return ("push_gradrients", pack(meta, bytes(frame)))

    nonce = "0123456789ab"
    return [
        ("register_worker", pack({"worker_name": "w0",
                                  "capabilities": ["directives"]})),
        ("register_worker", pack({"worker_name": "w1"})),
        ("fetch_parameters", pack({"worker_id": 0, "directives_ack": 0,
                                   "have_qscales": 0})),
        ("fetch_parameters", pack({"worker_id": 0, "directives_ack": 0,
                                   "have_step": 0, "have_qscales": 0})),
        push(0, 1, f"{nonce}:1"),
        push(0, 1, f"{nonce}:1"),                   # retry: duplicate
        push(0, 1, f"{nonce}:1", corrupt=True),     # corrupt retry: refused
        push(0, 2, f"{nonce}:0"),                   # zombie: stale_token
        push(0, 3, f"{nonce}:2", corrupt=True),     # CRC refused
        push(0, 3, f"{nonce}:2"),                   # clean retry: applied
        push(1, 4, None, fetched_step=1),           # untokened
        ("fetch_parameters", pack({"worker_id": 1, "have_step": 0,
                                   "have_qscales": 0})),
        ("fetch_parameters", pack({"worker_id": 1, "have_step": 0,
                                   "have_qscales": 10 ** 6})),
        ("fetch_parameters", pack({})),
        ("job_finished", pack({"worker_id": 0})),
        ("job_finished", pack({"worker_id": 1})),
    ]


def _run(service, requests):
    return [getattr(service, rpc)(req, None) for rpc, req in requests]


@pytest.mark.parametrize("case", list(CASES))
def test_scripted_sequence_replies_equal_byte_for_byte(case, capsys):
    mode, codec, bound = CASES[case]
    requests = script(codec)
    jax_store = JaxStore(_params(), JaxConfig(
        mode=mode, total_workers=2, push_codec=codec,
        staleness_bound=bound))
    port_store = ParameterStore(_params(), StoreConfig(
        mode=mode, total_workers=2, push_codec=codec,
        staleness_bound=bound))
    want = _run(JS.ParameterService(jax_store), requests)
    got = _run(PS.ParameterService(port_store), requests)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g == w, (i, requests[i][0], PS.unpack_msg(g)[0],
                        JS.unpack_msg(w)[0])
    metas = [PS.unpack_msg(r)[0] for r in got]
    # The sequence reached every branch it scripts.
    assert metas[0]["checksum"] and metas[0]["delta_fetch"] \
        and metas[0]["compressed_domain"]
    assert metas[3]["not_modified"]
    assert metas[5]["duplicate"] and not metas[5].get("stale_token")
    # The checksum gate comes before the dedupe: a corrupt copy of an
    # applied token is refused, not answered as its duplicate.
    assert metas[6]["corrupt"] and "duplicate" not in metas[6]
    assert metas[7]["stale_token"]
    assert metas[8]["corrupt"] and not metas[8]["accepted"]
    assert metas[9]["accepted"] and "duplicate" not in metas[9]
    assert "WIRE_CORRUPT push refused worker=0" in capsys.readouterr().out
    (jp, jstep), (pp, pstep) = jax_store.snapshot(), port_store.snapshot()
    assert jstep == pstep > 0
    assert list(pp) == list(jp)
    for k in jp:
        assert pp[k].tobytes() == jp[k].tobytes(), k
    assert port_store.gradient_scales() == jax_store.gradient_scales()
    assert port_store.wait_all_finished(0) and jax_store.wait_all_finished(0)
    if case == "sync_int8":
        # A completed int8 round publishes shared scales to the fetch.
        assert "qscales" in metas[11] and "qscales" not in metas[12]


def test_in_flight_duplicate_without_an_outcome_fails_retryably():
    """A retry that finds its original still in flight (here: an entry
    with no outcome) waits at most the caller's remaining deadline minus
    a margin, then fails retryably in both services."""

    class Ctx:
        def time_remaining(self):
            return 1.05

        def abort(self, code, msg):
            raise RuntimeError(code, msg)

    codec = "int8"
    _, req = script(codec)[4]
    assert b'"push_token": "0123456789ab:1"' in req
    for svc_mod, store in ((JS, JaxStore(_params(), JaxConfig(
            mode="async", total_workers=1, push_codec=codec))),
            (PS, ParameterStore(_params(), StoreConfig(
                mode="async", total_workers=1, push_codec=codec)))):
        svc = svc_mod.ParameterService(store)
        svc._push_seen["0123456789ab"] = [1, None, threading.Event(), 0,
                                          None]
        with pytest.raises(RuntimeError) as e:
            svc.push_gradrients(req, Ctx())
        assert e.value.args[0].name == "UNAVAILABLE"
        assert store.global_step == 0


def test_undecodable_frame_undoes_the_dedupe_entry(capsys):
    """A frame without a trailer that does not decode is refused and its
    token's entry removed, so the clean retry applies — in both."""
    good = jax_encode(_grads(1, "int8"))
    meta = {"worker_id": 0, "fetched_step": 0, "push_token": "feed:1"}
    bad = JS.pack_msg(meta, good[:-3])
    clean = JS.pack_msg(meta, good)
    replies = {}
    for name, svc_mod, store in (
            ("jax", JS, JaxStore(_params(), JaxConfig(
                mode="async", total_workers=1, push_codec="int8"))),
            ("port", PS, ParameterStore(_params(), StoreConfig(
                mode="async", total_workers=1, push_codec="int8")))):
        svc = svc_mod.ParameterService(store)
        replies[name] = [svc.push_gradrients(bad, None),
                         svc.push_gradrients(clean, None)]
        assert store.global_step == 1
    assert replies["port"] == replies["jax"]
    assert PS.unpack_msg(replies["port"][0])[0]["corrupt"]
    assert PS.unpack_msg(replies["port"][1])[0]["accepted"]


@pytest.mark.parametrize("token,want", [
    ("abc:12", ("abc", 12)), ("a:b:3", ("a:b", 3)), ("plain", ("plain", -1)),
    ("x:-1", ("x:-1", -1)), (7, ("7", -1))])
def test_parse_push_token_matches_jax(token, want):
    assert PS.parse_push_token(token) == JS.parse_push_token(token) == want


@pytest.mark.parametrize("meta", [{}, {"a": 1, "b": [1, 2]},
                                  {"h": JS.RawJSON('{"x": 1}'), "k": 2}])
def test_envelope_matches_jax(meta):
    port_meta = {k: PS.RawJSON(v) if isinstance(v, JS.RawJSON) else v
                 for k, v in meta.items()}
    raw = PS.pack_msg(port_meta, b"xyz")
    assert raw == JS.pack_msg(meta, b"xyz")
    m, payload = PS.unpack_msg(raw)
    assert bytes(payload) == b"xyz" and m == JS.unpack_msg(raw)[0]
    assert PS.GRPC_OPTIONS == JS.GRPC_OPTIONS
    assert PS.SERVICE_NAME == JS.SERVICE_NAME


def test_capability_advertisement_is_a_default_jax_servers():
    req = JS.pack_msg({"worker_name": "w"})
    want = JS.unpack_msg(JS.ParameterService(JaxStore(
        _params(), JaxConfig(mode="async", total_workers=1,
                             push_codec="int8"))).register_worker(req,
                                                                  None))[0]
    got = PS.unpack_msg(PS.ParameterService(ParameterStore(
        _params(), StoreConfig(mode="async", total_workers=1,
                               push_codec="int8"))).register_worker(req,
                                                                    None))[0]
    assert list(got.items()) == list(want.items())


@pytest.mark.parametrize("kwarg,item", [
    ("faults", "item 9"), ("monitor", "item 8"),
    ("reject_nonfinite", "item 8"), ("sharding", "item 9"),
    ("jobs", "item 9")])
def test_unported_service_options_are_refused(kwarg, item):
    store = ParameterStore(_params(), StoreConfig(total_workers=1))
    with pytest.raises(NotImplementedError, match=item):
        PS.ParameterService(store, **{kwarg: True})


@pytest.mark.parametrize("call,item", [
    (lambda s: s.journal_snapshot(), "item 5"),
    (lambda s: s.load_journal([]), "item 5"),
    (lambda s: s.quarantine(0, 1.0), "item 8"),
    (lambda s: s.post_directive(0, "drain"), "item 8"),
    (lambda s: s.reshard(JS.pack_msg({"op": "status"}), None), "item 9"),
    (lambda s: s.submit_job(JS.pack_msg({}), None), "item 9"),
    (lambda s: PS.WeightedFairAdmission(None), "item 9")],
    ids=["journal_snapshot", "load_journal", "quarantine", "post_directive",
         "reshard", "submit_job", "admission"])
def test_unported_service_parts_are_refused(call, item):
    svc = PS.ParameterService(ParameterStore(_params(),
                                             StoreConfig(total_workers=1)))
    with pytest.raises(NotImplementedError, match=item):
        call(svc)


def test_port_store_declares_the_jax_capability_flags():
    for flag in ("supports_delta_fetch", "supports_compressed_domain"):
        assert getattr(ParameterStore, flag) is getattr(JaxStore, flag) \
            is True
