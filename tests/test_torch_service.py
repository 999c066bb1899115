"""The port's gRPC service (``…_torch/comms/service.py``) against the JAX
package's, handler by handler: one scripted sequence of request envelopes,
built once, goes straight into the handler methods (``ctx=None``) of a JAX
``ParameterService`` and of the port's, each over its own store built from
the same NumPy params. Every reply must be equal byte for byte and the two
stores' snapshots bit-equal afterwards — also for an elastic store with a
``worker_timeout`` and bf16 fetches, under a scripted clock, and for
device-resident stores (the JAX ``DeviceParameterStore`` on the CPU, the
port's with ``device="cpu"``); the push-token journal a checkpoint
persists is the JAX service's, and a service that loads it answers a
retry as a duplicate; with a cluster monitor, ``reject_nonfinite``,
quarantines and posted directives, one scripted sequence of requests and
service calls gives byte-equal replies and equal returns; the parts of
the JAX service this slice leaves out are refused, naming their ROADMAP
item."""

import threading
import time

import numpy as np
import pytest

from distributed_parameter_server_for_ml_training_tpu.comms import \
    service as JS
from distributed_parameter_server_for_ml_training_tpu.comms.wire import \
    encode_tensor_dict as jax_encode
from distributed_parameter_server_for_ml_training_tpu.ops.compression \
    import compress_push as jax_compress_push, fp16_compress
from distributed_parameter_server_for_ml_training_tpu.ps.device_store \
    import DeviceParameterStore as JaxDeviceStore
from distributed_parameter_server_for_ml_training_tpu.ps.store import (
    ParameterStore as JaxStore, StoreConfig as JaxConfig)
from distributed_parameter_server_for_ml_training_tpu_torch.comms import \
    service as PS
from distributed_parameter_server_for_ml_training_tpu_torch.ps \
    .device_store import DeviceParameterStore
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
    if codec == "none":
        return g
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


def elastic_script() -> list:
    """(clock seconds, rpc, request) of an elastic, expiring, bf16-fetch
    run: two workers register, one goes silent and is expired by the
    other's push activity (the throttled expiry tick), the survivor's
    round completes, a replacement takes the freed slot."""
    pack = JS.pack_msg

    def push(wid, seed, count, step):
        return ("push_gradrients", pack(
            {"worker_id": wid, "fetched_step": step,
             "push_token": f"cafe{wid}:{count}", "directives_ack": 0},
            jax_encode(_grads(seed, "int8"), checksum=True)))

    def fetch(wid, **kw):
        return ("fetch_parameters", pack({"worker_id": wid,
                                          "directives_ack": 0,
                                          "have_qscales": 0, **kw}))
    reg = [("register_worker", pack({"worker_name": f"w{i}",
                                     "capabilities": ["directives"]}))
           for i in range(3)]
    return [(0, *reg[0]), (0, *reg[1]), (0, *fetch(0)), (1, *fetch(1)),
            (2, *push(0, 1, 1, 0)), (5, *fetch(0, have_step=0)),
            (12, *push(0, 2, 2, 0)),           # tick expires worker 1
            (12, *fetch(0, have_step=0)), (12, *fetch(0, have_step=1)),
            (13, *reg[2]),                     # reuses slot 1
            (13, *push(1, 3, 1, 1)), (14, *push(0, 4, 3, 1)),
            (14, *fetch(1, have_step=1)),
            (15, "job_finished", pack({"worker_id": 0})),
            (15, "job_finished", pack({"worker_id": 1}))]


def test_elastic_expiry_bf16_fetch_replies_equal_byte_for_byte(
        monkeypatch, capsys):
    now = {"t": 0.0}
    monkeypatch.setattr(time, "time", lambda: 5_000.0 + now["t"])
    kwargs = dict(mode="sync", total_workers=2, push_codec="int8",
                  elastic=True, worker_timeout=10, fetch_codec="bf16")
    replies = {}
    for name, svc in (
            ("jax", JS.ParameterService(JaxStore(_params(),
                                                 JaxConfig(**kwargs)))),
            ("port", PS.ParameterService(ParameterStore(
                _params(), StoreConfig(**kwargs))))):
        out = []
        for t, rpc, req in elastic_script():
            now["t"] = t
            out.append(getattr(svc, rpc)(req, None))
        replies[name] = (out, svc.store)
    (want, jstore), (got, pstore) = replies["jax"], replies["port"]
    for i, (w, g) in enumerate(zip(want, got)):
        assert g == w, (i, PS.unpack_msg(g)[0], JS.unpack_msg(w)[0])
    metas = [PS.unpack_msg(r)[0] for r in got]
    assert metas[0]["elastic"] and metas[1]["active_workers"] == [0, 1]
    assert metas[7]["active_workers"] == [0]     # worker 1 expired
    assert metas[9]["worker_id"] == 1 and metas[9]["active_workers"] \
        == [0, 1]
    assert "expired silent workers: [1]" in capsys.readouterr().out
    # A full bf16 fetch is half the fp32 bytes of the params.
    full = [len(r) for r, m in zip(got, metas)
            if "global_step" in m and not m.get("not_modified")
            and "accepted" not in m]
    assert full and all(n < 4 * sum(a.size for a in _params().values())
                        for n in full)
    (jp, jstep), (pp, pstep) = jstore.snapshot(), pstore.snapshot()
    # Rounds: the expiry completes the survivor's pending one, its own
    # push the next (target 1), the replacement's joins the third.
    assert jstep == pstep == 3
    for k in jp:
        assert pp[k].tobytes() == jp[k].tobytes(), k
    assert pstore.wait_all_finished(0) and jstore.wait_all_finished(0)


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


@pytest.mark.parametrize("kwarg,item", [("jobs", "item 9")])
def test_unported_service_options_are_refused(kwarg, item):
    store = ParameterStore(_params(), StoreConfig(total_workers=1))
    with pytest.raises(NotImplementedError, match=item):
        PS.ParameterService(store, **{kwarg: True})


def test_service_faults_replay_the_jax_services_script():
    """``faults=`` (refused until the serve tier landed): one scripted
    request sequence into both services' fault-wrapped handlers, with
    ``ctx=None``, gives the same replies and the same injected failures
    call by call, and bit-equal stores (a dropped reply still applied)."""
    from distributed_parameter_server_for_ml_training_tpu.comms.faults \
        import InjectedRpcError as JaxInjected
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .faults import InjectedRpcError
    spec = ("seed=5;push.drop_reply@n=2;fetch.unavailable@every=3;"
            "register.deadline@n=1")
    outcomes, stores = {}, {}
    for name, mod, store in (
            ("jax", JS, JaxStore(_params(), JaxConfig(
                mode="async", total_workers=1))),
            ("port", PS, ParameterStore(_params(), StoreConfig(
                mode="async", total_workers=1)))):
        svc = mod.ParameterService(store, faults=spec)
        wrap = svc.faults.wrap_handler
        seq = []
        calls = [("RegisterWorker", svc.register_worker,
                  JS.pack_msg({"worker_name": "w"}))] * 2
        for i in range(4):
            grads = {k: np.full_like(v, 0.01 * (i + 1))
                     for k, v in _params().items()}
            calls.append(("FetchParameters", svc.fetch_parameters,
                          JS.pack_msg({"worker_id": 0})))
            calls.append(("PushGradrients", svc.push_gradrients,
                          JS.pack_msg({"worker_id": 0, "fetched_step": i,
                                       "push_token": f"n:{i}"},
                                      jax_encode(grads))))
        for rpc, fn, req in calls:
            try:
                seq.append(bytes(wrap(rpc, fn)(req, None)))
            except (InjectedRpcError, JaxInjected) as e:
                seq.append((e.code(), e.details()))
        outcomes[name], stores[name] = seq, store
    assert outcomes["port"] == outcomes["jax"]
    (jp, jstep), (pp, pstep) = (stores["jax"].snapshot(),
                                stores["port"].snapshot())
    assert pstep == jstep == 4
    for k, v in jp.items():
        np.testing.assert_array_equal(pp[k], v)


@pytest.mark.parametrize("call,item", [
    (lambda s: s.submit_job(JS.pack_msg({}), None), "item 9"),
    (lambda s: PS.WeightedFairAdmission(None), "item 9")],
    ids=["submit_job", "admission"])
def test_unported_service_parts_are_refused(call, item):
    svc = PS.ParameterService(ParameterStore(_params(),
                                             StoreConfig(total_workers=1)))
    with pytest.raises(NotImplementedError, match=item):
        call(svc)


def test_port_store_declares_the_jax_capability_flags():
    for flag in ("supports_delta_fetch", "supports_compressed_domain"):
        assert getattr(ParameterStore, flag) is getattr(JaxStore, flag) \
            is True


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_device_store_replies_equal_byte_for_byte(mode, capsys):
    """The scripted sequence (fp32 pushes: a device store takes no codec)
    into a JAX service over a JAX ``DeviceParameterStore`` and the port's
    over its own, on the CPU: every reply byte-equal (the port's fetch
    brings the params to the host), the stores bit-equal after."""
    requests = script("none")
    jax_store = JaxDeviceStore(_params(), JaxConfig(
        mode=mode, total_workers=2, staleness_bound=5))
    port_store = DeviceParameterStore(_params(), StoreConfig(
        mode=mode, total_workers=2, staleness_bound=5), device="cpu")
    want = _run(JS.ParameterService(jax_store), requests)
    got = _run(PS.ParameterService(port_store), requests)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g == w, (i, requests[i][0], PS.unpack_msg(g)[0],
                        JS.unpack_msg(w)[0])
    assert PS.unpack_msg(got[0])[0]["push_codec"] == "none"
    jp, js = jax_store.snapshot()
    pp, ps = port_store.snapshot()
    assert ps == js > 0 and list(pp) == list(jp)
    for k in jp:
        assert pp[k].tobytes() == jp[k].tobytes(), k


@pytest.mark.parametrize("stage", ["journal_snapshot", "load_journal"])
def test_push_journal_is_the_jax_services(stage, capsys):
    """``journal_snapshot`` after the scripted sequence equals the JAX
    service's entry for entry; each service loaded with that journal
    answers the retry of the last tokened push with the same duplicate
    reply, applying nothing."""
    requests = script("int8")
    jax_svc = JS.ParameterService(JaxStore(_params(), JaxConfig(
        mode="async", total_workers=2, push_codec="int8")))
    port_svc = PS.ParameterService(ParameterStore(_params(), StoreConfig(
        mode="async", total_workers=2, push_codec="int8")))
    _run(jax_svc, requests)
    _run(port_svc, requests)
    journal = jax_svc.journal_snapshot()
    assert journal and port_svc.journal_snapshot() == journal
    if stage == "journal_snapshot":
        return
    retry = [r for r in requests if r[0] == "push_gradrients"][-2]
    replies = []
    for svc_mod, store in (
            (JS, JaxStore(_params(), JaxConfig(
                mode="async", total_workers=2, push_codec="int8"))),
            (PS, ParameterStore(_params(), StoreConfig(
                mode="async", total_workers=2, push_codec="int8")))):
        svc = svc_mod.ParameterService(store)
        assert svc.load_journal(journal + [{"nonce": "x"}]) == len(journal)
        replies.append(getattr(svc, retry[0])(retry[1], None))
        assert store.global_step == 0
    assert replies[0] == replies[1]
    assert PS.unpack_msg(replies[1])[0]["duplicate"] is True


def healing_script(codec: str) -> list:
    """(clock seconds, kind, what, argument) of a self-healing run: two
    elastic workers (w0 hears directives, w1 is a legacy peer) register
    and report; w0's push whose own report is non-finite is refused as
    quarantined without a dedupe entry, so its clean retry applies; while
    w0 is quarantined a retry of that applied token replays as a
    duplicate and a new push is refused; directives are posted past the
    cap (and to the legacy peer, and an unknown one), ride fetch and push
    replies, and are acked; the quarantine lapses by time and is lifted
    by hand; w0 says goodbye and a replacement takes its slot with no
    directive or quarantine of its predecessor's."""
    pack = JS.pack_msg
    healthy = {"step": 1, "loss": 2.5, "grad_norm": 1.0,
               "loss_finite": True, "grad_finite": True}
    poisoned = {"step": 2, "loss": None, "grad_norm": None,
                "loss_finite": False, "grad_finite": False}

    def push(wid, seed, token, ack=None, health=None, step=0):
        meta = {"worker_id": wid, "fetched_step": step}
        if token is not None:
            meta["push_token"] = token
        if health is not None:
            meta["health"] = health
        if ack is not None:
            meta["directives_ack"] = ack
        return ("rpc", "push_gradrients", pack(
            meta, jax_encode(_grads(seed, codec), checksum=True)))

    def fetch(wid, ack=None, health=None, **kw):
        meta = {"worker_id": wid, **kw}
        if health is not None:
            meta["health"] = health
        if ack is not None:
            meta["directives_ack"] = ack
        return ("rpc", "fetch_parameters", pack(meta))

    def call(name, *args, **kw):
        return ("call", name, (args, kw))

    n = "00ff00ff00ff"
    w0 = pack({"worker_name": "w0", "capabilities": ["directives"]})
    return [
        (0, "rpc", "register_worker", w0),
        (0, "rpc", "register_worker", pack({"worker_name": "w1"})),
        (0, *fetch(0, ack=0, health=healthy)),
        (1, *push(0, 1, f"{n}:1", ack=0, health=healthy)),
        (1, *push(0, 2, f"{n}:2", ack=0, health=poisoned)),   # refused
        (1, *push(0, 2, f"{n}:2", ack=0, health=healthy)),    # applies
        (2, *call("quarantine", 0, 30.0)),
        (2, *call("is_quarantined", 0)),
        (2, *push(0, 2, f"{n}:2", ack=0, health=healthy)),    # duplicate
        (2, *push(0, 3, f"{n}:3", ack=0, health=healthy)),    # refused
        (2, *push(1, 4, None, step=1)),                       # applies
        (3, *call("quarantine", 1, 5.0)),
        (3, *push(1, 5, None, step=1)),                       # refused
        *[(3, *call("post_directive", 0, "quarantine", steps=k))
          for k in range(1, 19)],                             # past the cap
        (3, *call("post_directive", 0, "refetch_params")),
        (3, *call("post_directive", 1, "drain")),             # legacy: None
        (3, *call("post_directive", 0, "reboot")),            # ValueError
        (3, *call("directives_for", 0)),
        (4, *fetch(0, ack=0, have_step=0)),                   # all 16 ride
        (4, *push(0, 3, f"{n}:3", ack=10, health=healthy)),   # still held
        (4, *call("quarantine_view")),
        (9, *call("is_quarantined", 1)),                      # lapsed
        (9, *push(1, 5, None, step=1)),
        (9, *call("unquarantine", 0)),
        (9, *push(0, 3, f"{n}:3", ack=15, health=healthy)),   # applies
        (9, *fetch(0, ack=19, have_step=4, health=healthy)),
        (10, *call("post_directive", 0, "drain")),
        (10, *call("quarantine", 0, 30.0)),
        (10, "rpc", "job_finished", pack({"worker_id": 0})),
        (11, "rpc", "register_worker", w0),                   # slot 0 again
        (11, *call("directives_for", 0)),
        (11, *call("is_quarantined", 0)),
        (11, *call("quarantine_view")),
        (11, *push(0, 6, "abcdefabcdef:1", ack=0, health=healthy, step=4)),
        (11, *fetch(0, ack=0, health=healthy)),
    ]


def _heal(service, steps, clock):
    """Run ``healing_script`` steps into ``service`` on ``clock``: each
    handler's reply bytes or each call's return (a ValueError's text)."""
    out = []
    for t, kind, what, arg in steps:
        clock["t"] = t
        if kind == "rpc":
            out.append(getattr(service, what)(arg, None))
            continue
        args, kw = arg
        try:
            out.append(getattr(service, what)(*args, **kw))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


@pytest.mark.parametrize("codec,backend", [("int8", "host"),
                                           ("fp16", "host"),
                                           ("none", "device")])
def test_self_healing_sequence_replies_equal_byte_for_byte(
        codec, backend, monkeypatch, capsys):
    from distributed_parameter_server_for_ml_training_tpu.telemetry \
        import ClusterMonitor as JaxMonitor
    from distributed_parameter_server_for_ml_training_tpu.telemetry \
        .registry import MetricsRegistry as JaxRegistry
    from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
        import ClusterMonitor, MetricsRegistry

    clock = {"t": 0.0}
    monkeypatch.setattr(time, "time", lambda: 9_000.0 + clock["t"])
    kwargs = dict(mode="async", total_workers=2, elastic=True,
                  staleness_bound=5)
    if backend == "host":
        jax_store = JaxStore(_params(), JaxConfig(push_codec=codec,
                                                  **kwargs))
        port_store = ParameterStore(_params(), StoreConfig(
            push_codec=codec, **kwargs))
    else:
        jax_store = JaxDeviceStore(_params(), JaxConfig(**kwargs))
        port_store = DeviceParameterStore(_params(), StoreConfig(**kwargs),
                                          device="cpu")
    steps = healing_script(codec)
    runs = {}
    for name, svc_mod, store, mon, reg in (
            ("jax", JS, jax_store, JaxMonitor, JaxRegistry),
            ("port", PS, port_store, ClusterMonitor, MetricsRegistry)):
        monitor = mon(store, registry=reg(), clock=time.time)
        svc = svc_mod.ParameterService(store, monitor=monitor,
                                       reject_nonfinite=True)
        runs[name] = (_heal(svc, steps, clock), monitor)
    (want, jmon), (got, pmon) = runs["jax"], runs["port"]
    for i, (w, g) in enumerate(zip(want, got)):
        assert g == w, (i, steps[i][:3], g if not isinstance(g, bytes)
                        else PS.unpack_msg(g)[0],
                        w if not isinstance(w, bytes)
                        else JS.unpack_msg(w)[0])
    metas = {i: PS.unpack_msg(g)[0] for i, g in enumerate(got)
             if isinstance(g, bytes)}
    assert metas[0]["health_report"] is True
    assert metas[3]["accepted"] and metas[4]["quarantined"] \
        and not metas[4]["accepted"]
    assert metas[5]["accepted"] and "duplicate" not in metas[5]
    assert metas[8]["duplicate"] and metas[8]["accepted"]
    assert metas[9]["quarantined"] and metas[12]["quarantined"]
    assert metas[10]["accepted"] and not metas[12]["accepted"]
    # 19 posts to w0 (seq 1-19): the cap keeps the newest 16; the legacy
    # peer gets none; an unknown action is refused.
    assert got[31] == 19 and got[32] is None and got[33][0] == "ValueError"
    assert [d["seq"] for d in got[34]] == list(range(4, 20))
    assert [d["seq"] for d in metas[35]["directives"]] == list(range(4, 20))
    assert metas[36]["quarantined"] \
        and [d["seq"] for d in metas[36]["directives"]] == list(range(11, 20))
    assert got[37] == {0: 28.0, 1: 4.0} and got[38] is False
    assert metas[39]["accepted"] and metas[41]["accepted"]
    assert [d["seq"] for d in metas[41]["directives"]] == list(range(16, 20))
    assert "directives" not in metas[42]
    # The replacement in slot 0 inherits neither directives nor quarantine.
    assert metas[46]["worker_id"] == 0
    assert got[47] == [] and got[48] is False and got[49] == {}
    assert metas[50]["accepted"] and "directives" not in metas[51]
    (jp, jstep), (pp, pstep) = jax_store.snapshot(), port_store.snapshot()
    assert jstep == pstep == 6
    for k in jp:
        assert pp[k].tobytes() == jp[k].tobytes(), k
    # Both monitors took the same reports.
    assert pmon._reports == jmon._reports and 0 in pmon._reports


def test_capability_advertisement_with_a_monitor_is_a_jax_servers():
    from distributed_parameter_server_for_ml_training_tpu.telemetry \
        import ClusterMonitor as JaxMonitor
    from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
        import ClusterMonitor

    req = JS.pack_msg({"worker_name": "w"})
    jstore = JaxStore(_params(), JaxConfig(total_workers=1))
    pstore = ParameterStore(_params(), StoreConfig(total_workers=1))
    want = JS.ParameterService(jstore, monitor=JaxMonitor(jstore)) \
        .register_worker(req, None)
    got = PS.ParameterService(pstore, monitor=ClusterMonitor(pstore)) \
        .register_worker(req, None)
    assert got == want and PS.unpack_msg(got)[0]["health_report"] is True
