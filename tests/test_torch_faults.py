"""The port's seeded fault injector (``comms/faults.py``) against the JAX
package's: the same schedule for the same spec on every op, the same
refusals of bad specs, the same corrupted bytes; and pushes under
injected faults landing exactly once across the packages, over localhost
gRPC (a port client against the JAX service, a JAX client against the
port's service), bit-equal to a fault-free run of the same pushes.

Every server binds 127.0.0.1 at port 0; clients back off 10 ms."""

import numpy as np
import pytest

from distributed_parameter_server_for_ml_training_tpu.comms import (
    client as JC, faults as JF, service as JS)
from distributed_parameter_server_for_ml_training_tpu.ps.store import (
    ParameterStore as JaxStore, StoreConfig as JaxConfig)
from distributed_parameter_server_for_ml_training_tpu_torch.comms import (
    client as PC, faults as PF, service as PS)
from distributed_parameter_server_for_ml_training_tpu_torch.ps.store import (
    ParameterStore, StoreConfig)

#: The specs of the JAX package's fault tests (``test_recovery.py``,
#: ``test_payload_integrity.py``, ``test_selfheal.py``), and the ones
#: this repo's drills use.
SPECS = [
    "seed=11;push.unavailable@p=0.3;fetch.delay=0.01@every=4",
    "push.drop_reply@n=2,5;fetch.deadline@every=3",
    "push.unavailable@n=1;push.drop_reply@n=3",
    "reshard.kill@n=2;refresh.partition=2@n=5;"
    "subscribe.unavailable@every=3;push.corrupt@every=4",
    "any.unavailable@every=1",
    "refresh.partition=0.3@n=1",
    "push.corrupt@every=2",
    "compute.delay_compute=0.05@every=2",
    "compute.delay_compute=0.01@n=2",
    "any.unavailable@p=1",
    "seed=7;push.drop_reply@n=2,5",
    "seed=7;push.drop_reply@n=2;fetch.unavailable@n=3",
    "seed=3;any.deadline@p=0.2;register.delay=0@p=0.5;finish.kill@n=9",
    "seed=42;fetch.unavailable@p=0.1;push.unavailable@p=0.1;"
    "subscribe.delay=0@p=0.3;refresh.unavailable@p=0.25",
]

BAD_SPECS = ["", "push.frobnicate@p=0.1", "push.unavailable@p=1.5",
             "nosuchop.delay@every=2", "push.unavailable@n=0",
             "push.unavailable", "seed=1", "any.delay_compute=1@p=1",
             "compute.unavailable@p=1", "push.delay@every=0",
             "push.delay@when=3"]

#: Every op name a decision is made under: the four RPCs, the admin
#: plane's two, and the three pseudo-ops. (``any`` matches SubmitJob in
#: both packages: ``ANY_EXCLUDED`` leaves it out, ROADMAP §3.)
OPS = ["RegisterWorker", "PushGradrients", "FetchParameters",
       "JobFinished", "Reshard", "SubmitJob", PF.COMPUTE_OP,
       PF.REFRESH_OP, PF.SUBSCRIBE_OP]


def test_vocabulary_equals_jax():
    assert PF.FAULT_OPS == JF.FAULT_OPS
    assert PF.FAULT_KINDS == JF.FAULT_KINDS
    assert PF.ANY_EXCLUDED == JF.ANY_EXCLUDED
    assert (PF.COMPUTE_OP, PF.REFRESH_OP, PF.SUBSCRIBE_OP) == (
        JF.COMPUTE_OP, JF.REFRESH_OP, JF.SUBSCRIBE_OP)


@pytest.mark.parametrize("spec", SPECS)
def test_schedule_equals_jax(spec):
    """For each op, a fresh injector's 50-call schedule is the JAX
    package's, as are the parsed rules and every ``any`` match."""
    assert PF.parse_fault_spec(spec)[0] == JF.parse_fault_spec(spec)[0]
    port_rules = PF.parse_fault_spec(spec)[1]
    jax_rules = JF.parse_fault_spec(spec)[1]
    assert [vars(r) for r in port_rules] == [vars(r) for r in jax_rules]
    for op in OPS:
        assert [r.matches_rpc(op) for r in port_rules] == \
            [r.matches_rpc(op) for r in jax_rules]
        got = PF.FaultInjector(spec).schedule_preview(op, 50)
        assert got == JF.FaultInjector(spec).schedule_preview(op, 50), op
    # Interleaved decisions (one injector, ops alternating) with their
    # corrupt salts.
    p, j = (PF.FaultInjector(spec, _telemetry=False),
            JF.FaultInjector(spec, _telemetry=False))
    def seen(inj, rule):
        return None if rule is None else (rule.kind, rule.value,
                                          inj.corrupt_salt(rule))

    for i in range(60):
        op = OPS[i % len(OPS)]
        assert seen(p, p.decide(op)) == seen(j, j.decide(op))


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_are_refused_as_jax(spec):
    with pytest.raises(ValueError) as jerr:
        JF.FaultInjector(spec)
    with pytest.raises(ValueError) as perr:
        PF.FaultInjector(spec)
    assert str(perr.value) == str(jerr.value)


def test_corrupt_request_equals_jax():
    rng = np.random.default_rng(3)
    payload = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    for data in (b"", b"abc", b"\x00" * 5, JS.pack_msg({"a": 1}),
                 JS.pack_msg({"worker_id": 3}, payload),
                 b"\xff\xff\xff\xff" + payload[:40]):
        for salt in (0, 1, 2, 7, 1 << 20):
            got = PF.corrupt_request(data, salt)
            assert got == JF.corrupt_request(data, salt)
            if len(data) > 4:
                assert sum(a != b for a, b in zip(got, data)) == 1


def test_compute_delay_and_partition_window():
    """The worker-loop hook and the partition window behave as JAX's do
    (``test_selfheal.py``, ``test_payload_integrity.py``)."""
    inj = PF.FaultInjector("compute.delay_compute=0.001@n=2",
                           _telemetry=False)
    assert [inj.maybe_delay_compute() for _ in range(3)] == [0.0, 0.001,
                                                             0.0]
    fi = PF.FaultInjector("refresh.partition=60@n=1", _telemetry=False)
    assert [fi.decide(PF.REFRESH_OP).kind for _ in range(4)] == \
        ["partition"] * 4
    assert fi.decide(PF.SUBSCRIBE_OP) is None


# -- exactly-once under faults, across the packages ------------------------

SHAPES = {"conv/kernel": (3, 3, 3, 8), "dense/kernel": (8, 10),
          "dense/bias": (10,)}
PUSHES = 5


def _params():
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(i: int) -> dict:
    rng = np.random.default_rng(50 + i)
    return {k: (rng.standard_normal(s) * 1e-2).astype(np.float32)
            for k, s in SHAPES.items()}


def _serve(pkg: str, faults=None):
    """A service of ``pkg`` on 127.0.0.1:0 whose push replies are
    recorded; returns (store, server, address, replies)."""
    if pkg == "jax":
        store = JaxStore(_params(), JaxConfig(mode="async", total_workers=1,
                                              push_codec="none",
                                              staleness_bound=100))
        svc = JS.ParameterService(store, faults=faults)
    else:
        store = ParameterStore(_params(), StoreConfig(
            mode="async", total_workers=1, push_codec="none",
            staleness_bound=100))
        svc = PS.ParameterService(store, faults=faults)
    replies = []
    body = svc.push_gradrients

    def push(request, ctx):
        reply = body(request, ctx)
        replies.append(JS.unpack_msg(reply)[0])
        return reply

    svc.push_gradrients = push
    if pkg == "jax":
        import grpc
        from concurrent import futures
        server = grpc.server(futures.ThreadPoolExecutor(max_workers=8),
                             options=JS.GRPC_OPTIONS)
        server.add_generic_rpc_handlers((svc.handlers(),))
        port = server.add_insecure_port("127.0.0.1:0")
        server.start()
    else:
        server, port = PS.serve(store, port=0, service=svc,
                                host="127.0.0.1")
    return store, server, f"127.0.0.1:{port}", replies


def _run(client_pkg: str, server_pkg: str, client_faults=None,
         server_faults=None):
    store, server, address, replies = _serve(server_pkg, server_faults)
    mod = JC if client_pkg == "jax" else PC
    client = mod.RemoteStore(address, rpc_timeout=10.0, rpc_backoff=0.01,
                             faults=client_faults)
    try:
        wid, _ = client.register_worker("chaos")
        accepted = []
        for i in range(PUSHES):
            _, step = client.fetch(wid)
            accepted.append(client.push(wid, _grads(i), step))
        client.job_finished(wid)
    finally:
        client.close()
        server.stop(grace=None)
    params, step = store.snapshot()
    return {"params": params, "step": step, "accepted": accepted,
            "applied": store.stats.gradients_processed,
            "duplicates": sum(bool(r.get("duplicate")) for r in replies)}


@pytest.mark.parametrize("client_pkg,server_pkg,client_faults,"
                         "server_faults,dups", [
    ("port", "jax", "push.drop_reply@n=2;push.unavailable@n=3", None, 1),
    ("jax", "port", "push.drop_reply@n=2;push.unavailable@n=3",
     "fetch.unavailable@n=2", 1),
    ("port", "port", "seed=7;push.drop_reply@n=2,5",
     "seed=7;push.drop_reply@n=4", 3),
], ids=["port-client-jax-service", "jax-client-port-service",
        "port-both-sides"])
def test_pushes_land_exactly_once_across_packages(client_pkg, server_pkg,
                                                  client_faults,
                                                  server_faults, dups):
    """Under injected lost replies and unavailable calls each push
    applies once: the final params are bit-equal to a fault-free run of
    the same pushes, every push reads accepted, and the service answered
    the retries of applied pushes as duplicates."""
    clean = _run(client_pkg, server_pkg)
    faulty = _run(client_pkg, server_pkg, client_faults, server_faults)
    assert clean["duplicates"] == 0
    assert faulty["duplicates"] == dups
    assert faulty["accepted"] == clean["accepted"] == [True] * PUSHES
    assert faulty["step"] == clean["step"] == PUSHES
    assert faulty["applied"] == clean["applied"] == PUSHES
    for k, v in clean["params"].items():
        np.testing.assert_array_equal(faulty["params"][k], v)
