"""The port's multi-job tenancy (``…_torch/ps/tenancy.py`` and the job
routing of ``comms/service.py``) against the JAX package's, on the same
NumPy inputs.

The namespace primitives and the ``--jobs`` grammar (good specs equal,
bad specs raising the same ``ValueError``), ``JobManager`` (views, QoS
table, global worker ids, a submitted job's inherited params and
overrides, a drain removing the job's series and never reusing its
index), one scripted request sequence into both packages'
``ParameterService(jobs=...)`` handlers (``ctx=None``: every reply byte
for byte, each job's params bit for bit after every step, the per-job
journals, the not-modified cache keyed by job), the weighted-fair
admission's scenarios, and ``SubmitJob`` under fault injection.
"""

import time

import numpy as np
import pytest

from distributed_parameter_server_for_ml_training_tpu.comms import \
    service as JS
from distributed_parameter_server_for_ml_training_tpu.comms.wire import \
    encode_tensor_dict as jax_encode
from distributed_parameter_server_for_ml_training_tpu.ops.compression \
    import compress_push as jax_compress_push, fp16_compress
from distributed_parameter_server_for_ml_training_tpu.ps import \
    tenancy as JT
from distributed_parameter_server_for_ml_training_tpu.ps.store import (
    ParameterStore as JaxStore, StoreConfig as JaxConfig)
from distributed_parameter_server_for_ml_training_tpu.telemetry import \
    get_registry as jax_registry
from distributed_parameter_server_for_ml_training_tpu.telemetry.registry \
    import MetricsRegistry as JaxRegistry
from distributed_parameter_server_for_ml_training_tpu_torch.comms import \
    service as PS
from distributed_parameter_server_for_ml_training_tpu_torch.ps import \
    tenancy as PT
from distributed_parameter_server_for_ml_training_tpu_torch.ps.store import (
    ParameterStore, StoreConfig)
from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
    import get_registry as port_registry
from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
    .registry import MetricsRegistry

SHAPES = {"conv/kernel": (3, 3, 3, 8), "conv/bias": (8,),
          "dense/kernel": (8, 10), "dense/bias": (10,)}

#: The scripted server's jobs: a sync job with a quorum of 2 and an
#: async job with its own staleness bound, beside ``default``.
JOBS = "joba:mode=sync,sync_quorum=2;jobb:mode=async,staleness_bound=4"

#: Each package: (service module, tenancy module, store, config, registry).
PKGS = {"jax": (JS, JT, JaxStore, JaxConfig, JaxRegistry),
        "port": (PS, PT, ParameterStore, StoreConfig, MetricsRegistry)}


def _params():
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _primary(pkg: str, **kw):
    _, _, store, config, _ = PKGS[pkg]
    cfg = dict(mode="async", total_workers=2, push_codec="int8")
    cfg.update(kw)
    return store(_params(), config(**cfg))


def _grads(seed: int, codec: str) -> dict:
    rng = np.random.default_rng(100 + seed)
    g = {k: (rng.standard_normal(s) * 1e-2).astype(np.float32)
         for k, s in SHAPES.items()}
    if codec == "fp16":
        return fp16_compress(g)
    return jax_compress_push(g, {k: "int8" for k in g})


# -- primitives ---------------------------------------------------------------

def test_spec_field_table_and_constants_equal_jax():
    assert PT.JOB_SPEC_FIELDS == JT.JOB_SPEC_FIELDS
    assert list(PT.JOB_SPEC_FIELDS) == list(JT.JOB_SPEC_FIELDS)
    assert (PT.DEFAULT_JOB, PT.WID_STRIDE) == (JT.DEFAULT_JOB, JT.WID_STRIDE)
    assert PS.ADMISSION_CAPACITY == JS.ADMISSION_CAPACITY == 16
    assert PS.ADMISSION_WAIT_CAP_S == JS.ADMISSION_WAIT_CAP_S == 2.0


@pytest.mark.parametrize("job,name", [
    ("joba", "conv/kernel:0"), ("default", "w"), ("j-1_x", "a/b/c::d"),
    ("vision", "Block_0/Conv_1/kernel")])
def test_job_keys_and_slots_equal_jax(job, name):
    key = PT.job_key(job, name)
    assert key == JT.job_key(job, name)
    assert PT.split_job_key(key) == JT.split_job_key(key)
    assert PT.split_job_key(name) == JT.split_job_key(name)
    names = [name, "dense/bias", "conv/kernel", f"x{job}"]
    assert PT.job_slots(job, names) == JT.job_slots(job, names)


@pytest.mark.parametrize("value", [
    "joba", "default", "", None, 7, "::", "a" * 64, "a" * 65, "-x", "x y",
    "job_1-b"])
def test_job_id_normalisation_equals_jax(value):
    assert PT.is_valid_job_id(value) == JT.is_valid_job_id(value)
    assert PT.normalize_job_id(value) == JT.normalize_job_id(value)


def test_split_wid_equals_jax():
    for gw in (0, 5, 4095, 4096, 4097, 3 * 4096 + 31, "8193"):
        assert PT.split_wid(gw) == JT.split_wid(gw)


@pytest.mark.parametrize("spec", [
    JOBS, "vision:weight=3,max_inflight=2,min_workers=0,max_workers=5;"
    "ranker", " a ; b:learning_rate=0.5,total_workers=3 ;", ""])
def test_good_specs_parse_as_jax(spec):
    got = [vars(s) for s in PT.parse_jobs_spec(spec)]
    assert got == [vars(s) for s in JT.parse_jobs_spec(spec)]


@pytest.mark.parametrize("spec", [
    "default", "a;a", "a:colour=red", "a:weight", "a:weight=x",
    "a:weight=0", "a:max_inflight=0", "a:mode=ring", "::bad",
    "a:min_workers=3,max_workers=2"])
def test_bad_specs_raise_as_jax(spec):
    with pytest.raises(ValueError) as want:
        JT.parse_jobs_spec(spec)
    with pytest.raises(ValueError) as got:
        PT.parse_jobs_spec(spec)
    assert str(got.value) == str(want.value)


# -- JobManager --------------------------------------------------------------

def _managers(spec: str = JOBS) -> dict:
    out = {}
    for pkg, (_, tenancy, _, _, registry) in PKGS.items():
        reg = registry()
        out[pkg] = (tenancy.JobManager(_primary(pkg),
                                       tenancy.parse_jobs_spec(spec),
                                       registry=reg), reg)
    return out


def test_job_manager_views_equal_jax(capsys):
    m = _managers(JOBS + ";vision:weight=3,max_inflight=2")
    (jm, _), (pm, _) = m["jax"], m["port"]
    for mgr in (jm, pm):
        mgr.store_for("joba").register_worker("a")
        mgr.store_for("vision").register_worker("v")
    assert pm.names() == jm.names() == ["default", "joba", "jobb", "vision"]
    assert pm.view() == jm.view()
    assert pm.qos_table() == jm.qos_table()
    assert pm.membership_snapshot() == jm.membership_snapshot() \
        == [4096, 3 * 4096]
    for job, lw in (("joba", 2), ("jobb", 0), ("default", 3), ("nope", 1)):
        g = pm.to_global(job, lw)
        assert g == jm.to_global(job, lw)
        assert pm.job_name_of(g) == jm.job_name_of(g)
    for wid in (-1, 5 * 4096, "x", None):
        assert pm.job_name_of(wid) == jm.job_name_of(wid)
    # A submitted job inherits the primary's params bit for bit, with the
    # spec's overrides and the resolved push codec.
    for job in ("joba", "jobb"):
        js, ps = jm.store_for(job), pm.store_for(job)
        (jp, _), (pp, _) = js.snapshot(), ps.snapshot()
        assert list(pp) == list(jp)
        assert all(pp[k].tobytes() == jp[k].tobytes() for k in jp)
        assert vars(ps.config) == vars(js.config)
        assert ps.push_codec == js.push_codec == "int8"
    assert pm.store_for("joba").config.sync_quorum == 2
    assert pm.store_for("jobb").config.staleness_bound == 4
    assert pm.store_for("unknown") is pm.store_for("default")
    assert capsys.readouterr().out.count("JOB_SUBMITTED") == 6


def test_drain_removes_series_and_never_reuses_an_index():
    got = {}
    for pkg, (mgr, reg) in _managers().items():
        svc_mod = PKGS[pkg][0]
        qos = svc_mod.WeightedFairAdmission(mgr, registry=reg)
        mgr.qos = qos
        assert qos.admit("jobb", 0.0)
        qos.release("jobb")
        mgr.view()                              # sets dps_job_workers
        series = {m.name for m in reg.collect()
                  if m.labels.get("job") == "jobb"}
        with pytest.raises(ValueError):
            mgr.drain("default")
        assert mgr.drain("jobb") and not mgr.drain("jobb")
        left = {m.name for m in reg.collect()
                if m.labels.get("job") == "jobb"}
        newcomer = mgr.submit(PKGS[pkg][1].JobSpec("jobc"))
        got[pkg] = (sorted(series), sorted(left), newcomer.index,
                    mgr.names(), qos.view(), mgr.job_name_of(2 * 4096))
    assert got["port"] == got["jax"]
    series, left, index, names, _, owner = got["port"]
    assert {"dps_job_queue_depth", "dps_job_admitted_total",
            "dps_job_throttled_total", "dps_job_workers"} <= set(series)
    assert left == [] and index == 3 and owner == "default"
    assert names == ["default", "joba", "jobc"]


# -- the service, scripted ----------------------------------------------------

def script() -> list:
    """The request sequence: (rpc, request bytes), built with the JAX
    package's envelope and frame functions."""
    pack = JS.pack_msg

    def push(wid, job, seed, token, step=0, codec="int8"):
        meta = {"worker_id": wid, "fetched_step": step,
                "push_token": token}
        if job is not None:
            meta["job"] = job
        return ("push_gradrients",
                pack(meta, jax_encode(_grads(seed, codec), checksum=True)))

    def fetch(**meta):
        return ("fetch_parameters", pack(meta))

    def register(name, job=None, caps=("directives",)):
        meta = {"worker_name": name, "capabilities": list(caps)}
        if job is not None:
            meta["job"] = job
        return ("register_worker", pack(meta))

    return [
        register("legacy"),                          # default, wid 0
        register("a0", "joba"),                      # 4096
        register("a1", "joba", caps=()),             # 4097
        register("b0", "jobb"),                      # 8192
        register("x", "::garbled"),                  # default, wid 1
        fetch(worker_id=4096, job="joba", have_qscales=0),
        push(4096, "joba", 1, "cafe:1"),
        push(4097, "joba", 2, "beef:1"),             # quorum: round 1
        push(8192, "jobb", 3, "cafe:1"),             # same token, applies
        push(8192, "jobb", 3, "cafe:1"),             # duplicate
        push(4096, "joba", 1, "cafe:1"),             # duplicate in joba
        fetch(worker_id=4096, job="joba", have_qscales=0),
        fetch(worker_id=8192, job="jobb"),
        fetch(),                                     # legacy: default
        # Not-modified polls of two jobs idling at step 1, in turns: each
        # job's cached header is its own.
        fetch(worker_id=4097, job="joba", have_step=1),
        fetch(worker_id=8192, job="jobb", have_step=1),
        fetch(worker_id=4097, job="joba", have_step=1),
        fetch(worker_id=4097, job="joba", have_step=1),
        fetch(worker_id=8192, job="jobb", have_step=1),
        fetch(worker_id=8192, have_step=1),          # job from the stride
        push(8192, "jobb", 4, "cafe:2", step=1, codec="fp16"),
        push(0, "::", 5, "cafe:1"),                  # garbled: default
        ("submit_job", pack({"job_spec": "jobc:mode=async"})),
        register("c0", "jobc"),                      # 3 * 4096
        push(3 * 4096, "jobc", 6, "cafe:1"),         # same token again
        fetch(worker_id=3 * 4096, job="jobc", have_step=0),
        ("submit_job", pack({"drain_job": "jobc"})),
        fetch(worker_id=3 * 4096, job="jobc"),       # drained: default
        ("job_finished", pack({"worker_id": 4096, "job": "joba"})),
        ("job_finished", pack({"worker_id": 8192})),
    ]


def _hits(pkg: str) -> float:
    reg = jax_registry() if pkg == "jax" else port_registry()
    return reg.counter("dps_fetch_nm_cache_hits_total").value


def test_scripted_tenancy_replies_equal_byte_for_byte(capsys):
    """One request script into both packages' tenancy services: every
    reply byte for byte, each job's params bit for bit after every step,
    the per-job journals equal; the not-modified cache keyed by job (its
    hit count equal to JAX's, which would not hold with a cache keyed by
    the step alone)."""
    requests = script()
    runs = {}
    for pkg, (svc_mod, tenancy, _, _, registry) in PKGS.items():
        primary = _primary(pkg)
        mgr = tenancy.JobManager(primary, tenancy.parse_jobs_spec(JOBS),
                                 registry=registry())
        svc = svc_mod.ParameterService(primary, jobs=mgr)
        hits0 = _hits(pkg)
        replies, params, journals = [], [], []
        for rpc, req in requests:
            replies.append(bytes(getattr(svc, rpc)(req, None)))
            params.append({name: mgr.store_for(name).snapshot()
                           for name in mgr.names()})
        for name in ("default", "joba", "jobb", "jobc"):
            journals.append(svc.journal_snapshot(job=name))
        runs[pkg] = (replies, params, journals, _hits(pkg) - hits0,
                     svc.journal_snapshot(), mgr)
    (jr, jp, jj, jh, jall, jm), (pr, pp, pj, ph, pall, pm) = \
        runs["jax"], runs["port"]
    for i, (w, g) in enumerate(zip(jr, pr)):
        assert g == w, (i, requests[i][0], PS.unpack_msg(g)[0],
                        JS.unpack_msg(w)[0])
    for i, (want, got) in enumerate(zip(jp, pp)):
        assert list(got) == list(want), i
        for job, ((wp, ws), (gp, gs)) in ((j, (want[j], got[j]))
                                          for j in want):
            assert gs == ws and list(gp) == list(wp), (i, job)
            for k in wp:
                assert gp[k].tobytes() == wp[k].tobytes(), (i, job, k)
    assert pj == jj and pall == jall
    assert ph == jh == 2
    metas = [PS.unpack_msg(r)[0] for r in pr]
    assert [m["worker_id"] for m in metas[:5]] == [0, 4096, 4097, 8192, 1]
    assert metas[0]["job"] == metas[4]["job"] == "default"
    assert metas[1]["mode"] == "sync" and metas[3]["staleness_bound"] == 4
    # The same token applies in both jobs; a retry in either dedupes.
    assert metas[7]["accepted"] and metas[8]["accepted"] \
        and "duplicate" not in metas[8]
    assert metas[9]["duplicate"] and metas[10]["duplicate"]
    assert all(metas[i]["not_modified"] for i in range(14, 20))
    assert metas[22]["submitted"] == "jobc" and metas[22]["index"] == 3
    assert metas[23]["worker_id"] == 3 * 4096
    assert metas[24]["accepted"] and metas[26]["drained"]
    # Each job's journal holds its own tokens and no other job's.
    nonces = [{e["nonce"] for e in j} for j in pj]
    assert nonces[0] == {"cafe"}
    assert nonces[1] == {"joba::cafe", "joba::beef"}
    assert nonces[2] == {"jobb::cafe"} and nonces[3] == {"jobc::cafe"}
    assert pm.names() == jm.names() == ["default", "joba", "jobb"]
    assert pm.store_for("joba").wait_all_finished(0) is False
    out = capsys.readouterr().out
    assert "JOB_SUBMITTED job=jobc index=3" in out and "JOB_DRAINED" in out


def test_single_job_server_keeps_its_wire():
    """Without ``jobs`` a ``job`` key is never read: the register reply
    has no ``jobs``, a labelled push lands in the one store, and the
    journal's nonces stay bare."""
    req = JS.pack_msg({"worker_name": "w", "job": "joba"})
    for pkg in PKGS:
        svc = PKGS[pkg][0].ParameterService(_primary(pkg))
        meta = PS.unpack_msg(svc.register_worker(req, None))[0]
        assert "jobs" not in meta and "job" not in meta
        svc.push_gradrients(JS.pack_msg(
            {"worker_id": 0, "fetched_step": 0, "push_token": "n:1",
             "job": "joba"}, jax_encode(_grads(1, "int8"))), None)
        assert svc.store.global_step == 1
        assert [e["nonce"] for e in svc.journal_snapshot()] == ["n"]
        assert svc.journal_snapshot(job="joba") == []


# -- weighted-fair admission --------------------------------------------------

def _admission_scenario(pkg: str, scenario: str):
    """One of JAX's ``TestWeightedFairAdmission`` scenarios on ``pkg``'s
    classes, with a short admission budget; returns what it observed."""
    svc_mod, tenancy, _, _, registry = PKGS[pkg]
    reg = registry()
    specs = {"fair_share": "joba:weight=1;jobb:weight=3",
             "max_inflight": "joba:max_inflight=2,weight=100",
             "recovery": "joba:weight=1;jobb:weight=1",
             "push_throttled": "joba:max_inflight=1"}[scenario]
    primary = _primary(pkg, push_codec="none")
    jobs = tenancy.JobManager(primary, tenancy.parse_jobs_spec(specs),
                              registry=reg)
    seen = []
    if scenario == "push_throttled":
        svc = svc_mod.ParameterService(primary, jobs=jobs)
        qos = svc.qos = svc_mod.WeightedFairAdmission(jobs, registry=reg)
        jobs.qos = qos
        wid = PS.unpack_msg(svc.register_worker(
            JS.pack_msg({"job": "joba"}), None))[0]["worker_id"]
        seen.append(qos.admit("joba", 0.0))

        class Ctx:
            aborted = None

            def time_remaining(self):
                return 1.05

            def abort(self, code, detail):
                self.aborted = (code, detail)
                raise RuntimeError(detail)

        ctx = Ctx()
        push = JS.pack_msg({"worker_id": wid, "fetched_step": 0,
                            "push_token": "t:1", "job": "joba"},
                           jax_encode({k: np.full(s, 0.5, np.float32)
                                       for k, s in SHAPES.items()}))
        with pytest.raises(RuntimeError):
            svc.push_gradrients(push, ctx)
        seen.append(ctx.aborted)
        qos.release("joba")
        seen.append(PS.unpack_msg(svc.push_gradrients(push, None))[0])
    else:
        qos = svc_mod.WeightedFairAdmission(
            jobs, capacity={"fair_share": 15, "max_inflight": 16,
                            "recovery": 2}[scenario], registry=reg)
        if scenario == "fair_share":
            seen += [qos._limits(j) for j in ("joba", "jobb", "default")]
        elif scenario == "max_inflight":
            seen += [qos.admit("joba", 0.0) for _ in range(3)]
            qos.release("joba")
            seen.append(qos.admit("joba", 0.0))
            qos.release("joba")
            qos.release("joba")
        else:
            seen += [qos.admit("joba", 0.0), qos.admit("jobb", 0.0),
                     qos.admit("joba", 0.02)]
            qos.release("jobb")
            seen.append(qos.admit("joba", 0.0))
            seen.append(qos.view())
            qos.release("joba")
            qos.release("joba")
    counts = {(m.name, m.labels["job"]): m.value for m in reg.collect()
              if m.name in ("dps_job_admitted_total",
                            "dps_job_throttled_total")}
    return seen, counts, qos.view()


@pytest.mark.parametrize("scenario", ["fair_share", "max_inflight",
                                      "recovery", "push_throttled"])
def test_admission_scenarios_count_as_jax(scenario):
    got = _admission_scenario("port", scenario)
    want = _admission_scenario("jax", scenario)
    assert got == want
    seen, counts, _ = got
    if scenario == "fair_share":
        assert seen == [(3, 8), (9, 8), (3, 8)]
    elif scenario == "max_inflight":
        assert seen == [True, True, False, True]
        assert counts[("dps_job_throttled_total", "joba")] == 1
    elif scenario == "recovery":
        assert seen[:4] == [True, True, False, True]
        assert counts[("dps_job_admitted_total", "joba")] == 2
    else:
        assert seen[0] is True and seen[1][0].name == "RESOURCE_EXHAUSTED"
        assert seen[2]["accepted"]
        assert counts == {("dps_job_admitted_total", "joba"): 2,
                          ("dps_job_throttled_total", "joba"): 1}


def test_a_waiter_is_admitted_when_a_slot_frees():
    """JAX's recovery scenario's second half: a waiting admission takes
    the slot the moment another job releases one, in both packages."""
    import threading
    for pkg in PKGS:
        svc_mod, tenancy, _, _, registry = PKGS[pkg]
        jobs = tenancy.JobManager(
            _primary(pkg), tenancy.parse_jobs_spec(
                "joba:weight=1;jobb:weight=1"), registry=registry())
        qos = svc_mod.WeightedFairAdmission(jobs, capacity=2,
                                            registry=registry())
        assert qos.admit("joba", 0.0) and qos.admit("jobb", 0.0)
        entered, got = threading.Event(), []

        def wait():
            entered.set()
            got.append(qos.admit("joba", 5.0))

        t = threading.Thread(target=wait, daemon=True)
        t.start()
        entered.wait(5)
        deadline = time.monotonic() + 5
        while qos.view()["joba"]["waiting"] == 0:
            assert time.monotonic() < deadline, pkg
        qos.release("jobb")
        t.join(timeout=5)
        assert got == [True], pkg


# -- SubmitJob under fault injection ------------------------------------------

def test_submit_job_is_fault_wrapped_as_jax():
    """The port's service wraps ``SubmitJob`` in its fault injector as
    JAX's wraps every handler: an ``any`` rule's first hit aborts the
    first SubmitJob over the wire in both packages (the port left it
    unwrapped while it refused the RPC)."""
    import grpc
    from concurrent import futures

    from distributed_parameter_server_for_ml_training_tpu.comms import \
        client as JC
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        import client as PC
    spec = "seed=3;any.unavailable@n=1"
    got = {}
    for pkg, client in (("jax", JC), ("port", PC)):
        svc_mod, tenancy, _, _, registry = PKGS[pkg]
        primary = _primary(pkg)
        svc = svc_mod.ParameterService(
            primary, faults=spec,
            jobs=tenancy.JobManager(primary, registry=registry()))
        server = grpc.server(futures.ThreadPoolExecutor(max_workers=4),
                             options=JS.GRPC_OPTIONS)
        server.add_generic_rpc_handlers((svc.handlers(),))
        port = server.add_insecure_port("127.0.0.1:0")
        server.start()
        remote = client.RemoteStore(f"127.0.0.1:{port}", rpc_timeout=10.0,
                                    rpc_retries=0)
        try:
            outcomes = []
            for _ in range(2):
                try:
                    outcomes.append(remote.submit_job("jobz"))
                except ConnectionError as e:
                    outcomes.append(e.__cause__.code())
            outcomes.append(remote.drain_job("jobz"))
        finally:
            remote.close()
            server.stop(grace=None)
        got[pkg] = outcomes
    assert got["port"] == got["jax"]
    assert got["port"][0] == grpc.StatusCode.UNAVAILABLE
    assert got["port"][1]["submitted"] == "jobz"
    assert got["port"][2] == {"drained": True, "jobs": ["default"]}
