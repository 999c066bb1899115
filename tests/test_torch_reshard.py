"""Live resharding in the port (``…_torch/comms/service.py``'s ``Reshard``
RPC with its migration ledger and lease, ``RemoteStore.reshard_op`` and
``cli reshard``) against the JAX package's.

- The six migration-ledger scenarios of the JAX tests run as one op
  script on a JAX pair and a port pair of shard-primary services (direct
  handler calls, ``ctx=None``) under one patched wall clock: reply metas
  equal field by field, export payloads byte-equal, and stores, drain
  sets, ledger records and counters equal after every op.
- The migration record through the port's checkpoint manager
  (``migration_fn=``) and ``restore_server_state``/``load_migration``:
  each package restores the other's record; a donor comes back frozen,
  a lapsed lease comes back unfrozen and counted.
- The coordinators over localhost gRPC: the port's against port
  primaries, JAX's against port primaries and the port's against JAX
  primaries give the same ``RESHARD_JSON`` line and the same stores; each
  crash point then ``--resume``, ``--abort`` (rc 0, rc 4) and the lease
  roll-back give JAX's outcome lines; the plan errors give JAX's texts.
- A CPU ``ShardedRemoteStore`` pushing across a move, a replayed token at
  the new owner, a push into a frozen range, ``reshard.unavailable@n=2``
  and a native-backed primary's export, each as in the JAX package.
"""

import contextlib
import io
import json
import time

import numpy as np
import pytest

from distributed_parameter_server_for_ml_training_tpu import cli as JCLI
from distributed_parameter_server_for_ml_training_tpu.checkpoint import (
    restore_server_state as jax_restore, save_store as jax_save)
from distributed_parameter_server_for_ml_training_tpu.comms import (
    service as JS)
from distributed_parameter_server_for_ml_training_tpu.comms.client import (
    RemoteStore as JaxRemote)
from distributed_parameter_server_for_ml_training_tpu.comms.faults import (
    FaultInjector as JaxInjector, InjectedRpcError as JaxInjected)
from distributed_parameter_server_for_ml_training_tpu.comms.sharded import (
    ShardedRemoteStore as JaxSharded)
from distributed_parameter_server_for_ml_training_tpu.ps.sharding import (
    ShardInfo as JaxShardInfo)
from distributed_parameter_server_for_ml_training_tpu.ps.store import (
    ParameterStore as JaxStore, StoreConfig as JaxConfig)
from distributed_parameter_server_for_ml_training_tpu.telemetry import (
    get_registry as jax_registry)
from distributed_parameter_server_for_ml_training_tpu_torch import cli
from distributed_parameter_server_for_ml_training_tpu_torch.checkpoint \
    import PeriodicStoreCheckpointer, restore_server_state
from distributed_parameter_server_for_ml_training_tpu_torch.comms import (
    service as PS)
from distributed_parameter_server_for_ml_training_tpu_torch.comms.client \
    import RemoteStore
from distributed_parameter_server_for_ml_training_tpu_torch.comms.faults \
    import FaultInjector, InjectedRpcError
from distributed_parameter_server_for_ml_training_tpu_torch.comms.sharded \
    import ShardedRemoteStore
from distributed_parameter_server_for_ml_training_tpu_torch.ps.sharding \
    import ShardInfo, key_slot, partition_keys
from distributed_parameter_server_for_ml_training_tpu_torch.ps.store import (
    ParameterStore, StoreConfig)
from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
    import get_registry

PKGS = {
    "jax": dict(store=JaxStore, config=JaxConfig, service=JS,
                shard=JaxShardInfo, registry=jax_registry, cli=JCLI,
                remote=JaxRemote),
    "port": dict(store=ParameterStore, config=StoreConfig, service=PS,
                 shard=ShardInfo, registry=get_registry, cli=cli,
                 remote=RemoteStore),
}
RPC_TIMEOUT = 20.0


class FakeTime:
    """The ``time`` module of both service modules: ``time()`` reads a
    scripted wall clock, everything else is the real module's."""

    def __init__(self, t: float = 1_000_000.0):
        self.t = t

    def time(self) -> float:
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture()
def clock(monkeypatch):
    fake = FakeTime()
    monkeypatch.setattr(JS, "time", fake)
    monkeypatch.setattr(PS, "time", fake)
    return fake


def _keys(n: int = 12) -> list[str]:
    """Parameter names: at least three in each half's moving quarter
    (slots 16-31 and 32-47) and in its staying quarter."""
    out, i = [], 0
    need = {q: 3 for q in range(4)}
    while any(need.values()) or len(out) < n:
        k = f"layer{i}/kernel"
        q = key_slot(k) // 16
        if need[q] or len(out) < n:
            need[q] = max(0, need[q] - 1)
            out.append(k)
        i += 1
    return out


def _params(keys) -> dict:
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(4 + i % 3).astype(np.float32)
            for i, k in enumerate(keys)}


def _grads(keys, seed: int, like: dict) -> dict:
    rng = np.random.default_rng(100 + seed)
    return {k: (rng.standard_normal(like[k].shape) * 1e-2)
            .astype(np.float32) for k in keys}


def _pair(pkg: str, init: dict, backend: str = "python"):
    """Two shard primaries of ``pkg`` over ``partition_keys`` halves of
    ``init`` (no server)."""
    P = PKGS[pkg]
    parts = partition_keys(init, 2)
    stores, svcs = [], []
    for i in range(2):
        cfg = P["config"](mode="async", total_workers=1, push_codec="none",
                          staleness_bound=100, shard_index=i,
                          shard_count=2)
        params = {k: init[k] for k in parts[i]}
        if backend == "native":
            if pkg == "jax":
                from distributed_parameter_server_for_ml_training_tpu \
                    .native import NativeParameterStore as Native
            else:
                from distributed_parameter_server_for_ml_training_tpu_torch \
                    .native import NativeParameterStore as Native
            store = Native(params, cfg)
        else:
            store = P["store"](params, cfg)
        stores.append(store)
        svcs.append(P["service"].ParameterService(
            store, sharding=P["shard"](i, 2, ["pending"] * 2)))
    return stores, svcs


def _counters(pkg: str) -> dict:
    reg = PKGS[pkg]["registry"]()
    out = {op: reg.counter("dps_reshard_events_total", op=op).value
           for op in PS.RESHARD_OPS}
    out["lease_expired"] = reg.counter(
        "dps_reshard_lease_expired_total").value
    return out


def _state(stores, svcs, base: dict, pkg: str) -> dict:
    now = _counters(pkg)
    return {
        "stores": [[(k, v.tobytes()) for k, v in s.snapshot()[0].items()]
                   + [s.global_step] for s in stores],
        "draining": [sorted(s._draining) for s in svcs],
        "ledger": [s.migration_snapshot() for s in svcs],
        "ranges": [s.sharding.ranges() for s in svcs],
        "counters": {k: now[k] - base[k] for k in now},
    }


def _plan(mig_id="mig-test", lo=16, hi=32, ttl=30.0, version=2):
    return {"id": mig_id, "slot_lo": lo, "slot_hi": hi,
            "ranges": [[0, lo], [lo, 64]], "map_version": version,
            "lease_ttl": ttl}


def _run_script(pkg: str, script: list, clock) -> list:
    """Run one op script on a fresh ``pkg`` pair; returns the trace: each
    op's reply (meta, payload bytes) or error, then the pair's state."""
    init = _params(_keys())
    stores, svcs = _pair(pkg, init)
    pack, unpack = JS.pack_msg, JS.unpack_msg
    base = _counters(pkg)
    trace, exports = [], {}
    for step in script:
        kind = step[0]
        if kind == "clock":
            clock.t += step[1]
            continue
        i = step[1]
        try:
            if kind == "register":
                meta, payload = unpack(svcs[i].register_worker(
                    pack({"worker_name": "w"}), None))
            elif kind == "push":
                own = list(stores[i].snapshot()[0])
                meta, payload = unpack(svcs[i].push_gradrients(pack(
                    {"worker_id": 0, "fetched_step": 0,
                     "push_token": step[2]},
                    JS.encode_tensor_dict(_grads(own, step[3], init))),
                    None))
            else:
                op, fields = step[2], dict(step[3])
                src = fields.pop("payload_of", None)
                body = b""
                if src is not None:
                    body = exports[src][1]
                    fields["journal"] = exports[src][0].get("journal")
                meta, payload = unpack(svcs[i].reshard(
                    pack({"op": op, **fields}, body), None))
                if op == "export":
                    exports[step[4]] = (meta, bytes(payload))
            trace.append(("reply", json.loads(json.dumps(meta)),
                          bytes(payload)))
        except (ValueError, AttributeError) as e:
            trace.append(("error", type(e).__name__, str(e)))
        trace.append(("state", _state(stores, svcs, base, pkg)))
    return trace


EXPORT = ("op", 0, "export", {"slot_lo": 16, "slot_hi": 32,
                              "migration": _plan()}, "e")
IMPORT = ("op", 1, "import", {"payload_of": "e", "migration": _plan()})

#: The JAX ledger tests' scenarios, each an op script (pushes first, so
#: the donor's journal travels with the export).
SCENARIOS = {
    "export_records_donor_and_starts_lease": [
        ("register", 0), ("push", 0, "n:1", 0), EXPORT,
        ("clock", 5.0), ("op", 0, "status", {})],
    "same_id_idempotent_different_id_refused": [
        EXPORT, ("op", 0, "export", {"slot_lo": 16, "slot_hi": 32,
                                     "migration": _plan()}, "e2"),
        ("op", 0, "export", {"slot_lo": 16, "slot_hi": 32,
                             "migration": _plan("mig-other")}, "e3")],
    "abort_rolls_back_both_sides": [
        ("register", 0), ("push", 0, "n:1", 1), EXPORT, IMPORT,
        ("op", 1, "status", {}),
        ("op", 1, "abort", {"migration": _plan()}),
        ("op", 0, "abort", {"migration": _plan()}),
        ("op", 0, "status", {}), ("op", 1, "status", {})],
    "lease_expiry_auto_unfreezes_map_untouched": [
        ("op", 0, "export", {"slot_lo": 16, "slot_hi": 32,
                             "migration": _plan(ttl=0.05)}, "e"),
        ("clock", 0.1), ("op", 0, "status", {}),
        ("register", 0), ("push", 0, "n:1", 2),
        ("op", 0, "export", {"slot_lo": 16, "slot_hi": 32,
                             "migration": _plan("mig-second")}, "e2")],
    "apply_is_commit_point_and_idempotent": [
        ("register", 0), ("register", 1), ("push", 0, "a:1", 3),
        ("push", 1, "b:1", 4), EXPORT, ("push", 0, "a:2", 5), IMPORT,
        ("op", 0, "apply_ranges", {"ranges": _plan()["ranges"],
                                   "map_version": 2,
                                   "migration": _plan()}),
        ("op", 0, "status", {}),
        ("op", 1, "apply_ranges", {"ranges": _plan()["ranges"],
                                   "map_version": 2,
                                   "migration": _plan()}),
        ("op", 1, "status", {}),
        ("op", 0, "apply_ranges", {"ranges": _plan()["ranges"],
                                   "map_version": 2,
                                   "migration": _plan()}),
        ("op", 0, "commit", {"slot_lo": 16, "slot_hi": 32,
                             "migration": _plan()}),
        ("op", 0, "status", {}), ("push", 1, "a:2", 5)],
    "unsharded_and_unknown_op_refused": [
        ("op", 0, "bogus", {}), EXPORT,
        ("op", 1, "import", {"payload_of": "e",
                             "migration": _plan("mig-x")}),
        ("op", 0, "import", {"payload_of": "e", "migration": None})],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_ledger_script_equal_to_jax(name, clock, capsys):
    """Each scenario's replies, payloads, stores, ledgers and counters
    equal the JAX services' after every op, and so does the log."""
    want = _run_script("jax", SCENARIOS[name], clock)
    jax_out = capsys.readouterr().out
    clock.t = 1_000_000.0
    got = _run_script("port", SCENARIOS[name], clock)
    assert capsys.readouterr().out == jax_out
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w
    replies = [t for t in got if t[0] == "reply"]
    assert replies
    if name == "lease_expiry_auto_unfreezes_map_untouched":
        assert "RESHARD_LEASE_EXPIRED" in jax_out
        assert got[-1][1]["counters"]["lease_expired"] == 1
    if name == "same_id_idempotent_different_id_refused":
        assert got[-2][0] == "error" and "in flight" in got[-2][2]


def test_unsharded_server_refuses_reshard():
    init = _params(_keys())
    for P in PKGS.values():
        store = P["store"](init, P["config"](total_workers=1))
        svc = P["service"].ParameterService(store)
        with pytest.raises(ValueError, match="unsharded"):
            svc.reshard(JS.pack_msg({"op": "status"}), None)


# -- the ledger through checkpoints ------------------------------------------

def _checkpoint(pkg: str, store, svc, directory: str) -> None:
    if pkg == "jax":
        jax_save(store, directory, journal_fn=svc.journal_snapshot,
                 migration_fn=svc.migration_snapshot)
    else:
        PeriodicStoreCheckpointer(
            store, directory, journal_fn=svc.journal_snapshot,
            migration_fn=svc.migration_snapshot).flush_now()


@pytest.mark.parametrize("lapsed", [False, True], ids=["live", "lapsed"])
def test_migration_record_survives_checkpoints(tmp_path, clock, capsys,
                                               lapsed):
    """A donor checkpointed mid-export is restored by either package's
    ``restore_server_state`` from either package's snapshot: frozen
    under its original deadline, or, once the lease lapsed while it was
    down, unfrozen with the lapse counted; the views equal JAX's."""
    init = _params(_keys())
    views = {}
    for src in ("jax", "port"):
        stores, svcs = _pair(src, init)
        JS.unpack_msg(svcs[0].reshard(JS.pack_msg(
            {"op": "export", "slot_lo": 16, "slot_hi": 32,
             "migration": _plan(ttl=60.0)}), None))
        _checkpoint(src, stores[0], svcs[0], str(tmp_path / src))
        metas = sorted((tmp_path / src).glob("*.json"))
        rec = json.loads(metas[-1].read_text())["migration"]
        assert rec["id"] == "mig-test" and rec["phase"] == "export"
        assert rec["lease_deadline"] == clock.t + 60.0
    if lapsed:
        clock.t += 61.0
    for src in ("jax", "port"):
        for dst in ("jax", "port"):
            base = _counters(dst)
            stores, svcs = _pair(dst, {k: np.zeros(4, np.float32)
                                       for k in _keys()})
            restore = jax_restore if dst == "jax" else restore_server_state
            step, _ = restore(stores[0], svcs[0], str(tmp_path / src))
            views[src, dst] = (svcs[0].migration_view(),
                               sorted(svcs[0]._draining),
                               _counters(dst)["lease_expired"]
                               - base["lease_expired"], step)
    out = capsys.readouterr().out
    assert len(set(json.dumps(v) for v in views.values())) == 1, views
    view, frozen, expired, _ = views["jax", "port"]
    if lapsed:
        assert view is None and frozen == [] and expired == 1
        assert out.count("RESHARD_LEASE_EXPIRED") == 4
    else:
        assert view["frozen_slots"] == 16 and frozen == list(range(16, 32))
        assert view["lease_remaining_s"] == 60.0 and expired == 0
        assert out.count("RESHARD_RESTORED") == 4
    for P in PKGS.values():
        svc = _pair("port" if P is PKGS["port"] else "jax", init)[1][0]
        assert svc.load_migration({"id": "x"}) is False
        assert svc.load_migration("not-a-dict") is False


def test_cli_serve_checkpoints_the_ledger(tmp_path, monkeypatch):
    """``cli serve --checkpoint-dir`` hands the service's ledger to its
    checkpointer, as JAX's does."""
    from distributed_parameter_server_for_ml_training_tpu_torch import \
        checkpoint

    seen = {}

    class Stop(Exception):
        pass

    def recorder(store, directory, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(checkpoint, "PeriodicStoreCheckpointer", recorder)
    with pytest.raises(Stop):
        cli.main(["serve", "--device", "cpu", "--port", "0",
                  "--no-health-monitor", "--checkpoint-dir",
                  str(tmp_path)])
    fn = seen["migration_fn"]
    assert fn.__name__ == "migration_snapshot"
    assert isinstance(fn.__self__, PS.ParameterService)
    assert fn() is None


# -- the coordinators over gRPC -----------------------------------------------

class Tier:
    """Two shard primaries of ``pkg`` on 127.0.0.1:0 and the addresses."""

    def __init__(self, pkg: str, init: dict, backend: str = "python",
                 faults=None):
        self.pkg = pkg
        self.stores, self.svcs = _pair(pkg, init, backend=backend)
        self.servers, self.addrs = [], []
        for store, svc in zip(self.stores, self.svcs):
            svc.faults = faults
            if pkg == "jax":
                server, port = JS.serve(store, port=0, service=svc)
            else:
                server, port = PS.serve(store, port=0, service=svc,
                                        host="127.0.0.1")
            self.servers.append(server)
            self.addrs.append(f"127.0.0.1:{port}")

    @property
    def primaries(self) -> str:
        return ",".join(self.addrs)

    def stores_state(self) -> list:
        return [[(k, v.tobytes()) for k, v in s.snapshot()[0].items()]
                + [s.global_step, s.config.shard_index] for s in self.stores]

    def close(self) -> None:
        for s in self.servers:
            s.stop(grace=None).wait(10)


@pytest.fixture()
def tiers():
    made = []

    def make(pkg, init, **kw):
        t = Tier(pkg, init, **kw)
        made.append(t)
        return t

    yield make
    for t in made:
        t.close()


class Crash(Exception):
    pass


def _coordinate(pkg: str, argv: list, monkeypatch) -> tuple:
    """``pkg``'s ``cli reshard`` in process, its crash points raising
    :class:`Crash` instead of exiting: (rc or 'crash:<point>', stdout
    lines, stderr text). A ``SystemExit`` of a plan error gives its
    text."""
    mod = PKGS[pkg]["cli"]

    def crash_if(args, point):
        if getattr(args, "crash_after", None) == point:
            print(f"RESHARD_CRASH_POINT {point}", flush=True)
            raise Crash(point)

    monkeypatch.setattr(mod, "_reshard_crash_if", crash_if)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = mod.main(["reshard", *argv])
        except Crash as e:
            rc = f"crash:{e}"
        except SystemExit as e:
            rc = f"exit:{e.code}"
    lines = [ln for ln in out.getvalue().splitlines()
             if ln.startswith(("RESHARD_", "moved", "migration"))]
    return rc, lines, err.getvalue()


def _move(primaries: str, donor=0, recipient=1, slots="16:32", *extra):
    return ["--primaries", primaries, "--donor", str(donor),
            "--recipient", str(recipient), "--slots", slots, *extra]


@pytest.mark.parametrize("pairing", [("port", "port"), ("jax", "port"),
                                     ("port", "jax")],
                         ids=["port-over-port", "jax-over-port",
                              "port-over-jax"])
def test_coordinators_move_a_range_as_jax_does(pairing, tiers,
                                               monkeypatch):
    """A coordinator of either package moves [16, 32) between primaries
    of either package with JAX's result line and JAX's stores; a worker
    token pushed before the move answers duplicate at the new owner."""
    coord, prims = pairing
    init = _params(_keys())
    results = {}
    for c, p in (("jax", "jax"), (coord, prims)):
        tier = tiers(p, init)
        remote = PKGS[p]["remote"](tier.addrs[0], rpc_timeout=RPC_TIMEOUT)
        wid, _ = remote.register_worker("w")
        own = list(tier.stores[0].snapshot()[0])
        assert remote.push(wid, _grads(own, 1, init), 0)
        rc, lines, _ = _coordinate(c, _move(tier.primaries, 0, 1,
                                            "16:32", "--json",
                                            "--migration-id", "mig-1"),
                                   monkeypatch)
        # The push re-sent to the new owner is a duplicate there.
        to_new = PKGS[p]["remote"](tier.addrs[1], rpc_timeout=RPC_TIMEOUT)
        to_new._last_push = remote._last_push
        step = tier.stores[1].global_step
        assert to_new.repush_last(wid) is True
        assert tier.stores[1].global_step == step
        results[c, p] = (rc, lines, tier.stores_state(),
                         [s.sharding.ranges() for s in tier.svcs],
                         [s.sharding.version for s in tier.svcs])
        remote.close()
        to_new.close()
    want = results["jax", "jax"]
    assert want[0] == 0 and want[1][0].startswith("RESHARD_JSON ")
    assert json.loads(want[1][0].split(" ", 1)[1])["journal_loaded"] == 1
    assert results[coord, prims] == want


def _crash_cycle(pkg: str, tier, monkeypatch, case: str, clock) -> list:
    """One crash case against ``tier``: the coordinators' (rc, lines) in
    order and the tier's stores, ranges and versions after each."""
    p = tier.primaries
    seq = []

    def run(*extra, donor=0, recipient=1):
        rc, lines, err = _coordinate(pkg, _move(p, donor, recipient,
                                                "16:32", *extra),
                                     monkeypatch)
        seq.append((rc, lines, "abort refused" in err,
                    tier.stores_state(),
                    [s.sharding.ranges() for s in tier.svcs],
                    [s.sharding.version for s in tier.svcs],
                    [s.migration_view() for s in tier.svcs]))

    if case in ("export", "import", "apply_first", "apply_all"):
        run("--json", "--migration-id", f"mig-{case}", "--crash-after",
            case)
        run("--json", "--resume")
        run("--json", "--resume")          # nothing left: outcome none
    elif case == "lease":
        run("--json", "--migration-id", "mig-lease", "--lease-ttl", "1.5",
            "--crash-after", "import")
        clock.t += 2.6
        run("--json", "--resume")
    elif case == "abort_ok":
        run("--json", "--migration-id", "mig-a", "--crash-after", "export")
        run("--json", "--abort")
    else:  # abort_refused
        run("--json", "--migration-id", "mig-b", "--crash-after",
            "apply_first")
        run("--json", "--abort")
        run("--json", "--resume")
    return seq


@pytest.mark.parametrize("case", ["export", "import", "apply_first",
                                  "apply_all", "lease", "abort_ok",
                                  "abort_refused"])
def test_crash_points_resume_and_abort_as_jax(case, tiers, monkeypatch,
                                              clock):
    """The port's coordinator killed at each phase boundary, then
    ``--resume`` (or ``--abort``), against port primaries, gives the JAX
    coordinator's outcome lines over JAX primaries, step by step, with
    equal stores, maps and ledgers."""
    init = _params(_keys())
    seqs = {}
    for pkg in ("jax", "port"):
        clock.t = 1_000_000.0
        tier = tiers(pkg, init)
        seqs[pkg] = _crash_cycle(pkg, tier, monkeypatch, case, clock)
    assert seqs["port"] == seqs["jax"]
    rcs = [s[0] for s in seqs["port"]]
    lines = [s[1] for s in seqs["port"]]
    if case in ("export", "import", "apply_first", "apply_all"):
        assert rcs == [f"crash:{case}", 0, 0]
        resume = json.loads(lines[1][-1].split(" ", 1)[1])
        assert resume["outcome"] == "rolled_forward"
        assert resume["from_phase"] == ("export" if case in (
            "export", "import") else "apply_ranges")
        assert json.loads(lines[2][-1].split(" ", 1)[1])["outcome"] \
            == "none"
        assert seqs["port"][-1][5] == [2, 2]
    elif case == "lease":
        assert rcs == ["crash:import", 0]
        resume = json.loads(lines[1][-1].split(" ", 1)[1])
        assert resume["outcome"] == "rolled_back" and resume["dropped"] >= 1
        assert seqs["port"][-1][5] == [1, 1]
        assert any(ln.startswith("RESHARD_LEASE_EXPIRED")
                   for ln in lines[1])
    elif case == "abort_ok":
        assert rcs == ["crash:export", 0]
        assert lines[1][-1].startswith("RESHARD_ABORT_JSON ")
    else:
        assert rcs == ["crash:apply_first", 4, 0]
        assert seqs["port"][1][2]
        resume = json.loads(lines[2][-1].split(" ", 1)[1])
        assert resume["from_phase"] == "apply_ranges"


@pytest.mark.parametrize("argv", [
    ["--donor", "0", "--recipient", "2", "--slots", "16:32"],
    ["--donor", "0", "--recipient", "5", "--slots", "16:32"],
    ["--donor", "0", "--recipient", "1", "--slots", "16-32"],
    ["--donor", "0", "--recipient", "1", "--slots", "16:32", "--resume",
     "--abort"],
    ["--donor", "0", "--recipient", "1", "--slots", "16:24"],
    ["--donor", "1", "--recipient", "0", "--slots", "40:64"],
    ["--donor", "0", "--recipient", "1", "--slots", "40:48"]],
    ids=["non-adjacent", "out-of-range", "bad-slots", "resume-and-abort",
         "wrong-upper-boundary", "wrong-lower-boundary", "not-owned"])
def test_plan_errors_are_jax_texts(argv, tiers, monkeypatch):
    init = _params(_keys())
    out = {}
    for pkg in ("jax", "port"):
        tier = tiers(pkg, init)
        prims = tier.primaries
        if argv[3] == "2":
            prims += ",127.0.0.1:1"
        rc, _, _ = _coordinate(pkg, ["--primaries", prims, *argv],
                               monkeypatch)
        out[pkg] = (rc, tier.stores_state(),
                    [s.migration_view() for s in tier.svcs])
    assert out["port"] == out["jax"]
    assert str(out["port"][0]).startswith("exit:") \
        and out["port"][0] != "exit:0"


# -- the client across a move -------------------------------------------------

def _union(stores) -> dict:
    out = {}
    for s in stores:
        out.update(s.snapshot()[0])
    return out


def test_sharded_client_pushes_across_a_move(tiers, monkeypatch):
    """A port ``ShardedRemoteStore`` over port primaries pushes, the range
    moves, it pushes again: after every push the union of the primaries
    equals one store fed the same pushes, bit for bit; a push into the
    frozen range names the disowned keys the JAX client reports over JAX
    primaries; the last pre-move push re-sent to the new owner is a
    duplicate there."""
    init = _params(_keys())
    tier = tiers("port", init)
    one = ParameterStore(dict(init), StoreConfig(
        mode="async", total_workers=1, push_codec="none",
        staleness_bound=100))
    one.register_worker("w")
    fan = ShardedRemoteStore(tier.addrs, rpc_timeout=RPC_TIMEOUT)
    wid, _ = fan.register_worker("w")
    names = list(init)
    kept = None
    for i in range(4):
        if i == 2:
            kept = fan._stores[0]._last_push
            rc, _, _ = _coordinate("port", _move(tier.primaries, 0, 1,
                                                 "16:32", "--json"),
                                   monkeypatch)
            assert rc == 0
        params, step = fan.fetch(wid)
        ref_params, ref_step = one.fetch(0)
        assert step == ref_step
        g = _grads(names, 10 + i, init)
        assert fan.push(wid, g, step) is True
        assert one.push(0, g, ref_step) is True
        union, ref = _union(tier.stores), one.snapshot()[0]
        assert sorted(union) == sorted(ref)
        assert all(union[k].tobytes() == ref[k].tobytes() for k in ref)
    moved = [k for k in names if 16 <= key_slot(k) < 32]
    assert moved and all(k in tier.stores[1].parameters
                         and k not in tier.stores[0].parameters
                         for k in moved)
    new_owner = RemoteStore(tier.addrs[1], rpc_timeout=RPC_TIMEOUT)
    new_owner._last_push = kept
    before = tier.stores[1].global_step
    assert new_owner.repush_last(wid) is True
    assert tier.stores[1].global_step == before
    new_owner.close()
    fan.close()
    # A push into a frozen range: each client over its own package's
    # primaries, the donor frozen by an export that never publishes.
    disowned = {}
    for pkg in ("jax", "port"):
        t = tiers(pkg, init)
        t.svcs[0].reshard(JS.pack_msg({"op": "export", "slot_lo": 16,
                                       "slot_hi": 32,
                                       "migration": _plan()}), None)
        client = PKGS[pkg]["remote"](t.addrs[0], rpc_timeout=RPC_TIMEOUT)
        w, _ = client.register_worker("w")
        own = list(t.stores[0].snapshot()[0])
        accepted = client.push(w, _grads(own, 3, init), 0)
        disowned[pkg] = (accepted, sorted(client.last_disowned),
                         t.stores_state())
        client.close()
    assert disowned["port"] == disowned["jax"]
    assert disowned["port"][1] == sorted(
        k for k in t.stores[0].parameters if 16 <= key_slot(k) < 32)
    # The JAX sharded client over the port primaries sees the same map.
    jfan = JaxSharded(tier.addrs, rpc_timeout=RPC_TIMEOUT)
    jfan.register_worker("j")
    assert jfan._route_ranges() == fan._route_ranges()
    jfan.close()


def test_reshard_fault_rule_fails_the_second_call_as_jax():
    """``reshard.unavailable@n=2`` wraps the port's Reshard handler as
    the JAX service's: the second call fails UNAVAILABLE, the others
    answer byte-equal replies; over gRPC the port server's injector
    counts the calls."""
    init = _params(_keys())
    seqs = {}
    spec = "reshard.unavailable@n=2"
    for pkg, inj, err in (("jax", JaxInjector, JaxInjected),
                          ("port", FaultInjector, InjectedRpcError)):
        _, svcs = _pair(pkg, init)
        injector = inj(spec, side="server")
        call = injector.wrap_handler("Reshard", svcs[0].reshard)
        seq = []
        for _ in range(3):
            try:
                seq.append(bytes(call(JS.pack_msg({"op": "status"}),
                                      None)))
            except err as e:
                seq.append((e.code(), e.details()))
        seqs[pkg] = seq
    assert seqs["port"] == seqs["jax"]
    assert isinstance(seqs["port"][1], tuple)
    tier = Tier("port", init, faults=FaultInjector(spec, side="server"))
    try:
        remote = RemoteStore(tier.addrs[0], rpc_timeout=RPC_TIMEOUT,
                             rpc_retries=0)
        remote.reshard_op("status")
        with pytest.raises(Exception, match="UNAVAILABLE"):
            remote.reshard_op("status")
        meta, _ = remote.reshard_op("status")
        assert meta["migration"] is None
        assert tier.svcs[0].faults._op_calls["Reshard"] == 3
        remote.close()
    finally:
        tier.close()


def test_native_primary_export_fails_in_both_packages():
    """JAX's C++-arena store has no ``param_names``/``export_params``, so
    ``export`` on a native primary fails; the port's fails the same way,
    and the freeze it started is the same."""
    init = _params(_keys())
    out = {}
    for pkg in ("jax", "port"):
        _, svcs = _pair(pkg, init, backend="native")
        with pytest.raises(AttributeError) as e:
            svcs[0].reshard(JS.pack_msg({"op": "export", "slot_lo": 16,
                                         "slot_hi": 32}), None)
        out[pkg] = (str(e.value).split("'")[-2], sorted(svcs[0]._draining))
    assert out["port"] == out["jax"]
    assert out["port"][0] == "param_names"
