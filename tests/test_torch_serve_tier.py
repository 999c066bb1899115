"""The serve tier's decision logic against the JAX package's: one
sequence of offers, arm picks and quality samples fed to both packages'
``CanaryController`` gives the same promotions, rollbacks and views
(JAX ``test_serve_tier.py``'s canary cases); one fake pool, QPS source
and shard view ticked through both packages' ``ReplicaAutoscaler`` on
one injected clock gives the same decisions, placements and views (JAX
``test_serve_tier.py``'s and ``test_fanout.py``'s autoscaler cases); and
the port's ``ReplicaPool`` over fake processes spawns, shrinks, reaps and
stops as JAX's, with ``cli replica`` argv that name the port's package.
Each scenario is a case of one parametrised test."""

import pytest

from distributed_parameter_server_for_ml_training_tpu.comms.replica import \
    CanaryController as JaxCanary
from distributed_parameter_server_for_ml_training_tpu.ps.supervisor import (
    ReplicaPool as JaxPool, build_replica_argv as jax_replica_argv)
from distributed_parameter_server_for_ml_training_tpu.telemetry.autoscale \
    import AutoscalePolicy as JaxPolicy, ReplicaAutoscaler as JaxScaler
from distributed_parameter_server_for_ml_training_tpu.telemetry.registry \
    import MetricsRegistry as JaxRegistry
from distributed_parameter_server_for_ml_training_tpu_torch.comms.replica \
    import CanaryController
from distributed_parameter_server_for_ml_training_tpu_torch.ps.supervisor \
    import ReplicaPool, build_replica_argv
from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
    .autoscale import AutoscalePolicy, ReplicaAutoscaler
from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
    .registry import MetricsRegistry

# -- the canary ---------------------------------------------------------------


def _q(arm, step, value, n=1):
    return [("quality", arm, step, value)] * n


#: name -> (controller kwargs, ops). An op is ("offer", step), ("pick",
#: n), ("quality", arm, step, value) or ("decide",).
CANARY = {
    "split_and_candidates": ({"fraction": 0.5, "min_samples": 2}, [
        ("offer", 3), ("pick", 3), ("offer", 5), ("pick", 8), ("offer", 4),
        ("offer", 5), ("pick", 2)]),
    "promote": ({"fraction": 0.5, "min_samples": 2}, [
        ("offer", 1), ("offer", 2), *_q("stable", 1, 0.8, 2),
        *_q("canary", 2, 0.9, 2), ("decide",), ("pick", 4)]),
    "rollback_fences_the_step": ({"fraction": 0.5, "min_samples": 2}, [
        ("offer", 1), ("offer", 2), *_q("stable", 1, 0.9, 2),
        *_q("canary", 2, 0.1, 2), ("decide",), ("offer", 2), ("offer", 3),
        ("pick", 4)]),
    "stale_feedback_and_tolerance": (
        {"fraction": 0.5, "min_samples": 2, "tolerance": 0.05}, [
            ("offer", 1), ("offer", 2), ("quality", "canary", 99, 0.0),
            *_q("stable", 1, 1.0, 2), ("decide",),
            *_q("canary", 2, 0.97, 2), ("decide",)]),
    "default_period_and_window": ({"min_samples": 5, "window": 4}, [
        ("offer", 10), ("offer", 11), ("pick", 45),
        *_q("stable", 10, 0.5, 7), *_q("canary", 11, 0.4, 3), ("decide",),
        *_q("canary", 11, 0.6, 3), ("decide",), ("offer", 12),
        *_q("stable", 11, 0.6, 5), *_q("canary", 12, 0.2, 5), ("decide",),
        ("offer", 12), ("offer", 13), ("pick", 20)]),
    "bad_fractions": ({"fraction": 0.0}, []),
    "bad_fraction_high": ({"fraction": 0.6}, []),
}


def _canary_run(cls, kwargs, ops):
    try:
        c = cls(**kwargs)
    except ValueError as e:
        return [("refused", str(e))]
    out = []
    for op in ops:
        if op[0] == "offer":
            got = c.offer(op[1])
        elif op[0] == "pick":
            got = [c.pick_arm() for _ in range(op[1])]
        elif op[0] == "quality":
            got = c.note_quality(*op[1:])
        else:
            got = c.decide()
        out.append((op, got, c.view()))
    return out


@pytest.mark.parametrize("name", list(CANARY))
def test_canary_decisions_equal_jax(name):
    kwargs, ops = CANARY[name]
    got = _canary_run(CanaryController, kwargs, ops)
    assert got == _canary_run(JaxCanary, kwargs, ops)
    if name.startswith("bad_"):
        assert got[0][0] == "refused"
        return
    decisions = [g for op, g, _ in got if op == ("decide",)]
    if name == "promote":
        assert decisions == ["promote"]
    elif name == "rollback_fences_the_step":
        assert decisions == ["rollback"] and got[-1][2]["bad_steps"] == [2]


# -- the autoscaler -----------------------------------------------------------


class _Pool:
    """A fake pool: tree-aware unless ``flat`` (a one-argument grow)."""

    def __init__(self, live=0, flat=False):
        self.live, self.parents, self.shrunk = live, [], 0
        if flat:
            self.grow = self._grow_flat

    def count(self):
        return self.live

    def grow(self, parent=None):
        self.live += 1
        self.parents.append(parent)
        return self.live - 1

    def _grow_flat(self):
        return self.grow()

    def shrink(self):
        if self.live == 0:
            return None
        self.live -= 1
        self.shrunk += 1
        return self.live


class _Shard:
    def __init__(self, rows, primaries=("p:1",)):
        self.rows, self.primaries = rows, list(primaries)

    def view(self):
        return {"replicas": self.rows, "primaries": self.primaries,
                "tiers": {"1": {"replicas": len(self.rows)}}}


_TREE = [{"address": "i1:1", "tier": 1, "fetch_qps": 50.0},
         {"address": "i2:1", "tier": 1, "fetch_qps": 200.0},
         {"address": "e1:1", "tier": 2, "parent": "i1:1"}]

#: name -> (policy kwargs, pool kwargs, shard rows or None, ticks). A
#: tick is (seconds, fetches added, max lag of the shard rows or None).
AUTOSCALE = {
    "grow_cooldown_grow_to_max": (
        {"qps_high": 10.0, "qps_low": 1.0, "cooldown_s": 10.0,
         "max_replicas": 2}, {}, None,
        [(0, 0, None), (1, 100, None), (1, 100, None), (20, 400, None),
         (20, 800, None)]),
    "shrink_blocked_by_lag": (
        {"qps_high": 10.0, "qps_low": 1.0, "cooldown_s": 0.0,
         "lag_high_steps": 10.0}, {"live": 2},
        [{"address": "r:1", "tier": 1, "lag_steps": 50.0}],
        [(0, 0, None), (10, 0, None), (10, 0, 0.0), (10, 0, 0.0)]),
    "min_floor": (
        {"qps_high": 10.0, "qps_low": 1.0, "cooldown_s": 0.0,
         "min_replicas": 1}, {}, None,
        [(0, 0, None), (10, 0, None), (10, 0, None)]),
    "dry_run": (
        {"qps_high": 10.0, "qps_low": 1.0, "cooldown_s": 0.0,
         "dry_run": True}, {}, None, [(0, 0, None), (1, 100, None)]),
    "tree_hottest_interior": (
        {"qps_high": 10.0, "qps_low": 1.0, "cooldown_s": 0.0,
         "max_tier": 2, "fanout": 2, "max_replicas": 8}, {"live": 3},
        _TREE + [{"address": "i3:1", "tier": 1, "fetch_qps": 1.0}],
        [(0, 0, None), (1, 100, None), (1, 5000, None)]),
    "tree_primary_hottest": (
        {"qps_high": 10.0, "qps_low": 1.0, "cooldown_s": 0.0,
         "max_tier": 2, "fanout": 3}, {"live": 1},
        [{"address": "i1:1", "tier": 1, "fetch_qps": 20.0}],
        [(0, 0, None), (1, 1000, None)]),
    "tree_cap_and_full_nodes": (
        {"qps_high": 0.5, "qps_low": 0.1, "cooldown_s": 0.0,
         "max_tier": 2, "fanout": 2}, {"live": 4},
        [{"address": "i1:1", "tier": 2, "fetch_qps": 900.0},
         {"address": "i2:1", "tier": 1, "fetch_qps": 5.0},
         {"address": "e1:1", "tier": 2, "parent": "i2:1"},
         {"address": "e2:1", "tier": 2, "parent": "i2:1"}],
        [(0, 0, None), (1, 1, None)]),
    "flat_one_argument_pool": (
        {"qps_high": 10.0, "qps_low": 1.0, "cooldown_s": 0.0},
        {"flat": True}, None, [(0, 0, None), (1, 100, None)]),
    "bad_thresholds": ({"qps_high": 5.0, "qps_low": 5.0}, {}, None, []),
    "bad_bounds": ({"min_replicas": 3, "max_replicas": 1}, {}, None, []),
    "bad_tree": ({"max_tier": 0}, {}, None, []),
    "bad_fanout": ({"fanout": 0}, {}, None, []),
}


def _autoscale_run(policy_cls, scaler_cls, registry_cls, name):
    policy_kw, pool_kw, rows, ticks = AUTOSCALE[name]
    try:
        policy = policy_cls(**policy_kw)
    except ValueError as e:
        return [("refused", str(e))]
    pool = _Pool(**pool_kw)
    shard = None if rows is None else _Shard([dict(r) for r in rows])
    t, fetches = [100.0], [0.0]
    asc = scaler_cls(pool, policy, sharding=shard, registry=registry_cls(),
                     clock=lambda: t[0], fetch_total_fn=lambda: fetches[0])
    out = []
    for dt, df, lag in ticks:
        t[0] += dt
        fetches[0] += df
        if lag is not None:
            for r in shard.rows:
                r["lag_steps"] = lag
        out.append((asc.tick(), pool.live, list(pool.parents), pool.shrunk))
    out.append((asc.view(), asc.actions,
                None if shard is None else asc._pick_parent(0.0)))
    return out


@pytest.mark.parametrize("name", list(AUTOSCALE))
def test_autoscaler_decisions_equal_jax(name):
    got = _autoscale_run(AutoscalePolicy, ReplicaAutoscaler,
                         MetricsRegistry, name)
    assert got == _autoscale_run(JaxPolicy, JaxScaler, JaxRegistry, name)
    events = [row[0] for row in got[:-1] if row[0] is not None]
    if name == "grow_cooldown_grow_to_max":
        assert [e["outcome"] for e in events] == ["ok", "rate_limited",
                                                  "ok"]
        assert got[-1][1] == {"replica_grow": 2, "replica_shrink": 0}
    elif name == "tree_hottest_interior":
        assert events[0]["parent"] == "i2:1"


def test_autoscaler_reads_fetch_counters_as_jax():
    """The QPS source: every FetchParameters handler counter and replica
    serve counter of the registry, as JAX's scan reads them."""
    totals = []
    for reg_cls, scaler_cls, policy_cls in (
            (MetricsRegistry, ReplicaAutoscaler, AutoscalePolicy),
            (JaxRegistry, JaxScaler, JaxPolicy)):
        reg = reg_cls()
        reg.counter("dps_rpc_handler_calls_total",
                    rpc="FetchParameters").inc(5)
        reg.counter("dps_rpc_handler_calls_total",
                    rpc="PushGradrients").inc(50)
        reg.counter("dps_replica_fetches_total").inc(7)
        totals.append(scaler_cls(_Pool(), policy_cls(),
                                 registry=reg)._fetch_total())
    assert totals == [12.0, 12.0]


# -- the replica pool ---------------------------------------------------------


class _Proc:
    def __init__(self, argv, env):
        self.argv, self.env, self.rc, self.terminated = argv, env, None, \
            False

    def poll(self):
        return self.rc

    def terminate(self):
        self.terminated, self.rc = True, 0

    def wait(self, timeout=None):
        return self.rc if self.rc is not None else 0

    def kill(self):
        self.rc = -9


def _pool_run(pool_cls, argv_fn, case):
    spawned, lines = [], []

    def spawn(argv, env):
        spawned.append(_Proc(argv, env))
        return spawned[-1]

    pool = pool_cls(lambda idx, parent=None: argv_fn(
        "localhost:9999", ["--shard-id", "0"], idx, parent=parent),
        spawn=spawn, log=lambda line, **kw: lines.append(line))
    out = []
    if case == "grow_shrink_reap":
        out += [pool.grow(), pool.grow(), pool.count(), pool.shrink(),
                [p.terminated for p in spawned], pool.count()]
        spawned[0].rc = 3
        out += [pool.count(), pool.shrink(), pool.status()]
    elif case == "stop":
        pool.grow()
        pool.grow(parent="i:7")
        pool.stop()
        out += [[p.terminated for p in spawned], pool.count()]
    elif case == "parent":
        pool.grow()
        pool.grow(parent="i:7")
        out += [pool.status()]
        pool.stop()
    pkg = argv_fn.__module__.rsplit(".", 2)[0]
    argvs = [[a.replace(pkg, "<pkg>") for a in p.argv[1:]] for p in spawned]
    return out, lines, argvs, [p.env for p in spawned]


@pytest.mark.parametrize("case", ["grow_shrink_reap", "stop", "parent"])
def test_replica_pool_equals_jax(case):
    got = _pool_run(ReplicaPool, build_replica_argv, case)
    assert got == _pool_run(JaxPool, jax_replica_argv, case)
    argv, env = build_replica_argv("h:1", ["--shard-id", "3"], 2,
                                   parent="i:9")
    assert env is None and argv[1:3] == [
        "-m", "distributed_parameter_server_for_ml_training_tpu_torch.cli"]
    assert argv[3:] == ["replica", "--primary", "h:1", "--port", "0",
                        "--parent", "i:9", "--shard-id", "3"]
