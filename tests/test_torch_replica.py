"""The port's read replica (``comms/replica.py``) against the JAX
package's, over localhost gRPC: a port ``ReplicaServer`` subscribed to a
JAX primary and a JAX ``ReplicaServer`` to a port primary serve, at
every step, a FetchParameters payload byte-equal to their primary's,
answer a ``have_step`` poll at the current step NOT_MODIFIED, redirect a
push in the same bytes as the other package's replica, refuse fetches
once stale under an injected clock, and form a 2-tier chain that the
primary's shard view lists with its parents. Then the fan-out classes
of the JAX package's ``test_fanout.py``, on the port: tier staleness,
topology gating, coalescing (parked polls share one payload object) and
re-parenting (cooldown, fallback to the primary, client-side refresh
faults, a dead parent). Polls run every 10 ms."""

import time

import grpc
import pytest

from distributed_parameter_server_for_ml_training_tpu.comms import \
    replica as JR
from distributed_parameter_server_for_ml_training_tpu_torch.comms import \
    replica as PR
from distributed_parameter_server_for_ml_training_tpu_torch.comms.service \
    import pack_msg, unpack_msg
from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
    import get_registry
from torch_serve_tier import (REPLICA, Ctx, fetch_stub, grads, primary,
                              rpc_stub, wait)

STEPS = 3


@pytest.mark.parametrize("replica_pkg,primary_pkg",
                         [("port", "jax"), ("jax", "port")],
                         ids=["port-replica-jax-primary",
                              "jax-replica-port-primary"])
def test_replica_serves_its_primarys_bytes(replica_pkg, primary_pkg):
    store, svc, server, paddr = primary(primary_pkg)
    R = REPLICA[replica_pkg].ReplicaServer
    other = REPLICA["jax" if replica_pkg == "port" else "port"]
    t = [1000.0]
    r1 = R(paddr, poll_interval=0.01, clock=lambda: t[0])
    r2 = None
    chans = []
    try:
        r1addr = f"127.0.0.1:{r1.start()}"
        r2 = R(paddr, poll_interval=0.01, parent=r1.advertise,
               clock=lambda: t[0])
        r2addr = f"127.0.0.1:{r2.start()}"
        (cp, fp), (c1, f1), (c2, f2) = (fetch_stub(a) for a in
                                         (paddr, r1addr, r2addr))
        chans = [cp, c1, c2]
        wid, _ = store.register_worker("w")
        for i in range(STEPS):
            store.push(wid, grads(i), store.global_step)
            step = store.global_step
            assert wait(lambda: r1.view()["step"] == step
                        and r2.view()["step"] == step)
            want = bytes(unpack_msg(fp(pack_msg({}), timeout=10))[1])
            for f in (f1, f2):
                meta, payload = unpack_msg(f(pack_msg({}), timeout=10))
                assert meta["global_step"] == step and meta["replica"]
                assert bytes(payload) == want
                nm, rest = unpack_msg(f(pack_msg({"have_step": step}),
                                        timeout=10))
                assert nm["not_modified"] and not len(rest)
        # Tiers learned from the parent's reply head; the primary's shard
        # view lists both nodes with their parents, and the topology
        # flows down to the edge.
        assert (r1.view()["tier"], r2.view()["tier"]) == (1, 2)
        rows = {r["address"]: r for r in svc.sharding.view()["replicas"]}
        assert (rows[r1.advertise]["parent"], rows[r1.advertise]["tier"]) \
            == (paddr, 1)
        assert (rows[r2.advertise]["parent"], rows[r2.advertise]["tier"]) \
            == (r1.advertise, 2)
        assert wait(lambda: r2._topology is not None and r1.advertise in {
            n["address"] for n in r2._topology["nodes"]})
        # A push to a replica is redirected to the primary, in the other
        # package's bytes.
        redirect = rpc_stub(c1, "PushGradrients")(pack_msg({}), timeout=10)
        assert redirect == other.ReplicaServer(paddr)._redirect(b"", None)
        assert unpack_msg(redirect)[0]["redirect"] == paddr
        # Stale: the subscription stops, the injected clock moves past the
        # bound, and fetches are refused with the primary named.
        r1._stop.set()
        r1._thread.join()
        t[0] += 100.0
        with pytest.raises(grpc.RpcError) as err:
            f1(pack_msg({}), timeout=10)
        assert err.value.code() == grpc.StatusCode.UNAVAILABLE
        assert err.value.details() == \
            f"replica stale (last sync 100.0); use primary {paddr}"
    finally:
        for c in chans:
            c.close()
        for r in (r2, r1):
            if r is not None:
                r.stop()
        server.stop(grace=None)


def test_tier_staleness_equals_jax():
    for tier in range(0, 5):
        for base in (5.0, 2.0):
            assert PR.tier_staleness_bound(tier, base) == \
                JR.tier_staleness_bound(tier, base)
    assert PR.DEFAULT_STALENESS_BOUND_S == JR.DEFAULT_STALENESS_BOUND_S
    for kw in ({}, {"parent": "localhost:2"},
               {"staleness_bound_s": 2.5, "parent": "localhost:2"}):
        p, j = (PR.ReplicaServer("localhost:1", **kw),
                JR.ReplicaServer("localhost:1", **kw))
        for rep in (p, j):
            rep._set_tier(3)
        assert p.view() == j.view()


def test_topology_fields_are_delta_gated():
    store, svc, server, paddr = primary()
    try:
        svc.sharding.note_replica("t1:1", 0, 0, parent=paddr, tier=1)
        fields = svc._topology_fields()
        ver = fields["topology"]["version"]
        assert svc._topology_fields(have_version=ver) == {}
        assert "topology" in svc._topology_fields(have_version=ver - 1)
        assert "topology" in svc._topology_fields(have_version="junk")
        channel, stub = fetch_stub(paddr)
        try:
            assert "topology" in unpack_msg(
                stub(pack_msg({"have_topology": 0}), timeout=10))[0]
            assert "topology" not in unpack_msg(
                stub(pack_msg({"have_topology": ver}), timeout=10))[0]
        finally:
            channel.close()
    finally:
        server.stop(grace=None)


@pytest.mark.parametrize("case", ["parked", "no_coalesce", "full_fetch"])
def test_coalescing(case):
    """Delta polls at the current step arriving mid-refresh park on the
    single-flight latch and all get the SAME pre-encoded bytes object;
    with coalescing off, and for full fetches, nothing parks."""
    store, svc, server, paddr = primary()
    rep = PR.ReplicaServer(paddr, poll_interval=5.0, staleness_bound_s=60.0,
                           coalesce=case != "no_coalesce",
                           coalesce_wait_s=5.0)
    try:
        rep.start()
        assert wait(lambda: rep.view()["synced"])
        with rep._lock:
            rep._refresh_inflight = True
        if case != "parked":
            t0 = time.monotonic()
            req = pack_msg({} if case == "full_fetch" else {"have_step": 0})
            out = rep._fetch_parameters(req, Ctx())
            assert time.monotonic() - t0 < 1.0
            assert out is (rep._reply if case == "full_fetch"
                           else rep._nm_reply)
            assert rep.view()["coalesced"] == 0
            return
        import threading
        results = []
        threads = [threading.Thread(target=lambda: results.append(
            rep._fetch_parameters(pack_msg({"have_step": 0}), Ctx())))
            for _ in range(3)]
        for th in threads:
            th.start()
        assert wait(lambda: rep._cond._waiters and len(
            rep._cond._waiters) == 3, 5.0)
        with rep._lock:
            rep._refresh_done_locked()
        for th in threads:
            th.join(5.0)
        assert len(results) == 3 and all(r is rep._nm_reply
                                         for r in results)
        assert rep.view()["coalesced"] == 3
        assert get_registry().snapshot()["gauges"]["dps_coalesce_ratio"] > 0
    finally:
        rep.stop()
        server.stop(grace=None)


def test_reparent_cooldown_and_pick_equal_jax():
    """The cooldown holds a move; with no topology the node falls back
    to the primary; from one cached topology both packages pick the same
    new parent (lowest lag at the dead parent's tier, never a node of
    its own subtree)."""
    rep = PR.ReplicaServer("localhost:1", parent="localhost:2",
                           reparent_cooldown_s=999.0)
    rep._last_reparent = time.monotonic()
    assert rep._maybe_reparent() is False and rep.parent == "localhost:2"
    rep = PR.ReplicaServer("localhost:1", parent="localhost:2",
                           reparent_cooldown_s=0.0)
    try:
        assert rep._maybe_reparent() is True and rep.parent == "localhost:1"
        assert rep._maybe_reparent() is False
    finally:
        rep._channel.close()
    topo = {"version": 4, "primary": "localhost:1", "nodes": [
        {"address": "a:1", "tier": 1, "lag_steps": 5},
        {"address": "b:1", "tier": 1, "lag_steps": 0},
        {"address": "c:1", "tier": 1, "lag_steps": 0},
        {"address": "me:1", "tier": 2, "parent": "a:1"},
        {"address": "kid:1", "tier": 1, "parent": "me:1"}]}
    picks = []
    for mod in (PR, JR):
        r = mod.ReplicaServer("localhost:1", parent="a:1")
        r.advertise = "me:1"
        r._set_tier(2)
        r._topology = topo
        picks.append(r._pick_parent())
    assert picks == ["b:1", "b:1"]


@pytest.mark.parametrize("case", ["refresh_partition", "parent_death"])
def test_reparent_on_refresh_failure(case):
    """``refresh.partition`` injected at the child (its parent never
    reached) re-parents it to the primary; a dead interior node
    re-parents its child to a sibling at the same tier."""
    store, svc, server, paddr = primary()
    reps = []

    def start(**kw):
        rep = PR.ReplicaServer(paddr, poll_interval=0.01,
                               staleness_bound_s=30.0, **kw)
        reps.append(rep)
        rep.start()
        return rep

    try:
        if case == "refresh_partition":
            child = start(parent="localhost:1", reparent_after=2,
                          reparent_cooldown_s=0.0,
                          faults="refresh.partition=0.2@n=1")
            assert wait(lambda: child.view()["parent"] == paddr)
            assert wait(lambda: child.view()["synced"])
            assert child.view()["tier"] == 1
            return
        a, b = start(), start()
        child = start(parent=a.advertise, reparent_after=2,
                      reparent_cooldown_s=0.0)
        assert wait(lambda: child._topology is not None and b.advertise in {
            n["address"] for n in child._topology["nodes"]})
        a.stop()
        assert wait(lambda: child.view()["parent"] == b.advertise)
        assert child.view()["tier"] == 2
        counters = get_registry().snapshot()["counters"]
        assert counters["dps_replica_reparents_total"] >= 1
    finally:
        for rep in reversed(reps):
            rep.stop()
        server.stop(grace=None)
