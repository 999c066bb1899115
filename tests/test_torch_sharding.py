"""The port's sharded parameter-server tier against the JAX package's.

``…_torch/ps/sharding.py`` is the JAX module's own copy: the hash
partition of ResNet-18's, ViT-B/16's and random names at 1–5 shards, the
shard-map validation and a scripted ``ShardInfo`` sequence (announces,
re-parents, expiry, a range adoption, on one injected clock) equal the
JAX module's. The service's shard-primary mode answers a scripted
request sequence with the JAX service's bytes, sharded and not. Over
localhost gRPC, two port primaries behind the port's
``ShardedRemoteStore`` stay bit-equal to one port store in async (with a
stale push) and in sync rounds, for the ``none`` and ``int8`` codecs, and
the mixed pairings run both ways: the port's fan-out against two JAX
primaries and the JAX fan-out against two port primaries. A push on a map
that moved under the client is re-routed once in async and dropped in
sync. A snapshot restores only into the shard that wrote it.
"""

import re
import socket
import threading

import jax
import numpy as np
import pytest

from distributed_parameter_server_for_ml_training_tpu.comms import \
    service as JS, sharded as JSH
from distributed_parameter_server_for_ml_training_tpu.models import \
    get_model as jax_get_model
from distributed_parameter_server_for_ml_training_tpu.ps import \
    sharding as JSD
from distributed_parameter_server_for_ml_training_tpu.ps.store import (
    ParameterStore as JaxStore, StoreConfig as JaxConfig)
from distributed_parameter_server_for_ml_training_tpu.utils.pytree import \
    flatten_params
from distributed_parameter_server_for_ml_training_tpu_torch import cli, \
    models
from distributed_parameter_server_for_ml_training_tpu_torch.checkpoint \
    import restore_server_state, save_store
from distributed_parameter_server_for_ml_training_tpu_torch.comms import \
    service as PS
from distributed_parameter_server_for_ml_training_tpu_torch.comms.client \
    import RemoteStore
from distributed_parameter_server_for_ml_training_tpu_torch.comms.sharded \
    import ShardedRemoteStore
from distributed_parameter_server_for_ml_training_tpu_torch.data import \
    synthetic_cifar100
from distributed_parameter_server_for_ml_training_tpu_torch.models import \
    get_model
from distributed_parameter_server_for_ml_training_tpu_torch.ops \
    .compression import int8_wire_compress
from distributed_parameter_server_for_ml_training_tpu_torch.ps import \
    sharding as SD
from distributed_parameter_server_for_ml_training_tpu_torch.ps.store \
    import ParameterStore, StoreConfig
from distributed_parameter_server_for_ml_training_tpu_torch.utils.pytree \
    import params_to_jax
from torch_threads import one_torch_thread_per_module  # noqa: F401

RPC_TIMEOUT = 30.0


def _port_resnet18_names() -> list:
    flat, _ = params_to_jax(get_model("resnet18", device="cpu", seed=0))
    return list(flat)


def _jax_names(name: str, size: int) -> list:
    model = jax_get_model(name, num_classes=100, image_size=size)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           np.zeros((1, size, size, 3), np.float32),
                           train=False))
    return list(flatten_params(shapes["params"]))


@pytest.fixture(scope="module")
def model_names():
    """ResNet-18's flat names (the port's, equal to JAX's as a set) and
    ViT-B/16's."""
    names = _port_resnet18_names()
    assert sorted(names) == sorted(_jax_names("resnet18", 32))
    return names, _jax_names("vit_b16", 224)


def test_module_constants_equal_jax():
    assert SD.SHARD_SLOTS == JSD.SHARD_SLOTS
    assert SD.SHARD_MAP_FIELDS == JSD.SHARD_MAP_FIELDS
    assert SD.ShardInfo.REPLICA_EXPIRE_S == JSD.ShardInfo.REPLICA_EXPIRE_S
    assert SD.__all__ == JSD.__all__


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_hash_partition_equals_jax(n, model_names):
    rng = np.random.default_rng(n)
    rand = ["".join(rng.choice(list("abcdefgh/_0123456789"), size=12))
            for _ in range(200)] + ["", "w::int8scale", "ünï/κ"]
    for names in (*model_names, rand):
        assert SD.partition_keys(names, n) == JSD.partition_keys(names, n)
        for k in names:
            assert SD.key_slot(k) == JSD.key_slot(k)
            assert SD.shard_for_key(k, n) == JSD.shard_for_key(k, n)
    for i in range(n):
        assert SD.slot_range(i, n) == JSD.slot_range(i, n)
    ranges = [SD.slot_range(i, n) for i in range(n)]
    for slot in range(SD.SHARD_SLOTS):
        assert SD.shard_for_slot(slot, ranges) == \
            JSD.shard_for_slot(slot, ranges)


def _maps():
    good = JSD.ShardInfo(0, 2, ["h:0", "h:1"]).shard_map()
    swapped = JSD.validate_shard_map(good)
    swapped["shards"][0]["shard_id"] = 1
    moved = JSD.validate_shard_map(good)
    moved["shards"][0]["slot_range"] = [0, 5]
    resharded = JSD.validate_shard_map(good)
    resharded["shards"][0]["slot_range"] = [0, 16]
    resharded["shards"][1]["slot_range"] = [16, 64]
    return [good, resharded, None, [], "map", {},
            {**good, "shard_count": 0}, {**good, "shard_count": 3},
            {**good, "shards": good["shards"][:1]},
            {**good, "version": "new"}, swapped, moved,
            {**good, "slots": 1}, {**good, "shards": [1, 2]},
            {**good, "shards": [{**good["shards"][0],
                                 "slot_range": "x"}, good["shards"][1]]}]


@pytest.mark.parametrize("i", range(len(_maps())))
def test_validate_shard_map_equals_jax(i):
    m = _maps()[i]

    def outcome(fn):
        try:
            return fn(m)
        except ValueError as e:
            return ("refused", str(e))

    assert outcome(SD.validate_shard_map) == outcome(JSD.validate_shard_map)
    with pytest.raises(ValueError):
        SD.validate_ranges([(0, 10), (12, 64)], 2)


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _shardinfo_script(info, clock) -> list:
    out = []

    def snap():
        out.append((info.version, info.shard_map(), info.topology(),
                    info.view(), info.my_range(), info.ranges()))

    snap()
    info.note_replica("r:1", 3, 5, metrics="r:9101", tier=1, fetches=10)
    clock.t += 2.0
    info.note_replica("r:2", 4, 5, parent="r:1", tier=2, fetches=0)
    snap()
    clock.t += 4.0
    info.note_replica("r:1", 5, 7, metrics="r:9101", tier=1, fetches=50)
    info.note_replica("r:2", 5, 7, parent=None, tier=1, fetches=8)
    info.note_replica("bad", "x", 7)
    snap()
    clock.t += 31.0
    info.note_replica("r:3", 7, 7)
    snap()
    out.append(info.adopt_ranges([[0, 16], [16, 64]]))
    out.append(info.adopt_ranges([[0, 40], [40, 64]], version=40))
    with pytest.raises(ValueError):
        info.adopt_ranges([[0, 10], [11, 64]])
    out.append(info.owns_slot(39))
    snap()
    return out


def test_shardinfo_script_equals_jax():
    pc, jc = _Clock(), _Clock()
    mine = _shardinfo_script(SD.ShardInfo(0, 2, ["a:1", "b:2"], clock=pc),
                             pc)
    theirs = _shardinfo_script(
        JSD.ShardInfo(0, 2, ["a:1", "b:2"], clock=jc), jc)
    assert mine == theirs
    for bad in ((2, 2, ["a", "b"]), (0, 2, ["a"])):
        with pytest.raises(ValueError):
            SD.ShardInfo(*bad)


# -- the service's shard-primary mode, handler by handler -------------------

SHAPES = {"conv_init/kernel": (3, 3, 3, 4), "bn_init/scale": (4,),
          "layer1_0/conv1/kernel": (3, 3, 4, 4), "head/kernel": (4, 10),
          "head/bias": (10,)}


def _params(names=SHAPES) -> dict:
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(SHAPES.get(k, (4,))).astype(np.float32)
            for k in names}


def _grads(seed: int, names, codec: str) -> dict:
    rng = np.random.default_rng(100 + seed)
    g = {k: (rng.standard_normal(SHAPES.get(k, (4,))) * 0.1).astype(
        np.float32) for k in names}
    return int8_wire_compress(g) if codec == "int8" else g


def _frame_script(sharded: bool) -> list:
    pack, enc = JS.pack_msg, JS.encode_tensor_dict
    keys = list(SHAPES)
    push = lambda wid, seed, tok, step: pack(  # noqa: E731
        {"worker_id": wid, "fetched_step": step, "push_token": tok},
        enc(_grads(seed, keys, "int8"), checksum=True))
    steps = [
        ("register_worker", pack({"worker_name": "w0",
                                  "capabilities": ["directives"]})),
        ("register_worker", pack({"worker_name": "w1"})),
        ("fetch_parameters", pack({"worker_id": 0, "have_qscales": 0})),
        ("fetch_parameters", pack({"worker_id": 0, "have_shard_map": 0})),
        ("push_gradrients", push(0, 1, "n0:1", 0)),
        ("fetch_parameters", pack({"worker_id": 0, "have_step": 1,
                                   "have_shard_map": 1})),
        ("fetch_parameters", pack({"have_step": 0, "replica": {
            "shard_id": 0, "address": "r:1", "metrics": "r:9", "tier": 1,
            "fetches": 3, "descendants": [{"address": "r:2", "step": 0,
                                           "parent": "r:1", "tier": 2}]},
            "have_shard_map": 1, "have_topology": 0})),
        ("fetch_parameters", pack({"worker_id": 1, "have_step": 1,
                                   "have_shard_map": 2,
                                   "have_topology": 2})),
        ("fetch_parameters", pack({"worker_id": 1, "have_shard_map": "x"})),
        ("adopt", None),
        ("push_gradrients", push(1, 2, "n1:1", 1)),
        ("fetch_parameters", pack({"worker_id": 1, "have_shard_map": 2})),
        ("job_finished", pack({"worker_id": 1})),
    ]
    return steps if sharded else [s for s in steps if s[0] != "adopt"]


@pytest.mark.parametrize("sharded", [False, True],
                         ids=["unsharded", "sharded"])
def test_reply_frames_equal_the_jax_service(sharded):
    cfg = dict(mode="async", total_workers=2, push_codec="int8")
    pc, jc = _Clock(), _Clock()
    port_store = ParameterStore(_params(), StoreConfig(**cfg))
    jax_store = JaxStore(_params(), JaxConfig(**cfg))
    port = PS.ParameterService(port_store, sharding=SD.ShardInfo(
        0, 2, ["a:1", "b:2"], clock=pc) if sharded else None)
    jaxs = JS.ParameterService(jax_store, sharding=JSD.ShardInfo(
        0, 2, ["a:1", "b:2"], clock=jc) if sharded else None)
    for rpc, request in _frame_script(sharded):
        if rpc == "adopt":
            # The map moved: this primary now owns [0, 4) only.
            for svc in (port, jaxs):
                svc.sharding.adopt_ranges([[0, 4], [4, 64]])
            continue
        mine = getattr(port, rpc)(request, None)
        theirs = getattr(jaxs, rpc)(request, None)
        assert mine == theirs, (rpc, PS.unpack_msg(mine)[0],
                                JS.unpack_msg(theirs)[0])
    for k, v in jax_store.parameters.items():
        np.testing.assert_array_equal(port_store.parameters[k], v)
    if sharded:
        assert port.sharding.view() == jaxs.sharding.view()


# -- two primaries over localhost gRPC ----------------------------------------

NAMES = [f"layer{i}/kernel" for i in range(6)] + ["head/kernel",
                                                  "head/bias"]


def _primaries(pkg: str, names: list, cfg: dict, n: int = 2):
    """n in-process primaries of ``pkg`` (port or jax) on 127.0.0.1:0,
    each holding its ``partition_keys`` share, their ShardInfos built
    once every port is bound."""
    Store, Config, Svc, Info, serve = (
        (ParameterStore, StoreConfig, PS.ParameterService, SD.ShardInfo,
         PS.serve) if pkg == "port" else
        (JaxStore, JaxConfig, JS.ParameterService, JSD.ShardInfo,
         JS.serve))
    parts = SD.partition_keys(names, n)
    assert all(parts)
    params = _params(names)
    stores, svcs, servers, addrs = [], [], [], []
    for i in range(n):
        store = Store({k: params[k] for k in parts[i]},
                      Config(**cfg, shard_index=i, shard_count=n))
        svc = Svc(store)
        kw = {"host": "127.0.0.1"} if pkg == "port" else {}
        server, port = serve(store, port=0, service=svc, **kw)
        stores.append(store)
        svcs.append(svc)
        servers.append(server)
        addrs.append(f"127.0.0.1:{port}" if pkg == "port"
                     else f"localhost:{port}")
    for i, svc in enumerate(svcs):
        svc.sharding = Info(i, n, addrs)
    return stores, svcs, servers, addrs


def _single(names, cfg):
    store = ParameterStore(_params(names), StoreConfig(**cfg))
    server, port = PS.serve(store, port=0, host="127.0.0.1")
    return store, server, f"127.0.0.1:{port}"


def _assert_union_equal(stores, single):
    union = {}
    for s in stores:
        union.update(s.snapshot()[0])
    ref, _ = single.snapshot()
    assert sorted(union) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(union[k], ref[k], err_msg=k)


#: Scripted (op, worker, grads seed) sequences. A push carries the step
#: its worker last fetched, as PSWorker's do. Async (bound 2): worker 0's
#: push at staleness 2 applies down-weighted, its next at staleness 4 is
#: refused. Sync: two rounds of two workers.
DRIVE = {
    "async": [("fetch", 0, None), ("fetch", 1, None), ("push", 1, 0),
              ("fetch", 1, None), ("push", 1, 1), ("fetch", 1, None),
              ("push", 0, 2), ("push", 1, 3), ("push", 0, 4),
              ("fetch", 0, None)],
    "sync": [("fetch", 0, None), ("fetch", 1, None), ("push", 0, 0),
             ("push", 1, 1), ("fetch", 0, None), ("fetch", 1, None),
             ("push", 1, 2), ("push", 0, 3), ("fetch", 0, None)],
}


def _drive(make_client, addrs, single_addr, mode, codec):
    """One scripted sequence from two workers through the fan-out and
    through RemoteStores against one store; returns each op's outcome
    pair and holds every fetch bit-equal."""
    fan = [make_client(addrs) for _ in range(2)]
    one = [RemoteStore(single_addr, rpc_timeout=RPC_TIMEOUT)
           for _ in range(2)]
    out = []
    try:
        ids = [(f.register_worker(f"w{i}")[0], o.register_worker(
            f"w{i}")[0]) for i, (f, o) in enumerate(zip(fan, one))]
        steps = [0, 0]
        for op, w, seed in DRIVE[mode]:
            if op == "push":
                g = _grads(seed, NAMES, codec)
                out.append((fan[w].push(ids[w][0], g, steps[w]),
                            one[w].push(ids[w][1], g, steps[w])))
                continue
            p1, s1 = fan[w].fetch(ids[w][0])
            p2, s2 = one[w].fetch(ids[w][1])
            out.append((s1, s2))
            steps[w] = s2
            for k in NAMES:
                np.testing.assert_array_equal(p1[k], p2[k])
        nm = fan[0].fetch(ids[0][0], have_step=steps[0])
        out.append(("nm", nm[0] == {}, nm[1]))
        for (f, o), (fi, oi) in zip(zip(fan, one), ids):
            f.job_finished(fi)
            o.job_finished(oi)
    finally:
        for c in fan + one:
            c.close()
    return out


@pytest.mark.parametrize("mode", ["async", "sync"])
@pytest.mark.parametrize("codec", ["none", "int8"])
@pytest.mark.parametrize("pairing", ["port_port", "port_jax", "jax_port"])
def test_sharded_store_is_bit_equal_to_one_store(pairing, codec, mode):
    client_pkg, server_pkg = pairing.split("_")
    cfg = dict(mode=mode, total_workers=2, push_codec=codec,
               staleness_bound=2)
    stores, _, servers, addrs = _primaries(server_pkg, NAMES, cfg)
    single, sserver, saddr = _single(NAMES, cfg)
    Fan = ShardedRemoteStore if client_pkg == "port" \
        else JSH.ShardedRemoteStore
    try:
        out = _drive(lambda a: Fan(a, rpc_timeout=RPC_TIMEOUT), addrs,
                     saddr, mode, codec)
        _assert_union_equal(stores, single)
    finally:
        for s in servers + [sserver]:
            s.stop(grace=None)
    assert all(a == b for a, b in out[:-1]), out
    assert out[-1][1] is True
    if mode == "async":
        pushes = [o for (op, _, _), o in zip(DRIVE["async"], out)
                  if op == "push"]
        assert pushes == [(True, True)] * 4 + [(False, False)]
        assert single.global_step == 4
    else:
        assert single.global_step == 2
    assert [s.global_step for s in stores] == [single.global_step] * 2


def test_sharded_store_grows_from_a_seed_address():
    cfg = dict(mode="async", total_workers=1, push_codec="none")
    stores, _, servers, addrs = _primaries("port", NAMES, cfg)
    fan = ShardedRemoteStore(addrs[0], rpc_timeout=RPC_TIMEOUT)
    try:
        wid, total = fan.register_worker("w")
        assert fan.shard_count == 2 and fan.address == ",".join(addrs)
        assert fan.shard_map["shards"][1]["primary"] == addrs[1]
        params, step = fan.fetch(wid)
        assert step == 0 and sorted(params) == sorted(NAMES)
        assert fan.push(wid, _grads(0, NAMES, "none"), 0)
        assert [s.global_step for s in stores] == [1, 1]
        assert fan.wire_stats()["rpc_counts"]["PushGradrients"] == 2
        fan.job_finished(wid)
    finally:
        fan.close()
        for s in servers:
            s.stop(grace=None)


def _slot_key(lo, hi, taken=()):
    i = 0
    while True:
        k = f"mig{i}/kernel"
        if lo <= SD.key_slot(k) < hi and k not in taken:
            return k
        i += 1


@pytest.mark.parametrize("mode", ["async", "sync"])
def test_disowned_slice_rerouted_once_in_async_dropped_in_sync(mode):
    """The map moves under the client (slots [16, 32) go from shard 0 to
    shard 1, the tensor with them): the donor disowns the moved key and
    names it beside its fresh map; async re-routes it once to the new
    owner, sync drops it (a second push would double-report the worker
    into the new owner's round). Applied at most once, never on both."""
    stay0, moved, stay1 = _slot_key(0, 16), _slot_key(16, 32), \
        _slot_key(32, 64)
    names = [stay0, moved, stay1]
    cfg = dict(mode=mode, total_workers=1, push_codec="none")
    params = _params(names)
    stores, svcs, servers, addrs = [], [], [], []
    for i, keys in enumerate([[stay0, moved], [stay1]]):
        store = ParameterStore({k: params[k] for k in keys},
                               StoreConfig(**cfg, shard_index=i,
                                           shard_count=2))
        svc = PS.ParameterService(store)
        server, port = PS.serve(store, port=0, service=svc,
                                host="127.0.0.1")
        stores.append(store)
        svcs.append(svc)
        servers.append(server)
        addrs.append(f"127.0.0.1:{port}")
    for i, svc in enumerate(svcs):
        svc.sharding = SD.ShardInfo(i, 2, addrs)
    fan = ShardedRemoteStore(addrs, rpc_timeout=RPC_TIMEOUT)
    try:
        wid, _ = fan.register_worker("w")
        stale = fan.shard_map["version"]
        # The handoff, server side, while the client keeps its cached map.
        handed, _ = stores[0].export_params([moved])
        stores[1].adopt_params(handed)
        stores[0].drop_params([moved])
        for svc in svcs:
            svc.sharding.adopt_ranges([[0, 16], [16, 64]])
        before = stores[1].snapshot()[0][moved]
        disowned = svcs[0]._tm_disowned.value
        grads = {k: np.full(SHAPES.get(k, (4,)), 0.5, np.float32)
                 for k in names}
        assert fan.push(wid, grads, 0)
        assert fan.shard_map["version"] > stale
        assert moved not in stores[0].parameters
        assert [s.global_step for s in stores] == [1, 1 if mode == "sync"
                                                   else 2]
        ref = ParameterStore({moved: before}, StoreConfig(**cfg))
        ref.register_worker()
        ref.push(0, {moved: grads[moved]}, 0)
        after = stores[1].snapshot()[0][moved]
        if mode == "async":
            np.testing.assert_array_equal(after, ref.parameters[moved])
        else:
            np.testing.assert_array_equal(after, before)
        # The next push routes on the adopted map: no disowned trip.
        pushes = fan.wire_stats()["rpc_counts"]["PushGradrients"]
        assert fan.push(wid, grads, 1)
        assert fan.wire_stats()["rpc_counts"]["PushGradrients"] \
            == pushes + 2
        assert svcs[0]._tm_disowned.value - disowned == 1
    finally:
        fan.close()
        for s in servers:
            s.stop(grace=None)


def _tiny_model(name="resnet18", num_classes=10, device="cpu", **kw):
    return models.ResNet(stage_sizes=(1, 1), num_filters=8,
                         num_classes=num_classes).to(device)


@pytest.fixture
def small(monkeypatch):
    """A tiny ResNet for ``get_model`` and 16 synthetic images for the
    CLI's dataset: what the CLI tests check is the wiring, not a run."""
    monkeypatch.setattr(models, "get_model", _tiny_model)
    monkeypatch.setattr(cli, "_load_dataset",
                        lambda args: synthetic_cifar100(8, 8, 10, seed=0))


def test_cross_shard_restore_is_refused(tmp_path, small):
    cfg = dict(mode="sync", total_workers=1, push_codec="none")
    store0 = ParameterStore({"w": np.ones(4, np.float32)},
                            StoreConfig(**cfg, shard_index=0, shard_count=2))
    save_store(store0, str(tmp_path),
               journal_fn=PS.ParameterService(store0).journal_snapshot)
    other = ParameterStore({"w": np.ones(4, np.float32)},
                           StoreConfig(**cfg, shard_index=1, shard_count=2))
    with pytest.raises(ValueError, match="refusing a cross-shard"):
        restore_server_state(other, PS.ParameterService(other),
                             str(tmp_path))
    step, _ = restore_server_state(store0, PS.ParameterService(store0),
                                   str(tmp_path))
    assert step == 0
    # Through the CLI: shard 1 of 2 refuses shard 0's snapshot.
    with pytest.raises(ValueError, match="refusing a cross-shard"):
        cli.main(["serve", "--shard-count", "2", "--shard-index", "1",
                  "--shard-peers", "a:1,b:2", "--checkpoint-dir",
                  str(tmp_path), "--restore", "--no-health-monitor",
                  "--port", "0"])


# -- the CLI: cli serve --shard-* and cli worker --shards ---------------------

def _free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_cli_two_shard_primaries_and_a_sharded_worker(capsys, small):
    """Two ``cli serve --shard-count 2`` primaries in threads, each
    holding its ``partition_keys`` share of the model, and one ``cli
    worker --shards`` on the CPU for one int8 step: both primaries apply
    it and exit when the worker finishes."""
    ports = _free_ports(2)
    peers = ",".join(f"127.0.0.1:{p}" for p in ports)
    rcs = [None, None]

    def serve(i):
        rcs[i] = cli.main(["serve", "--mode", "async", "--workers", "1",
                           "--push-codec", "int8", "--shard-count", "2",
                           "--shard-index", str(i), "--shard-peers", peers,
                           "--port", str(ports[i]), "--num-classes", "10",
                           "--no-health-monitor", "--emit-metrics"])

    threads = [threading.Thread(target=serve, args=(i,), daemon=True)
               for i in range(2)]
    for t in threads:
        t.start()
    rc = cli.main(["worker", "--shards", peers, "--synthetic",
                   "--batch-size", "8", "--epochs", "1", "--device",
                   "cpu", "--emit-metrics"])
    for t in threads:
        t.join(timeout=60)
    assert rc == 0 and rcs == [0, 0]
    out = capsys.readouterr()
    names = list(params_to_jax(_tiny_model())[0])
    for i in range(2):
        owned = len(SD.partition_keys(names, 2)[i])
        assert f"shard {i}/2: owning {owned}/{len(names)} of the " \
               f"model's tensors" in out.err
        assert f"shard={i}/2" in out.err
    assert out.out.count('"global_steps_completed": 1') == 2
    assert '"PushGradrients": 2' in out.out


@pytest.mark.parametrize("argv,message", [
    (["serve", "--shard-count", "2", "--shard-peers", "a:1"],
     "--shard-peers must list exactly --shard-count=2 addresses"),
    (["serve", "--shard-count", "2", "--shard-index", "2",
      "--shard-peers", "a:1,b:2"], "--shard-index 2 out of range"),
    (["serve", "--store-backend", "native", "--push-codec", "int4"],
     "the native backend speaks none|fp16|int8"),
    (["serve", "--store-backend", "native", "--mode", "sync",
      "--sync-quorum", "1"], "the C++ arena runs its own round loop"),
], ids=["peers", "index", "arena_codec", "arena_quorum"])
def test_cli_serve_refusals_are_jax_words(argv, message):
    with pytest.raises(SystemExit, match=re.escape(message)):
        cli.main(argv + ["--no-health-monitor"])
