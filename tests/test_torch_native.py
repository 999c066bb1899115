"""The port's C++ arena (``…_torch/native/``) against the JAX package's.

The port builds the library from the repo's ``native/ps_core.cpp`` into
``build/torch_native/`` and never touches the tracked
``native/libps_core.so``, which the JAX package loads. Both bind the same
source, so the two packages' ``NativeParameterStore`` must agree bit for
bit: one scripted sequence of pushes, fetches and membership calls goes
into the JAX arena store, the port's and the port's NumPy
``ParameterStore``, and every return and every parameter is compared bit
for bit. One exception, by construction: an async int8 push applies
``p -= (lr·w·scale)·q`` in the arena and ``p -= (lr·w)·(q·scale)`` in the
NumPy store, so there the NumPy store is held to the JAX suite's
tolerance (rtol 1e-6 / atol 1e-7). The fp16 and bf16 casts equal NumPy's
and ``ml_dtypes``' on every finite value, and ``metrics()`` has the JAX
store's keys.
"""

import hashlib
import subprocess

import ml_dtypes
import numpy as np
import pytest

from distributed_parameter_server_for_ml_training_tpu.native import \
    NativeParameterStore as JaxNative
from distributed_parameter_server_for_ml_training_tpu.ps.store import \
    StoreConfig as JaxConfig
from distributed_parameter_server_for_ml_training_tpu_torch.native import \
    NativeParameterStore, bindings as B
from distributed_parameter_server_for_ml_training_tpu_torch.ops \
    .compression import fp16_compress, int8_wire_compress
from distributed_parameter_server_for_ml_training_tpu_torch.ps import \
    make_store
from distributed_parameter_server_for_ml_training_tpu_torch.ps.store \
    import ParameterStore, StoreConfig

REPO = B.REPO

#: A few ResNet-18 names at tiny shapes.
SHAPES = {"conv_init/kernel": (3, 3, 3, 4), "bn_init/scale": (4,),
          "bn_init/bias": (4,), "layer1_0/conv1/kernel": (3, 3, 4, 4),
          "head/kernel": (4, 10), "head/bias": (10,)}


def _params() -> dict:
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(seed: int) -> dict:
    rng = np.random.default_rng(100 + seed)
    return {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
            for k, s in SHAPES.items()}


def _payload(seed: int, codec: str) -> dict:
    g = _grads(seed)
    if codec == "fp16":
        return fp16_compress(g)
    if codec == "int8":
        return int8_wire_compress(g)
    return g


def _tracked_digest() -> str:
    return hashlib.sha256(
        (REPO / "native" / "libps_core.so").read_bytes()).hexdigest()


def test_arena_is_built_into_build_torch_native():
    before = _tracked_digest()
    lib = B.load_library()
    assert B.LIBRARY.parent == REPO / "build" / "torch_native"
    assert B.LIBRARY.is_file()
    assert B._STAMP.read_text().strip() == B._digest()
    assert all(hasattr(lib, s) for s in B._REQUIRED_SYMBOLS)
    assert B.build() == B.LIBRARY          # up to date: no rebuild
    assert _tracked_digest() == before
    status = subprocess.run(["git", "status", "--porcelain", "native/"],
                            cwd=REPO, capture_output=True, text=True)
    assert status.returncode == 0 and status.stdout == ""


def test_a_failed_build_raises_naming_the_compiler_error(monkeypatch,
                                                         tmp_path):
    bad = tmp_path / "ps_core.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(B, "SOURCE", bad)
    monkeypatch.setattr(B, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(B, "LIBRARY", tmp_path / "out" / "libps_core.so")
    monkeypatch.setattr(B, "_STAMP", tmp_path / "out" / "stamp")
    with pytest.raises(RuntimeError, match=r"(?s)building the C\+\+ arena "
                       r"failed.*error: expected unqualified-id"):
        B.build()
    monkeypatch.setenv("DPS_NATIVE_LIB", str(tmp_path / "missing.so"))
    with pytest.raises(RuntimeError, match="DPS_NATIVE_LIB"):
        B.library_path()


def _cast_inputs() -> np.ndarray:
    rng = np.random.default_rng(3)
    special = np.array([0.0, -0.0, 1.0, -1.0, 65504.0, 65520.0, 1e-8,
                        6e-8, 5.96e-8, 2.98e-8, 6.1e-5, 1e30, -1e30,
                        np.inf, -np.inf, 1.00048828125, 1.001953125,
                        3.4e38], np.float32)
    bits = rng.integers(0, 2 ** 32, 20000, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    return np.concatenate([special, rng.standard_normal(5000).astype(
        np.float32) * 1e3, rng.standard_normal(5000).astype(np.float32)
        * 1e-6, bits[np.isfinite(bits)]])


def test_fp16_cast_equals_numpy():
    x = _cast_inputs()
    ours = B.fp32_to_fp16(x)
    np.testing.assert_array_equal(ours.view(np.uint16),
                                  x.astype(np.float16).view(np.uint16))
    h = x.astype(np.float16)
    finite = np.isfinite(h)
    np.testing.assert_array_equal(B.fp16_to_fp32(h)[finite],
                                  h.astype(np.float32)[finite])


def test_bf16_cast_equals_ml_dtypes():
    x = _cast_inputs()
    ours = B.fp32_to_bf16(x)
    np.testing.assert_array_equal(
        ours.view(np.uint16), x.astype(ml_dtypes.bfloat16).view(np.uint16))
    b = x.astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(B.bf16_to_fp32(b), b.astype(np.float32))


#: (config, [(op, args)]) scripts. ``push`` args: worker, grads seed,
#: fetched step, codec; ``register``/``finish``: worker.
SCRIPTS = {
    "async_fp32": (dict(mode="async", total_workers=2, push_codec="none",
                        staleness_bound=2),
                   [("push", 0, 0, 0, "none"), ("push", 1, 1, 0, "none"),
                    ("push", 0, 2, 1, "none"), ("push", 1, 3, 0, "none"),
                    ("push", 0, 4, 3, "none")]),
    "async_fp16": (dict(mode="async", total_workers=2, push_codec="fp16",
                        staleness_bound=5),
                   [("push", 0, 0, 0, "fp16"), ("push", 1, 1, 0, "fp16"),
                    ("push", 0, 2, 1, "fp16"), ("push", 1, 3, 2, "fp16"),
                    ("push", 0, 4, 0, "fp16")]),
    "async_int8": (dict(mode="async", total_workers=2, push_codec="int8",
                        staleness_bound=1),
                   [("push", 0, 0, 0, "int8"), ("push", 1, 1, 0, "int8"),
                    ("push", 0, 2, 0, "int8"), ("push", 1, 3, 2, "int8"),
                    ("push", 0, 4, 3, "none")]),
    "sync_fp16": (dict(mode="sync", total_workers=2, push_codec="fp16"),
                  [("push", w, 10 * r + w, r, "fp16")
                   for r in range(3) for w in range(2)]),
    # The arena decodes each push on arrival, as the NumPy store does
    # without its compressed-domain rounds.
    "sync_int8": (dict(mode="sync", total_workers=2, push_codec="int8",
                       compressed_domain=False),
                  [("push", w, 10 * r + w, r, "int8")
                   for r in range(2) for w in range(2)]),
    "sync_double_push": (dict(mode="sync", total_workers=2,
                              push_codec="none"),
                         [("push", 0, 1, 0, "none"), ("push", 0, 2, 0,
                                                      "none"),
                          ("push", 1, 3, 1, "none")]),
    "sync_strict": (dict(mode="sync", total_workers=2, push_codec="none",
                         strict_rounds=True),
                    [("push", 0, 1, 0, "none"), ("push", 0, 2, 0, "none"),
                     ("push", 1, 3, 0, "none")]),
    "sync_elastic_departure": (dict(mode="sync", total_workers=3,
                                    push_codec="none", elastic=True,
                                    strict_rounds=True),
                               [("register", 0), ("register", 1),
                                ("register", 2), ("push", 0, 1, 0, "none"),
                                ("push", 1, 2, 0, "none"),
                                ("finish", 2), ("push", 0, 3, 1, "none"),
                                ("finish", 1), ("push", 0, 4, 2, "none")]),
}


def _run(store, script) -> list:
    out = []
    for op, *args in script:
        if op == "register":
            out.append(store.register_worker(f"w{args[0]}"))
        elif op == "finish":
            out.append(store.job_finished(args[0]))
        else:
            wid, seed, fetched, codec = args
            out.append(store.push(wid, _payload(seed, codec), fetched))
        out.append(store.global_step)
    return out


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scripted_sequences_equal_the_jax_arena(name):
    cfg, script = SCRIPTS[name]
    jax_store = JaxNative(_params(), JaxConfig(**cfg))
    port = NativeParameterStore(_params(), StoreConfig(**cfg))
    host = ParameterStore(_params(), StoreConfig(**cfg))
    got = _run(port, script)
    assert got == _run(jax_store, script) == _run(host, script)
    mine, step = port.snapshot()
    theirs, jstep = jax_store.snapshot()
    assert step == jstep == host.global_step
    assert list(mine) == list(theirs)
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
        if name == "async_int8":
            np.testing.assert_allclose(mine[k], host.parameters[k],
                                       rtol=1e-6, atol=1e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(mine[k], host.parameters[k],
                                          err_msg=k)
    pm, jm = port.metrics(), jax_store.metrics()
    assert list(pm) == list(jm)
    for key in ("mode", "store_backend", "global_steps_completed",
                "total_parameter_updates", "gradients_processed",
                "gradients_rejected", "max_staleness", "average_staleness"):
        assert pm.get(key) == jm.get(key), key


@pytest.mark.parametrize("codec", ["none", "fp16", "bf16"])
def test_fetch_codecs_equal_the_jax_arena(codec):
    cfg = dict(mode="async", total_workers=1, fetch_codec=codec)
    port = NativeParameterStore(_params(), StoreConfig(**cfg))
    jax_store = JaxNative(_params(), JaxConfig(**cfg))
    host = ParameterStore(_params(), StoreConfig(**cfg))
    for s in (port, jax_store, host):
        s.push(0, fp16_compress(_grads(7)), 0)
    mine, step = port.fetch(0)
    theirs, jstep = jax_store.fetch(0)
    ref, hstep = host.fetch(0)
    assert step == jstep == hstep == 1
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(mine[k].view(np.uint8),
                                      theirs[k].view(np.uint8), err_msg=k)
        np.testing.assert_array_equal(mine[k].view(np.uint8),
                                      ref[k].view(np.uint8), err_msg=k)


def test_metrics_keys_equal_the_jax_arena():
    for mode in ("sync", "async"):
        port = NativeParameterStore(_params(), StoreConfig(mode=mode))
        jax_store = JaxNative(_params(), JaxConfig(mode=mode))
        assert list(port.metrics()) == list(jax_store.metrics())
        assert port.metrics()["store_backend"] == "native"


def test_membership_and_rejections_equal_the_jax_arena():
    """Elastic expiry releases a dead worker's slot and completes the
    round; a mis-sized int8 push is refused before the kernel; a stale
    snapshot load round-trips."""
    cfg = dict(mode="sync", total_workers=2, push_codec="int8",
               elastic=True, worker_timeout=1e-9)
    out = {}
    for name, store in (("port", NativeParameterStore(
            _params(), StoreConfig(**cfg))),
                        ("jax", JaxNative(_params(), JaxConfig(**cfg)))):
        w0, _ = store.register_worker("a")
        w1, _ = store.register_worker("b")
        store.push(w0, _payload(1, "int8"), 0)
        store.last_seen[w1] = 0.0
        store.last_seen[w0] = float("inf")
        expired = store.expire_stale_workers()
        bad = _payload(2, "int8")
        bad["head/bias"] = bad["head/bias"][:-3]
        rejected = store.push(w0, bad, 1)
        snap, step = store.snapshot()
        store.load_snapshot(snap, step + 5)
        out[name] = (expired, store.global_step, rejected,
                     store.membership_snapshot(), sorted(store._slot_of),
                     store.snapshot()[0])
    assert out["port"][:5] == out["jax"][:5] == ([1], 6, False, [0], [0])
    for k in SHAPES:
        np.testing.assert_array_equal(out["port"][5][k], out["jax"][5][k])


def test_make_store_builds_the_arena():
    store = make_store("native", _params(), StoreConfig(mode="async"))
    assert isinstance(store, NativeParameterStore)
    assert store.store_backend == "native" and store.push_codec == "fp16"
    with pytest.raises(ValueError, match="none|fp16|int8"):
        make_store("native", _params(), StoreConfig(mode="async",
                                                    push_codec="int4"))


def test_async_int8_apply_is_the_arena_order_in_numpy():
    """An async int8 push applies ``p - ((lr·w)·scale)·q`` in fp32, the
    order ``ps_core.cpp`` computes it in: bit for bit, stale pushes
    (down-weighted) included."""
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import \
        staleness_weight
    cfg = dict(mode="async", total_workers=2, push_codec="int8",
               staleness_bound=3)
    store = NativeParameterStore(_params(), StoreConfig(**cfg))
    replica = _params()
    for seed, fetched in ((0, 0), (1, 0), (2, 1), (3, 0)):
        payload = _payload(seed, "int8")
        staleness = store.global_step - fetched
        assert store.push(0, payload, fetched)
        lrw = np.float32(float(np.float32(0.1)) * staleness_weight(staleness))
        for k in replica:
            scale = np.float32(lrw * payload[k + "::int8scale"][0])
            replica[k] = replica[k] - scale * payload[k].astype(np.float32)
    got, step = store.snapshot()
    assert step == 4
    for k in replica:
        np.testing.assert_array_equal(got[k], replica[k], err_msg=k)
