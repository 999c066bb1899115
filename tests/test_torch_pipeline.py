"""The port's pipeline schedules (``parallel/pipeline.py``: S stage slots
on one device) against the JAX package's (S virtual CPU devices under
``shard_map``): the 1F1B tables equal over a grid of (S, M); GPipe and
1F1B losses and gradients against JAX's and each other's (fp32, rtol
2e-4 / atol 1e-6 as the JAX tests hold their two schedules, the products
summed in another order); the pipeline against the stages run in
sequence; the homogeneous-stage and ``shard_io`` errors. dp x pp: the
pipeline over a ``(data, stage)`` mesh, each microbatch split over the
data slots, against JAX's ``data_axis`` pipeline on 2 x 4 devices, its
forward and its gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_parameter_server_for_ml_training_tpu.parallel import \
    make_mesh as jax_make_mesh
from distributed_parameter_server_for_ml_training_tpu.parallel import \
    pipeline as jpipe
from distributed_parameter_server_for_ml_training_tpu_torch.parallel import \
    pipeline as pipe
from distributed_parameter_server_for_ml_training_tpu_torch.parallel.mesh \
    import STAGE_AXIS, make_mesh, mesh_from_shape
from torch_threads import one_torch_thread_per_module  # noqa: F401

S, D = 4, 16


def _np_params(seed):
    r = np.random.default_rng(seed)
    return {"w": r.normal(scale=0.5, size=(D, D)).astype(np.float32),
            "b": r.normal(scale=0.1, size=(D,)).astype(np.float32)}


@pytest.fixture(scope="module")
def stacked_np():
    per = [_np_params(i) for i in range(S)]
    return {k: np.stack([p[k] for p in per]) for k in ("w", "b")}


def _jstage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _tstage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def _jl2(y_pred, y):
    return jnp.mean((y_pred - y) ** 2)


def _tl2(y_pred, y):
    return torch.mean((y_pred - y) ** 2)


def _mesh(n=S):
    return make_mesh(n, "cpu", axis_names=(STAGE_AXIS,))


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _data(b, seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=(b, D)).astype(np.float32),
            (r.normal(size=(b, D)) * 0.5).astype(np.float32))


@pytest.mark.parametrize("s,m", [(1, 1), (2, 1), (2, 4), (3, 7), (4, 4),
                                 (4, 8), (5, 3), (4, 16)])
def test_1f1b_tables_equal_jax(s, m):
    want = jpipe.build_1f1b_schedule(s, m)
    got = pipe.build_1f1b_schedule(s, m)
    assert got["ticks"] == want["ticks"] == 2 * (s + m - 1)
    for k in ("act", "mb", "fwd_in", "bwd_in"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("m", [4, 8])
def test_schedules_match_jax_and_each_other(devices, stacked_np, m):
    x, y = _data(2 * m, 3)
    jmesh = jax_make_mesh(S, axis_names=("stage",))
    jstacked = {k: jnp.asarray(v) for k, v in stacked_np.items()}
    want = {}
    for sched in ("gpipe", "1f1b"):
        loss, grads = jpipe.make_pipeline_train_step(
            jmesh, _jstage, _jl2, m, schedule=sched)(
            jstacked, jnp.asarray(x), jnp.asarray(y))
        want[sched] = (float(loss), {k: np.asarray(v)
                                     for k, v in grads.items()})
    got = {}
    for sched in ("gpipe", "1f1b"):
        loss, grads = pipe.make_pipeline_train_step(
            _mesh(), _tstage, _tl2, m, schedule=sched)(
            _torch(stacked_np), torch.from_numpy(x), torch.from_numpy(y))
        assert set(grads) == {"w", "b"} and grads["w"].shape == (S, D, D)
        got[sched] = (float(loss), {k: v.numpy() for k, v in grads.items()})
    for sched in ("gpipe", "1f1b"):
        for other in ("gpipe", "1f1b"):
            np.testing.assert_allclose(got[sched][0], want[other][0],
                                       rtol=1e-5, atol=1e-7)
            for k in ("w", "b"):
                np.testing.assert_allclose(got[sched][1][k],
                                           want[other][1][k], rtol=2e-4,
                                           atol=1e-6, err_msg=(sched, k))
    np.testing.assert_allclose(got["gpipe"][0], got["1f1b"][0], rtol=1e-6)
    for k in ("w", "b"):
        np.testing.assert_allclose(got["gpipe"][1][k], got["1f1b"][1][k],
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("m,shard_io,remat", [(8, None, True), (1, None,
                                                                True),
                                              (8, True, False)])
def test_pipeline_matches_sequential(stacked_np, m, shard_io, remat):
    """Outputs and gradients (in the params and the input) of the
    pipeline equal the stages applied in sequence, whatever the
    microbatch count, ``shard_io`` and ``remat``."""
    x, target = _data(32 if m > 1 else 4, 9)
    apply = pipe.make_pipeline_apply(_mesh(), _tstage, m, shard_io=shard_io,
                                     remat=remat)

    def run(fn):
        params = {k: v.requires_grad_() for k, v in
                  _torch(stacked_np).items()}
        xx = torch.from_numpy(x).requires_grad_()
        out = fn(params, xx)
        ((out - torch.from_numpy(target)) ** 2).mean().backward()
        return [out.detach(), params["w"].grad, params["b"].grad, xx.grad]

    def sequential(params, xx):
        for s in range(S):
            xx = _tstage({k: v[s] for k, v in params.items()}, xx)
        return xx

    for a, b in zip(run(apply), run(sequential)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_forward_matches_jax(devices, stacked_np):
    x, _ = _data(32, 11)
    want = jpipe.make_pipeline_apply(
        jax_make_mesh(S, axis_names=("stage",)), _jstage, 8)(
        {k: jnp.asarray(v) for k, v in stacked_np.items()}, jnp.asarray(x))
    got = pipe.make_pipeline_apply(_mesh(), _tstage, 8)(
        _torch(stacked_np), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_data_axis_matches_jax(devices, stacked_np):
    """dp 2 x 4 stages x 4 microbatches of 8 (4 rows a data slot):
    forward and the gradients of the params and x against JAX's, within
    the schedules' rtol 2e-4 / atol 1e-6 (module notes)."""
    from jax.sharding import Mesh

    x, y = _data(32, 12)
    jmesh = Mesh(np.array(jax.devices()).reshape(2, S), ("data", "stage"))
    japply = jpipe.make_pipeline_apply(jmesh, _jstage, 4, data_axis="data")

    def jloss(p, xx):
        return _jl2(japply(p, xx), jnp.asarray(y))

    jp = {k: jnp.asarray(v) for k, v in stacked_np.items()}
    want = japply(jp, jnp.asarray(x))
    want_g = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    mesh = mesh_from_shape({"data": 2, "stage": S}, "cpu")
    apply = pipe.make_pipeline_apply(mesh, _tstage, 4, data_axis="data")
    params = {k: v.requires_grad_() for k, v in _torch(stacked_np).items()}
    xt = torch.from_numpy(x).requires_grad_()
    got = apply(params, xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-4, atol=1e-6)
    _tl2(got, torch.from_numpy(y)).backward()
    for k in params:
        np.testing.assert_allclose(params[k].grad.numpy(),
                                   np.asarray(want_g[0][k]), rtol=2e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g[1]),
                               rtol=2e-4, atol=1e-6)
    with pytest.raises(ValueError, match="does not split over 2 data"):
        apply(params, torch.zeros(12, D))      # microbatches of 3


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_heterogeneous_stage_fn_raises_clear_error(stacked_np, schedule):
    x = torch.ones(16, D)
    y = torch.ones(16, D)

    def widening(params, xb):
        h = _tstage(params, xb)
        return torch.cat([h, h], dim=-1)

    def casting(params, xb):
        return _tstage(params, xb).to(torch.bfloat16)

    for fn in (widening, casting):
        step = pipe.make_pipeline_train_step(_mesh(), fn, _tl2, 4,
                                             schedule=schedule)
        with pytest.raises(ValueError, match="homogeneous"):
            step(_torch(stacked_np), x, y)
    loss, _ = pipe.make_pipeline_train_step(_mesh(), _tstage, _tl2, 4,
                                            schedule=schedule)(
        _torch(stacked_np), x, y)
    assert np.isfinite(float(loss))


def test_errors_and_refusals():
    with pytest.raises(ValueError, match="divisible"):
        pipe.make_pipeline_apply(_mesh(), _tstage, 6, shard_io=True)
    pipe.make_pipeline_apply(_mesh(), _tstage, 6)         # default: off
    with pytest.raises(ValueError, match="1f1b"):
        pipe.make_pipeline_train_step(_mesh(), _tstage, _tl2, 4,
                                      schedule="1f1b", remat=False)
    with pytest.raises(ValueError, match="gpipe"):
        pipe.make_pipeline_train_step(_mesh(), _tstage, _tl2, 4,
                                      schedule="zigzag")
    # Item 10's third part: the three-axis mesh and the data axis build;
    # make_mesh keeps JAX's rule of at most two axes.
    mesh = mesh_from_shape({"data": 1, "model": 2, "stage": S}, "cpu")
    assert mesh.shape == {"data": 1, "model": 2, "stage": S}
    assert callable(pipe.make_pipeline_apply(mesh, _tstage, 4,
                                             data_axis="data"))
    with pytest.raises(ValueError, match="one or two axes"):
        make_mesh(S, "cpu", axis_names=("data", "model", "stage"))


def test_stack_stage_params_nested():
    per = [{"a": {"w": torch.full((2, 3), float(s))}, "b": torch.ones(3) * s}
           for s in range(3)]
    stacked = pipe.stack_stage_params(per)
    assert stacked["a"]["w"].shape == (3, 2, 3)
    assert stacked["b"][:, 0].tolist() == [0.0, 1.0, 2.0]
    views = pipe._stages(stacked, 3)
    assert views[2]["a"]["w"].equal(per[2]["a"]["w"])
