"""The port's grad/eval steps and augmentation against the JAX package.

Gradients in flax layout agree to atol 1e-5 / rtol 1e-4 in fp32 (the
frameworks order the convolution sums differently); the augmentation,
fed the draws ``jax.random`` made, is bit-equal. The ``local_sgd`` fused
step agrees with the JAX fused step to the same tolerance, and given
its own gradients it applies ``p - lr * g`` bit-equal to the JAX step's
jitted update on the CPU (one rounding: XLA's CPU backend contracts it
into a fused multiply-add); on the card it is held to ``make_grad_step``
plus the same update (``cuda`` marker)."""

import jax
import numpy as np
import pytest
import torch

from distributed_parameter_server_for_ml_training_tpu.data.cifar import \
    augment_batch as jax_augment_batch
from distributed_parameter_server_for_ml_training_tpu.models import \
    ResNet as JaxResNet
from distributed_parameter_server_for_ml_training_tpu.train.steps import (
    make_eval_step as jax_make_eval_step,
    make_fused_local_step as jax_make_fused_local_step,
    make_grad_step as jax_make_grad_step)
from distributed_parameter_server_for_ml_training_tpu.train.train_state \
    import TrainState
from distributed_parameter_server_for_ml_training_tpu.utils.pytree import (
    flatten_params as jax_flatten, unflatten_params as jax_unflatten)
from distributed_parameter_server_for_ml_training_tpu_torch.data import (
    augment_batch, augment_with_draws, normalize)
from distributed_parameter_server_for_ml_training_tpu_torch.models import \
    ResNet
from distributed_parameter_server_for_ml_training_tpu_torch.train.steps \
    import make_eval_step, make_fused_local_step, make_grad_step

LOCAL_LR = float(np.float32(0.05))


@pytest.fixture(scope="module")
def setup():
    jm = JaxResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)
    v = jm.init(jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32),
                train=False)
    params = jax_flatten(v["params"])
    stats = jax_flatten(v["batch_stats"])
    r = np.random.default_rng(0)
    x = r.integers(0, 255, (16, 32, 32, 3), dtype=np.uint8)
    y = (np.arange(16) % 10).astype(np.int32)
    tm = ResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)
    return jm, params, stats, x, y, tm


def test_grad_step_matches_jax(setup):
    jm, params, stats, x, y, tm = setup
    jstep = jax_make_grad_step(jm, augment=False)
    jg, jstats, jloss, jacc = jstep(jax_unflatten(params),
                                    jax_unflatten(stats), x, y,
                                    jax.random.PRNGKey(1), 0)
    jg, jstats = jax_flatten(jg), jax_flatten(jstats)
    step = make_grad_step(tm, augment=False)
    g, s, loss, acc = step(params, stats, x, y)
    assert list(g) == list(params)
    for k in jg:
        assert g[k].shape == jg[k].shape and g[k].is_contiguous()
        np.testing.assert_allclose(g[k].numpy(), jg[k], atol=1e-5,
                                   rtol=1e-4, err_msg=k)
    for k in jstats:
        np.testing.assert_allclose(s[k].numpy(), jstats[k], atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(acc) == pytest.approx(float(jacc))


def test_grad_step_does_not_keep_state_between_calls(setup):
    """The step is a function of what it is given: the same inputs give
    the same outputs whatever ran in between."""
    _, params, stats, x, y, tm = setup
    step = make_grad_step(tm, augment=False)
    g1, s1, _, _ = step(params, stats, x, y)
    step(params, s1, x[::-1].copy(), y)
    g2, s2, _, _ = step(params, stats, x, y)
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k
    for k in s1:
        assert torch.equal(s1[k], s2[k]), k


def test_eval_step_counts_the_same(setup):
    jm, params, stats, x, y, tm = setup
    state = TrainState.create(apply_fn=jm.apply,
                              params=jax_unflatten(params),
                              batch_stats=jax_unflatten(stats),
                              tx=__import__("optax").identity())
    jc, jt = jax_make_eval_step()(state, x, y)
    c, t = make_eval_step(tm)(params, stats, x, y)
    assert int(c) == int(jc) and t == int(jt) == 16


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_with_jax_draws_is_bit_equal(seed):
    r = np.random.default_rng(seed)
    x = r.integers(0, 255, (12, 32, 32, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(seed)
    # The draws augment_batch makes (data/cifar.py:302-315).
    k_crop, k_flip = jax.random.split(key)
    offsets = np.asarray(jax.random.randint(k_crop, (12, 2), 0, 9))
    flip = np.asarray(jax.random.bernoulli(k_flip, 0.5, (12,)))
    want = np.asarray(jax_augment_batch(key, x))
    got = augment_with_draws(torch.from_numpy(x), torch.from_numpy(offsets),
                             torch.from_numpy(flip))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_augment_batch_draws_from_the_generator():
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (8, 32, 32, 3), dtype=np.uint8))
    a = augment_batch(x, torch.Generator().manual_seed(5))
    b = augment_batch(x, torch.Generator().manual_seed(5))
    c = augment_batch(x, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == x.shape


def test_normalize_matches_jax():
    from distributed_parameter_server_for_ml_training_tpu.data.cifar import \
        normalize as jax_normalize
    x = np.random.default_rng(0).integers(0, 255, (4, 32, 32, 3),
                                          dtype=np.uint8)
    np.testing.assert_allclose(normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_normalize(x)), atol=1e-6)


def _tensors(flat: dict, device="cpu") -> dict:
    return {k: torch.tensor(np.asarray(v), device=device)
            for k, v in flat.items()}


def _fused_inputs(setup, device="cpu"):
    _, params, stats, x, y, tm = setup
    rng = np.random.default_rng(3)
    accum = {k: (rng.standard_normal(v.shape) * 1e-3).astype(np.float32)
             for k, v in params.items()}
    return (_tensors(params, device), _tensors(accum, device),
            _tensors(stats, device), accum)


def test_fused_local_step_matches_jax(setup):
    """Params, accumulator and batch statistics after one fused step
    agree with the JAX fused step's to atol 1e-5 / rtol 1e-4; the port
    updates the given tensors in place (the JAX step donates them)."""
    jm, params, stats, x, y, tm = setup
    p, a, bs, accum = _fused_inputs(setup)
    jout = jax_make_fused_local_step(jm, augment=False)(
        jax_unflatten(params), jax_unflatten(accum), jax_unflatten(stats),
        x, y, jax.random.PRNGKey(1), 0, np.float32(LOCAL_LR))
    jp, ja, js = (jax_flatten(t) for t in jout[:3])
    ids = {k: v.data_ptr() for k, v in {**p, **a}.items()}
    out = make_fused_local_step(tm, augment=False)(p, a, bs, x, y, None,
                                                   LOCAL_LR)
    assert out[0] is p and out[1] is a and out[2] is bs
    assert {k: v.data_ptr() for k, v in {**p, **a}.items()} == ids
    for got, want in ((p, jp), (a, ja), (bs, js)):
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-5,
                                       rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(out[3]), float(jout[3]), rtol=1e-5)


def test_fused_local_step_rounds_the_update_as_jax_does(setup):
    """Given the step's own gradients (the accumulator's change from
    zero), the new params are bit-equal to the JAX fused step's jitted
    ``p - lr * g`` on the CPU, and to no two-rounding form."""
    _, params, stats, x, y, tm = setup
    p, _, bs, _ = _fused_inputs(setup)
    a = {k: torch.zeros_like(v) for k, v in p.items()}
    make_fused_local_step(tm, augment=False)(p, a, bs, x, y, None,
                                             LOCAL_LR)
    g, g_step, _, _ = {k: v.numpy() for k, v in a.items()}, \
        *make_grad_step(tm, augment=False)(params, stats, x, y)[:3]
    for k in g:
        assert np.array_equal(g[k], g_step[k].numpy()), k
    jit_update = jax.jit(lambda q, d: jax.tree_util.tree_map(
        lambda u, v: u - np.float32(LOCAL_LR) * v, q, d))
    want = jax.device_get(jit_update(params, g))
    two_roundings = 0
    for k in want:
        assert p[k].numpy().tobytes() == np.asarray(want[k]).tobytes(), k
        twice = params[k] - (np.float32(LOCAL_LR) * g[k]).astype(np.float32)
        two_roundings += int(np.sum(twice != p[k].numpy()))
    assert two_roundings > 0   # the test can tell the two forms apart


@pytest.mark.cuda
def test_fused_local_step_on_card_matches_grad_step_and_apply():
    """On the card, cuDNN deterministic: the accumulator after one fused
    step from zero equals ``make_grad_step``'s gradients (±0 aside), the
    params equal the CPU's one-rounding update of those gradients, bit
    for bit, and the batch statistics equal the grad step's. (No JAX
    here: the GPU host has none.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused step's update runs on "
                    "the card")
    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        .pytree import params_to_jax
    model = ResNet(stage_sizes=(1, 1), num_filters=8,
                   num_classes=10).to("cuda")
    params, stats = params_to_jax(model)
    r = np.random.default_rng(0)
    x = r.integers(0, 255, (16, 32, 32, 3), dtype=np.uint8)
    y = (np.arange(16) % 10).astype(np.int32)
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        g, s, _, _ = make_grad_step(model, augment=False)(params, stats, x,
                                                          y)
        p, bs = _tensors(params, "cuda"), _tensors(stats, "cuda")
        a = {k: torch.zeros_like(v) for k, v in p.items()}
        make_fused_local_step(model, augment=False)(p, a, bs, x, y, None,
                                                    LOCAL_LR)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = prev
    for k in g:
        assert torch.equal(a[k].cpu(), g[k].cpu()), k
        want = [torch.tensor(np.asarray(params[k]))]
        torch._foreach_add_(want, [g[k].cpu()], alpha=-LOCAL_LR)
        assert p[k].cpu().numpy().tobytes() == want[0].numpy().tobytes(), k
    for k in s:
        assert torch.equal(bs[k].cpu(), s[k].cpu()), k
