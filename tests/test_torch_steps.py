"""The port's grad/eval steps and augmentation against the JAX package.

Gradients in flax layout agree to atol 1e-5 / rtol 1e-4 in fp32 (the
frameworks order the convolution sums differently); the augmentation,
fed the draws ``jax.random`` made, is bit-equal."""

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
    import make_eval_step, make_grad_step


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
