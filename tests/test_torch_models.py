"""The port's ResNet against the flax model, with weights carried across.

fp32 on the CPU. Logits agree to atol/rtol 1e-4 (the frameworks sum the
convolutions in different orders); the BatchNorm running statistics,
updated as flax updates them (biased batch variance, momentum 0.9 on the
old value), agree to 1e-5."""

import jax
import numpy as np
import pytest
import torch

from distributed_parameter_server_for_ml_training_tpu.models import \
    ResNet as JaxResNet
from distributed_parameter_server_for_ml_training_tpu.utils.pytree import \
    flatten_params as jax_flatten
from distributed_parameter_server_for_ml_training_tpu_torch.models import (
    MODEL_NAMES, BatchNorm, ResNet, ViT, get_model)
from distributed_parameter_server_for_ml_training_tpu_torch.utils.pytree \
    import params_from_jax, params_to_jax
from torch_threads import one_torch_thread  # noqa: F401 (fixture)


def _pair(seed=0, num_filters=8, stage_sizes=(1, 1)):
    jm = JaxResNet(stage_sizes=stage_sizes, num_filters=num_filters,
                   num_classes=10)
    v = jm.init(jax.random.PRNGKey(seed),
                np.zeros((1, 32, 32, 3), np.float32), train=False)
    r = np.random.default_rng(seed)
    # Non-trivial running stats, so eval mode is a real test.
    stats = {k: (np.abs(r.standard_normal(a.shape)) + 0.5).astype(np.float32)
             if k.endswith("var") else
             r.standard_normal(a.shape).astype(np.float32) * 0.1
             for k, a in jax_flatten(v["batch_stats"]).items()}
    params = jax_flatten(v["params"])
    tm = ResNet(stage_sizes=stage_sizes, num_filters=num_filters,
                num_classes=10)
    tm.load_state_dict(params_from_jax(params, stats))
    jax_vars = {"params": v["params"],
                "batch_stats": jax.tree_util.tree_map(
                    np.asarray, _unflat(stats))}
    return jm, jax_vars, tm


def _unflat(flat):
    from distributed_parameter_server_for_ml_training_tpu.utils.pytree \
        import unflatten_params
    return unflatten_params(flat)


def _images(n=8, seed=1):
    r = np.random.default_rng(seed)
    return r.standard_normal((n, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("train", [False, True])
def test_logits_match_flax(train):
    jm, jv, tm = _pair()
    x = _images()
    if train:
        want, mutated = jm.apply(jv, x, train=True, mutable=["batch_stats"])
    else:
        want = jm.apply(jv, x, train=False)
    tm.train(train)
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)
    if train:
        _, got_stats = params_to_jax(tm)
        want_stats = jax_flatten(mutated["batch_stats"])
        assert set(got_stats) == set(want_stats)
        for k in want_stats:
            np.testing.assert_allclose(got_stats[k], want_stats[k],
                                       atol=1e-5, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("train", [False, True])
def test_forward_is_one_slot_of_forward_slots(train):
    """Three slots with the same weights and their own images give each
    slot's one-slot logits (the grouped convs and the per-slot head). In
    training the statistics are shared over the slots, so the slots see
    the same images there."""
    _, _, tm = _pair()
    tm.axis_name = "data"
    for m in tm.modules():
        if isinstance(m, BatchNorm):
            m.axis_name = "data"
    x = _images(12).reshape(3, 4, 32, 32, 3)
    if train:
        x = np.broadcast_to(x[:1], x.shape).copy()
    tm.train(train)
    leaves = {k: p[None].expand(3, *p.shape)
              for k, p in tm.named_parameters()}
    with torch.no_grad():
        got = tm.forward_slots(torch.from_numpy(x), leaves)
        want = torch.stack([tm(torch.from_numpy(x[i])) for i in range(3)])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_batchnorm_updates_with_biased_variance():
    bn = BatchNorm(3)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 3, 5, 5)).astype(np.float32))
    bn.train()
    bn(x)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * biased,
                               atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(bn.running_mean, 0.1 * x.mean(dim=(0, 2, 3)),
                               atol=1e-6, rtol=1e-6)


def test_bfloat16_compute_keeps_fp32_params():
    tm = ResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10,
                dtype=torch.bfloat16)
    tm.train()
    out = tm(torch.from_numpy(_images(4)))
    assert out.dtype == torch.float32 and out.shape == (4, 10)
    assert torch.isfinite(out).all()
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(b.dtype == torch.float32 for b in tm.buffers())


def test_init_is_seeded_and_flax_like():
    a = get_model("resnet18", device="cpu", seed=3)
    b = get_model("resnet18", device="cpu", seed=3)
    c = get_model("resnet18", device="cpu", seed=4)
    pa, _ = params_to_jax(a)
    pb, _ = params_to_jax(b)
    pc, _ = params_to_jax(c)
    assert all(np.array_equal(pa[k], pb[k]) for k in pa)
    assert not np.array_equal(pa["stem_conv/kernel"], pc["stem_conv/kernel"])
    k = pa["BasicBlock_2/Conv_0/kernel"]        # fan-in 3*3*64
    assert abs(k.std() - np.sqrt(1 / (9 * 64))) < 0.1 * np.sqrt(1 / 576)
    assert np.all(pa["head/bias"] == 0) and np.all(pa["stem_bn/scale"] == 1)


@pytest.mark.parametrize("name", ["resnet18", "resnet50", "vit_b16",
                                  "vit_tiny"])
def test_every_registry_name_builds(name, one_torch_thread):
    """Every name of the JAX registry builds and runs a forward: the
    ResNets at 224 px (the ImageNet stem), the ViTs at 32 px (the CIFAR
    resolution's position embedding); an unknown name is refused."""
    assert MODEL_NAMES == ("resnet18", "resnet50", "vit_b16", "vit_tiny")
    vit = name.startswith("vit")
    size = 32 if vit else 224
    model = get_model(name, num_classes=10, device="cpu", image_size=size,
                      dtype="float32")
    assert isinstance(model, ViT if vit else ResNet)
    assert model.head.out_features == 10
    if vit:
        assert model.pos_embed.shape[1] == (size // model.patch_size) ** 2 + 1
    else:
        assert model.imagenet_stem
    with torch.no_grad():
        out = model.eval()(torch.zeros(1, size, size, 3))
    assert tuple(out.shape) == (1, 10) and torch.isfinite(out).all()
    with pytest.raises(ValueError):
        get_model("nope", device="cpu")
