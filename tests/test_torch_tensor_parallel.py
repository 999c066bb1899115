"""The port's tensor parallelism (``parallel/tensor.py``, the TP forms of
``models/vit.py``, ``TPTrainer``) against the JAX package's GSPMD
placement (``shard_train_state`` on the 8-device CPU mesh, one jitted
step), as ``tests/test_vit.py``'s ``TestTensorParallel`` builds it.

- The rule table: ``tp_spec_for_path`` equal to JAX's on every path of
  vit_tiny's and vit_b16's trees (and the pipeline's stacked stages).
- Slot views: on a data 2 x model 4 mesh each slot's view has the shape
  of JAX's ``addressable_shards`` and holds the same values.
- One fp32 step at data 2 x tp 1, 2, 3 and 4 (vit_tiny has 3 heads, so
  tp 2 and 4 split ``out``'s input columns inside a head) from JAX's
  weights, lr 0.05, 16 images, no augment: loss within rtol 1e-4, params
  within rtol 2e-3 / atol 2e-4 (JAX's own tolerances for its sharded
  step against the unsharded one). A float64 TP step within 1e-12 of the
  port's unsplit step.
- A bf16 step at data 2 x tp 2 against JAX's jitted sharded bf16 step,
  within the 2e-2 the port's bf16 ViT tests hold logits to
  (``tests/test_torch_vit.py``): the frameworks' bf16 kernels round at
  different places.
- Errors equal to JAX's, ``TPTrainer``'s resume bit-equal to an
  uninterrupted run, the products' contract (partials summed in fp32,
  bias once) and ``cli train --mode tp``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_parameter_server_for_ml_training_tpu.models import vit as jvit
from distributed_parameter_server_for_ml_training_tpu.parallel import \
    make_mesh as jax_make_mesh
from distributed_parameter_server_for_ml_training_tpu.parallel import \
    tensor as jtensor
from distributed_parameter_server_for_ml_training_tpu.train import (
    make_train_step, server_sgd)
from distributed_parameter_server_for_ml_training_tpu.train import \
    model_parallel as jmp
from distributed_parameter_server_for_ml_training_tpu.train.train_state \
    import TrainState
from distributed_parameter_server_for_ml_training_tpu.utils.pytree import \
    flatten_params as jax_flatten
from distributed_parameter_server_for_ml_training_tpu_torch import cli
from distributed_parameter_server_for_ml_training_tpu_torch.data import \
    cifar
from distributed_parameter_server_for_ml_training_tpu_torch.models import (
    get_model)
from distributed_parameter_server_for_ml_training_tpu_torch.models.vit \
    import EncoderBlock
from distributed_parameter_server_for_ml_training_tpu_torch.parallel import \
    tensor
from distributed_parameter_server_for_ml_training_tpu_torch.parallel.mesh \
    import make_mesh
from distributed_parameter_server_for_ml_training_tpu_torch.train import \
    model_parallel as mp
from distributed_parameter_server_for_ml_training_tpu_torch.train import (
    optimizers, steps, train_state)
from distributed_parameter_server_for_ml_training_tpu_torch.utils.metrics \
    import parse_metrics_lines
from distributed_parameter_server_for_ml_training_tpu_torch.utils.pytree \
    import flax_names, params_from_jax, params_to_jax, to_flax_layout
from torch_threads import one_torch_thread_per_module  # noqa: F401

LR = 0.05


def jitted_create_train_state(model, rng, tx, input_shape=(1, 32, 32, 3)):
    """JAX's ``create_train_state`` with its init jitted: op by op, flax's
    init compiles every op (~8 s for vit_tiny)."""
    variables = jax.jit(lambda k: model.init(
        k, jnp.ones(input_shape, jnp.float32), train=False))(rng)
    return TrainState.create(apply_fn=model.apply,
                             params=variables["params"],
                             batch_stats=variables.get("batch_stats", {}),
                             tx=tx)


@pytest.fixture(scope="module")
def jstate():
    return jitted_create_train_state(jvit.ViT_Tiny(num_classes=10),
                                     jax.random.PRNGKey(0), server_sgd(LR))


def _batch():
    images = np.random.default_rng(1).integers(
        0, 255, (16, 32, 32, 3), dtype=np.uint8)
    return images, (np.arange(16) % 10).astype(np.int32)


def _jax_tp_step(st, dp, tp):
    """JAX's sharded step, as tests/test_vit.py builds it, on dp x tp
    of the 8 virtual devices."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jax_make_mesh(dp, axis_names=("data", "model"),
                         devices=jax.devices()[:dp * tp])
    images, labels = _batch()
    st = jtensor.shard_train_state(st, mesh)
    bi = jax.device_put(images, NamedSharding(mesh, P("data")))
    bl = jax.device_put(labels, NamedSharding(mesh, P("data")))
    st, metrics = jax.jit(make_train_step(augment=False))(
        st, bi, bl, jax.random.PRNGKey(2))
    return (float(metrics["loss"]),
            jax_flatten(jax.device_get(st.params)))


def _port_step(init, tp, dtype="float32"):
    """One step of the port's TP model from JAX's flat weights; returns
    (loss, flat flax params after the step)."""
    model = get_model("vit_tiny", num_classes=10, dtype=dtype,
                      image_size=32, device="cpu", tp_degree=tp)
    model.load_state_dict(params_from_jax(init))
    state = train_state.module_train_state(model, optimizers.server_sgd(LR))
    images, labels = _batch()
    _, metrics = steps.make_train_step(model, augment=False)(
        state, images, labels)
    return float(metrics["loss"]), params_to_jax(model)[0]


@pytest.mark.parametrize("model", ["vit_tiny", "vit_b16"])
def test_rule_table_matches_jax(jstate, model):
    if model == "vit_tiny":
        tree = jstate.params
    else:                                   # paths from shapes alone
        tree = jax.eval_shape(lambda: jvit.ViT_B16(num_classes=10).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
            train=False))["params"]
    paths = list(jax_flatten(tree, as_numpy=False))
    with torch.device("meta"):              # names only: no weights drawn
        names, _ = flax_names(get_model(model, num_classes=10,
                                        device="meta"))
    assert set(names.values()) == set(paths)
    split = 0
    for path in paths + [f"stages/{p}" for p in paths]:
        want = jtensor.tp_spec_for_path(path)
        assert tensor.tp_spec_for_path(path) == tuple(want), path
        split += bool(tuple(want))
    assert split == 2 * 6 * {"vit_tiny": 4, "vit_b16": 12}[model]


def test_slot_views_have_jax_shard_shapes(devices, jstate):
    """data 2 x model 4: every model slot's view has the shape and the
    values of JAX's shard on that slot (replicated leaves whole)."""
    mesh = jax_make_mesh(2, axis_names=("data", "model"))
    st = jtensor.shard_train_state(jstate, mesh)
    flat = jax_flatten(st.params, as_numpy=False)
    init = jax_flatten(jax.device_get(st.params))
    model = get_model("vit_tiny", num_classes=10, device="cpu",
                      tp_degree=4)
    model.load_state_dict(params_from_jax(init))
    own = dict(model.named_parameters())
    torch_names = {v: k for k, v in flax_names(model)[0].items()}
    assert flat["block_0/attn/qkv/kernel"].shape == (192, 576)
    for path, arr in flat.items():
        views = tensor.slot_views(
            to_flax_layout(own[torch_names[path]].detach(), path), path, 4)
        shard_shapes = {tuple(s.data.shape) for s in arr.addressable_shards}
        assert shard_shapes == {tuple(views.shape[1:])}, path
        for s in arr.addressable_shards:
            (_, j), = np.argwhere(mesh.devices == s.device)
            np.testing.assert_array_equal(views[j].numpy(),
                                          np.asarray(s.data), err_msg=path)
    qkv = tensor.slot_views(torch.zeros(192, 576),
                            "block_0/attn/qkv/kernel", 4)
    assert qkv.shape == (4, 192, 144)


@pytest.mark.parametrize("tp", [1, 2, 3, 4])
def test_tp_step_matches_jax(devices, jstate, tp):
    st = jstate
    init = jax_flatten(jax.device_get(st.params))
    want_loss, want = _jax_tp_step(st, 2, tp)
    got_loss, got = _port_step(init, tp)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    assert set(got) == set(init)
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=2e-4,
                                   err_msg=k)
        moved += not np.array_equal(got[k], init[k])
    assert moved > 0


@pytest.mark.parametrize("tp", [2, 4])
def test_float64_tp_step_matches_unsplit(tp):
    """The TP form changes only the order of the sums: one float64 step
    within 1e-12 of the unsplit model's, loss and every parameter."""
    def run(tp_degree):
        model = get_model("vit_tiny", num_classes=10, dtype=torch.float64,
                          image_size=32, device="cpu", seed=3,
                          tp_degree=tp_degree).double()
        state = train_state.module_train_state(
            model, optimizers.server_sgd(LR))
        images, labels = _batch()
        _, metrics = steps.make_train_step(model, augment=False)(
            state, images, labels)
        return metrics["loss"], dict(model.named_parameters())

    loss1, p1 = run(1)
    loss_tp, p_tp = run(tp)
    assert abs(float(loss_tp) - float(loss1)) <= 1e-12
    for k, v in p1.items():
        assert float((p_tp[k] - v).detach().abs().max()) <= 1e-12, k


def test_bf16_tp_step_matches_jax(devices, jstate):
    st = jstate.replace(apply_fn=jvit.ViT_Tiny(
        num_classes=10, dtype=jnp.bfloat16).apply)
    init = jax_flatten(jax.device_get(st.params))
    want_loss, want = _jax_tp_step(st, 2, 2)
    got_loss, got = _port_step(init, 2, dtype="bfloat16")
    np.testing.assert_allclose(got_loss, want_loss, rtol=2e-2)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-2, atol=2e-2,
                                   err_msg=k)


def test_block_products_sum_partials_in_fp32_once():
    """``row_parallel`` on bf16: each slot's product rounded to bf16 by
    no one; the fp32 sum of the partials plus the bias, cast once."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(5, 12, generator=gen).bfloat16()
    w = torch.randn(8, 12, generator=gen)
    b = torch.randn(8, generator=gen)
    xs = tensor.split_columns(x, 3)
    got = tensor.row_parallel(xs, w, b, torch.bfloat16)
    wb = w.bfloat16().float()
    partial = torch.stack([xs[j].float() @ wb[:, 4 * j:4 * j + 4].T
                           for j in range(3)])
    want = (partial.sum(0) + b.bfloat16().float()).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    # The backward runs in bf16, as the plain layer's: the gradient of
    # the bf16 output, exact in bf16, against each slot's weight columns.
    xg = xs.detach().clone().requires_grad_()
    wg = w.clone().requires_grad_()
    cot = torch.randn(5, 8, generator=gen).bfloat16()
    tensor.row_parallel(xg, wg, b, torch.bfloat16).backward(cot)
    wv = tensor.row_views(w.bfloat16(), 3)                 # [3, 8, 4]
    assert xg.grad.dtype == torch.bfloat16
    assert torch.equal(xg.grad, torch.bmm(cot.expand(3, 5, 8), wv))
    want_w = torch.bmm(xs.transpose(1, 2), cot.expand(3, 5, 8))
    assert torch.equal(tensor.row_views(wg.grad, 3),
                       want_w.transpose(1, 2).float())
    col = tensor.column_parallel(x, w, b, 2, torch.bfloat16)
    assert col.shape == (2, 5, 4)
    assert torch.equal(tensor.gather_columns(col),
                       torch.nn.functional.linear(x, w.bfloat16(),
                                                  b.bfloat16()))


@pytest.mark.parametrize("tp", [2, 3, 4])
def test_encoder_block_tp_form_matches_plain(tp):
    """One block, forward and backward, float64: its TP form against the
    plain block on the same weights within 1e-12."""
    gen = torch.Generator().manual_seed(7)
    plain = EncoderBlock(24, 3, dtype=torch.float64).double()
    split = EncoderBlock(24, 3, dtype=torch.float64, tp_degree=tp).double()
    with torch.no_grad():
        for p in plain.parameters():
            p.normal_(0.0, 0.3, generator=gen)
    split.load_state_dict(plain.state_dict())
    x = torch.randn(2, 5, 24, generator=gen, dtype=torch.float64)
    cot = torch.randn(2, 5, 24, generator=gen, dtype=torch.float64)
    outs = []
    for blk in (plain, split):
        xx = x.clone().requires_grad_()
        y = blk(xx)
        grads = torch.autograd.grad((y * cot).sum(),
                                    [xx, *blk.parameters()])
        outs.append((y.detach(), grads))
    assert float((outs[0][0] - outs[1][0]).abs().max()) <= 1e-12
    for a, b in zip(outs[0][1], outs[1][1]):
        assert float((a - b).abs().max()) <= 1e-12


def _dataset(n_train=16, n_test=8):
    return cifar.synthetic_imagenet(n_train=n_train, n_test=n_test,
                                    num_classes=10, image_size=32, seed=1)


def _configs(**kw):
    common = dict(model="vit_tiny", num_workers=2, tp_degree=2,
                  learning_rate=0.1, num_epochs=1, augment=False,
                  num_classes=10, dtype="float32", seed=0, batch_size=8)
    common.update(kw)
    return jmp.ModelParallelConfig(**common), \
        mp.ModelParallelConfig(**common, device="cpu")


def test_tp_trainer_matches_jax(devices, monkeypatch):
    """``TPTrainer`` 2 x 2 beside JAX's: mesh, label, metric fields, the
    state's tree (the plain ViT's, each tensor the module's own); its
    step is ``test_tp_step_matches_jax``'s."""
    monkeypatch.setattr(jmp, "create_train_state", jitted_create_train_state)
    ds = _dataset(n_train=8)
    jcfg, tcfg = _configs()
    jt, tt = jmp.TPTrainer(ds, jcfg), mp.TPTrainer(ds, tcfg)
    assert tt.mesh.shape == dict(jt.mesh.shape) == {"data": 2, "model": 2}
    assert tt._label() == jt._label() == "tp 2x2"
    assert tt._extra_metrics() == jt._extra_metrics() == {"tp_degree": 2}
    tm = tt.train()
    assert tm["mode"] == jt.mode and tm["global_steps_completed"] == 1
    got, _ = params_to_jax(tt.model)
    assert set(got) == set(jax_flatten(jax.device_get(jt.state.params)))
    assert all(np.array_equal(v.numpy(), got[k])
               for k, v in tt.state.params.items())


@pytest.mark.parametrize("kw,match,at_step", [
    (dict(model="resnet18"), "transformer", False),
    (dict(tp_degree=5, num_workers=1), "should be divisible by 5", False),
    (dict(batch_size=7), "should be divisible by 2", True)])
def test_tp_errors_match_jax(devices, monkeypatch, kw, match, at_step):
    monkeypatch.setattr(jmp, "create_train_state", jitted_create_train_state)
    ds = _dataset(n_train=8)
    jcfg, tcfg = _configs(**kw)
    for pkg, cfg in ((jmp, jcfg), (mp, tcfg)):
        with pytest.raises(ValueError, match=match):
            trainer = pkg.TPTrainer(ds, cfg)
            assert at_step
            trainer.train()


def test_tp_trainer_resumes_from_its_checkpoint(tmp_path):
    """A checkpoint each epoch holds the plain ViT's tree; a run resumed
    from epoch 1 ends bit-equal to the uninterrupted one."""
    ds = _dataset(n_train=4, n_test=4)

    def run(epochs, where, resume=False):
        _, tcfg = _configs(batch_size=2, num_epochs=epochs, augment=True,
                           tp_degree=3)
        trainer = mp.TPTrainer(ds, tcfg)
        trainer.train(checkpoint_dir=str(tmp_path / where), resume=resume)
        return trainer

    full = run(2, "a")
    first = run(1, "b")
    plain = get_model("vit_tiny", num_classes=10, device="cpu")
    assert list(first.state.params) == list(params_to_jax(plain)[0])
    resumed = run(2, "b", resume=True)
    assert resumed.global_steps == full.global_steps == 4
    for k, v in full.state.params.items():
        assert v.equal(resumed.state.params[k]), k
    assert resumed.train_loss_per_epoch == full.train_loss_per_epoch[1:]


@pytest.mark.parametrize("argv,want", [
    (["--mode", "tp", "--workers", "2", "--tp-degree", "4"],
     {"mode": "tp", "tp_degree": 4, "total_workers": 2}),
    (["--mode", "tp", "--workers", "1", "--tp-degree", "3"],
     {"mode": "tp", "tp_degree": 3, "total_workers": 1})])
def test_cli_trains_tp(capsys, argv, want):
    rc = cli.main(["train", *argv, "--model", "vit_tiny", "--epochs", "1",
                   "--dataset", "imagenet-synth", "--image-size", "32",
                   "--num-train", "16", "--num-test", "8", "--batch-size",
                   "8", "--emit-metrics", "--device", "cpu", "--dtype",
                   "float32"])
    assert rc == 0
    (row,) = parse_metrics_lines(capsys.readouterr().out)
    for k, v in want.items():
        assert row[k] == v, k
    assert row["global_steps_completed"] == 2
    json.dumps(row)


def test_tp_mesh_over_ranks_names_its_part():
    """A mesh of two or more axes over ranks stays refused, naming the
    part that brings it."""
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import multihost
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        .mesh import Mesh

    with pytest.raises(NotImplementedError,
                       match="ROADMAP §1 item 10, sixth part"):
        Mesh(2, torch.device("cpu"), "data", group=object(),
             axes=(("data", 2), ("model", 2)))
    with pytest.raises(NotImplementedError,
                       match="ROADMAP §1 item 10, sixth part"):
        multihost.make_global_mesh(4, "cpu", axis_names=("data", "model"))
    assert make_mesh(2, "cpu", ("data", "model"), num_slots=4).shape == \
        {"data": 2, "model": 2}
