"""The port's single-device baseline against the JAX package on the CPU:
the compositional CIFAR-100 set byte for byte, the MultiStepLR schedule
and the SGD-momentum update bit for bit (the update run op by op in JAX:
under ``jax.jit`` XLA's CPU backend fuses multiply-adds, which optax's
ops do not ask for), one BatchNorm train step against JAX's jitted step
and two epochs of ``BaselineTrainer`` within atol 1e-4 (the frameworks
order the convolution sums differently), fp32 and augment off, on the
tiny ResNet of the other port tests."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_parameter_server_for_ml_training_tpu.data.cifar import \
    compositional_cifar100 as jax_compositional
from distributed_parameter_server_for_ml_training_tpu.models import \
    ResNet as JaxResNet
from distributed_parameter_server_for_ml_training_tpu.train.baseline import (
    BaselineConfig as JaxBaselineConfig, BaselineTrainer as JaxTrainer)
from distributed_parameter_server_for_ml_training_tpu.train.optimizers \
    import baseline_optimizer as jax_baseline_optimizer
from distributed_parameter_server_for_ml_training_tpu.train.steps import \
    make_train_step as jax_make_train_step
from distributed_parameter_server_for_ml_training_tpu.train.train_state \
    import create_train_state as jax_create_train_state
from distributed_parameter_server_for_ml_training_tpu.utils.pytree import \
    flatten_params as jax_flatten
from distributed_parameter_server_for_ml_training_tpu_torch import cli
from distributed_parameter_server_for_ml_training_tpu_torch.data import \
    compositional_cifar100
from distributed_parameter_server_for_ml_training_tpu_torch.models import \
    ResNet
from distributed_parameter_server_for_ml_training_tpu_torch.train.baseline \
    import BaselineConfig, BaselineTrainer
from distributed_parameter_server_for_ml_training_tpu_torch.train \
    .optimizers import BaselineSGD, SGDState, baseline_optimizer, server_sgd
from distributed_parameter_server_for_ml_training_tpu_torch.train.steps \
    import make_train_step
from distributed_parameter_server_for_ml_training_tpu_torch.train \
    .train_state import module_train_state
from distributed_parameter_server_for_ml_training_tpu_torch.utils.metrics \
    import parse_metrics_lines
from distributed_parameter_server_for_ml_training_tpu_torch.utils.pytree \
    import params_from_jax

ATOL = 1e-4


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("kwargs", [
    {"seed": 0}, {"seed": 3},
    {"seed": 1, "num_classes": 20, "n_motifs": 24, "motifs_per_class": 2,
     "motif_px": 7, "n_distractors": 1, "label_noise": 0.0}],
    ids=["seed0", "seed3", "motifs"])
def test_compositional_cifar100_is_byte_equal(kwargs):
    got = compositional_cifar100(512, 128, **kwargs)
    want = jax_compositional(512, 128, **kwargs)
    for k in ("x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    assert (got.num_classes, got.synthetic) == (want.num_classes, True)


def test_lr_schedule_is_bit_equal_to_optax():
    """Milestones (1, 2) at 3 steps an epoch: boundaries at steps 3, 6."""
    tx = baseline_optimizer(0.1, 0.9, 5e-4, (1, 2), 0.1, steps_per_epoch=3)
    assert tx.boundaries == ((3, 0.1), (6, 0.1))
    sched = optax.piecewise_constant_schedule(0.1, {3: 0.1, 6: 0.1})
    got = [tx.lr(torch.tensor(c)) for c in range(10)]
    assert all(g.dtype == torch.float32 and g.dim() == 0 for g in got)
    np.testing.assert_array_equal(
        _bits([g.item() for g in got]),
        _bits([sched(jnp.int32(c)) for c in range(10)]))
    # optax's 0.1f * 0.1f, one ulp above float32(0.01).
    assert [hex(int(b)) for b in _bits([got[0], got[3], got[6]])] == \
        ["0x3dcccccd", "0x3c23d70b", "0x3a83126f"]


def test_milestones_on_one_step_collapse_as_optax_does():
    tx = baseline_optimizer(milestones=(2, 2, 5), steps_per_epoch=4)
    assert tx.boundaries == ((8, 0.1), (20, 0.1))


def test_optimizer_is_bit_equal_to_optax_op_by_op():
    """8 updates across both milestones on random params and grads."""
    r = np.random.default_rng(0)
    shapes = {"conv/kernel": (3, 3, 4, 8), "head/kernel": (16, 10),
              "head/bias": (10,), "bn/scale": (7,)}
    params = {k: r.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    jtx = jax_baseline_optimizer(0.1, 0.9, 5e-4, (1, 2), 0.1, 3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jtx.init(jp)
    tx = baseline_optimizer(0.1, 0.9, 5e-4, (1, 2), 0.1, 3)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = tx.init(tp)
    assert isinstance(ts, SGDState) and int(ts.count) == 0
    for step in range(8):
        g = {k: r.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
        updates, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                 js, jp)
        jp = optax.apply_updates(jp, updates)
        lr = tx.apply_(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                       ts)
        assert float(lr) == pytest.approx(0.1 ** (1 + step // 3))
        for k in shapes:
            np.testing.assert_array_equal(_bits(tp[k]), _bits(jp[k]),
                                          err_msg=f"{k} step {step}")
            np.testing.assert_array_equal(
                _bits(ts.trace[k]), _bits(js[1][0].trace[k]),
                err_msg=f"trace {k} step {step}")
    assert int(ts.count) == int(js[1][1].count) == 8


def test_server_sgd_keeps_no_state():
    p = {"w": torch.ones(3)}
    tx = server_sgd(0.5)
    assert tx.init(p) is None
    assert tx.apply_(p, {"w": torch.ones(3)}) is None
    assert torch.equal(p["w"], torch.full((3,), 0.5))


@pytest.fixture(scope="module")
def tiny():
    """The tiny ResNet's JAX init, fp32, and a port model loaded with it."""
    jm = JaxResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)
    v = jm.init(jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32),
                train=False)
    return jm, jax_flatten(v["params"]), jax_flatten(v["batch_stats"])


def _port_model(tiny):
    _, params, stats = tiny
    model = ResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)
    model.load_state_dict(params_from_jax(params, stats))
    return model


def test_bn_train_step_matches_jax(tiny):
    """Three steps across a milestone (steps 0-1 at lr 0.1, step 2 at
    0.010000001): loss, params, batch stats and momentum."""
    jm, _, _ = tiny
    r = np.random.default_rng(0)
    batches = [(r.integers(0, 255, (16, 32, 32, 3), dtype=np.uint8),
                r.integers(0, 10, (16,)).astype(np.int32))
               for _ in range(3)]
    jtx = jax_baseline_optimizer(0.1, 0.9, 5e-4, (1,), 0.1, 2)
    jstate = jax_create_train_state(jm, jax.random.PRNGKey(0), jtx)
    jstep = jax.jit(jax_make_train_step(augment=False))
    model = _port_model(tiny)
    state = module_train_state(model, baseline_optimizer(
        0.1, 0.9, 5e-4, (1,), 0.1, 2))
    step = make_train_step(model, augment=False)
    for i, (x, y) in enumerate(batches):
        jstate, jm_ = jstep(jstate, x, y, jax.random.PRNGKey(1))
        state, m = step(state, x, y)
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                                   atol=ATOL)
        assert float(m["accuracy"]) == pytest.approx(float(jm_["accuracy"]))
        assert _bits(m["learning_rate"]) == _bits(0.1 if i < 2 else
                                                  np.float32(0.1) ** 2)
    assert state.step == int(jstate.step) == 3
    want = {"params": jax_flatten(jstate.params),
            "batch_stats": jax_flatten(jstate.batch_stats),
            "trace": jax_flatten(jstate.opt_state[1][0].trace)}
    got = {"params": state.params, "batch_stats": state.batch_stats,
           "trace": state.opt_state.trace}
    for part, w in want.items():
        assert sorted(got[part]) == sorted(w), part
        for k, v in w.items():
            np.testing.assert_allclose(got[part][k].numpy(), v, atol=ATOL,
                                       err_msg=f"{part} {k}")
    # The state's tensors are the module's own: the weights moved.
    own = dict(model.named_parameters())
    assert got["params"]["head/kernel"].data_ptr() \
        == own["head.weight"].data_ptr()
    assert got["batch_stats"]["stem_bn/mean"] is model.stem_bn.running_mean


def test_train_step_updates_in_place(tiny):
    """Nothing of the state is reallocated by a step (a CUDA graph
    replays the same addresses)."""
    model = _port_model(tiny)
    state = module_train_state(model, baseline_optimizer())
    before = [t.data_ptr() for t in state.tensors()]
    r = np.random.default_rng(1)
    x = r.integers(0, 255, (8, 32, 32, 3), dtype=np.uint8)
    y = r.integers(0, 10, (8,)).astype(np.int32)
    state, m = make_train_step(model, augment=True)(
        state, x, y, torch.Generator().manual_seed(0))
    assert [t.data_ptr() for t in state.tensors()] == before
    assert m["augment_draws"].shape == (8, 3)
    assert int(state.opt_state.count) == 1


def test_baseline_trainer_matches_jax(tiny):
    """Two epochs with the milestone at epoch 1, from JAX's init: the
    per-epoch loss and accuracies match."""
    jm, _, _ = tiny
    ds = compositional_cifar100(256, 100, num_classes=10, seed=2)
    common = dict(batch_size=64, num_epochs=2, milestones=(1,),
                  dtype="float32", augment=False, num_classes=10)
    jt = JaxTrainer(ds, JaxBaselineConfig(**common), model=jm)
    model = ResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)
    model.load_state_dict(params_from_jax(
        jax_flatten(jt.state.params), jax_flatten(jt.state.batch_stats)))
    pt = BaselineTrainer(ds, BaselineConfig(**common, device="cpu"),
                         model=model)
    jmet, pmet = jt.train(), pt.train()
    np.testing.assert_allclose(pmet.train_losses, jmet.train_losses,
                               atol=ATOL)
    np.testing.assert_allclose(pmet.train_accuracies,
                               jmet.train_accuracies, atol=ATOL)
    np.testing.assert_allclose(pmet.test_accuracies, jmet.test_accuracies,
                               atol=ATOL)
    assert pmet.epochs == [1, 2] and len(pt.train_seconds) == 2
    assert pt.state.step == int(jt.state.step) == 8
    for k, v in jax_flatten(jt.state.params).items():
        np.testing.assert_allclose(pt.state.params[k].numpy(), v,
                                   atol=ATOL, err_msg=k)


def test_baseline_trainer_plain_sgd_and_vit():
    """``plain_sgd`` takes the server optimizer, and a ViT trains through
    the same step."""
    from distributed_parameter_server_for_ml_training_tpu_torch.data \
        import synthetic_cifar100
    ds = synthetic_cifar100(64, 16, num_classes=10, seed=0)
    cfg = BaselineConfig(batch_size=32, num_epochs=1, dtype="float32",
                         num_classes=10, plain_sgd=True, model="vit_tiny",
                         device="cpu")
    t = BaselineTrainer(ds, cfg)
    assert t.state.opt_state is None and t.state.batch_stats == {}
    m = t.train()
    assert len(m.train_losses) == 1 and np.isfinite(m.train_losses[0])


def test_baseline_trainer_checkpoints_each_epoch(tmp_path):
    """A checkpoint per epoch, at the state's step; ``resume`` over an
    empty directory starts fresh, and without one it is ignored, as in
    JAX."""
    from distributed_parameter_server_for_ml_training_tpu_torch \
        .checkpoint import CheckpointManager
    ds = compositional_cifar100(64, 16, num_classes=10)
    t = BaselineTrainer(ds, BaselineConfig(
        batch_size=32, num_epochs=1, num_classes=10, dtype="float32",
        device="cpu"), model=ResNet(stage_sizes=(1, 1), num_filters=8,
                                    num_classes=10))
    t.train(checkpoint_dir=str(tmp_path), resume=True)
    assert CheckpointManager(str(tmp_path)).steps() == [2]
    t.train(resume=True)
    assert t.state.step == 4


def test_cli_train_baseline_on_cpu(capsys):
    rc = cli.main(["train", "--mode", "baseline", "--epochs", "1",
                   "--synthetic", "--num-train", "32", "--num-test", "16",
                   "--batch-size", "16", "--emit-metrics", "--device",
                   "cpu", "--dtype", "float32"])
    assert rc == 0
    (row,) = parse_metrics_lines(capsys.readouterr().out)
    assert row["role"] == "baseline" and row["num_epochs"] == 1
    assert set(row) == {"role", "num_epochs", "batch_size", "learning_rate",
                        "total_training_time_seconds", "epoch_times_seconds",
                        "final_test_accuracy", "all_test_accuracies",
                        "final_train_loss"}
    assert np.isfinite(row["final_train_loss"])


@pytest.mark.parametrize("flag", [["--checkpoint-dir"], ["--resume"]])
def test_cli_baseline_checkpoint_flags(flag, tmp_path, monkeypatch, capsys):
    """``--checkpoint-dir`` leaves an epoch's checkpoint; ``--resume``
    with it continues from there (a tiny ResNet stands in)."""
    from distributed_parameter_server_for_ml_training_tpu_torch import \
        models as port_models
    monkeypatch.setattr(port_models, "get_model", lambda *a, **kw: ResNet(
        stage_sizes=(1, 1), num_filters=8, num_classes=10))
    monkeypatch.setattr(cli, "_load_dataset",
                        lambda args: compositional_cifar100(32, 16, 10))
    argv = ["train", "--mode", "baseline", "--epochs", "1", "--synthetic",
            "--num-train", "32", "--num-test", "16", "--batch-size", "16",
            "--device", "cpu", "--checkpoint-dir", str(tmp_path)]
    assert cli.main(argv) == 0
    if flag == ["--resume"]:
        assert cli.main([*argv[:4], "2", *argv[5:], "--resume"]) == 0
        assert "resumed from step 2 (epoch 2)" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == (
        ["ckpt_00000002.pt"] if flag == ["--checkpoint-dir"]
        else ["ckpt_00000002.pt", "ckpt_00000004.pt"])


def test_baseline_config_defaults_match_jax():
    jc, pc = JaxBaselineConfig(), BaselineConfig(device="cpu")
    for k, v in vars(jc).items():
        assert getattr(pc, k) == v, k
    assert set(vars(pc)) - set(vars(jc)) == {"device"}
    assert isinstance(baseline_optimizer(), BaselineSGD)
