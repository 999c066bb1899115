"""The port's model-parallel trainers (``train/model_parallel.py``)
against the JAX package's: one ``SPTrainer`` step of vit_tiny in fp32,
without augmentation, over 2 sequence slots against 2 virtual devices,
one ``MoETrainer`` step over 4 expert slots against 4 devices and one
``PipelineTrainer`` step over 2 stages of 4 microbatches against 2
devices, each from the JAX trainer's initial weights; parameters agree
within rtol 1e-4 / atol 1e-5, the MoE metrics within 1e-5. The
compositions of ROADMAP §1 item 10's third part the same way: dp x ep (a
``MoETrainer`` step at data 2 x 4 experts against 8 devices) and dp x tp
x pp (a ``PipelineTrainer`` step at 2 x 2 x 2), with JAX's mesh shapes;
the composed trainers and CLI flags that were refused before it, now
trained. Also the CLI's moe and pp modes and the synthetic ImageNet data
the SP path trains on, byte for byte."""

import json

import jax
import numpy as np
import pytest

from distributed_parameter_server_for_ml_training_tpu.data import cifar as jcifar
from distributed_parameter_server_for_ml_training_tpu.ops.pallas import \
    flash_attention as jfa
from distributed_parameter_server_for_ml_training_tpu.train import \
    model_parallel as jmp
from distributed_parameter_server_for_ml_training_tpu.train.train_state \
    import TrainState
from distributed_parameter_server_for_ml_training_tpu.utils.pytree import \
    flatten_params as jax_flatten
from distributed_parameter_server_for_ml_training_tpu_torch import cli
from distributed_parameter_server_for_ml_training_tpu_torch.data import \
    cifar
from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
    flash_attention as fa
from distributed_parameter_server_for_ml_training_tpu_torch.train import \
    model_parallel as mp
from distributed_parameter_server_for_ml_training_tpu_torch.utils.metrics \
    import parse_metrics_lines
from distributed_parameter_server_for_ml_training_tpu_torch.utils.pytree \
    import params_from_jax, params_to_jax
from torch_threads import one_torch_thread_per_module  # noqa: F401


def _jitted_create_train_state(model, rng, tx, input_shape=(1, 32, 32, 3)):
    """JAX's ``create_train_state`` with its init jitted: op by op, flax's
    init compiles every op, several seconds a model. Both packages start
    from the weights it returns."""
    variables = jax.jit(lambda k: model.init(
        k, np.ones(input_shape, np.float32), train=False))(rng)
    return TrainState.create(apply_fn=model.apply,
                             params=variables["params"],
                             batch_stats=variables.get("batch_stats", {}),
                             tx=tx)


@pytest.fixture(autouse=True)
def _fast_jax_init(monkeypatch):
    monkeypatch.setattr(jmp, "create_train_state", _jitted_create_train_state)


def _dataset(image, n_train, n_test=4):
    return cifar.synthetic_imagenet(n_train=n_train, n_test=n_test,
                                    num_classes=10, image_size=image, seed=1)


def _configs(**kw):
    common = dict(model="vit_tiny", num_workers=2, learning_rate=0.1,
                  num_epochs=1, augment=False, num_classes=10,
                  dtype="float32", seed=0, **kw)
    return jmp.ModelParallelConfig(**common), \
        mp.ModelParallelConfig(**common, device="cpu")


@pytest.mark.parametrize("ring", ["dense", "flash"])
def test_sp_step_matches_jax(monkeypatch, ring):
    """One step from the JAX trainer's initial weights. At 32 px the 64
    tokens split into slots of 32, so both packages run the dense ring; at
    64 px with the flash dispatch forced on (off the accelerator neither
    would choose it) both run the flash ring with plain hops over slots of
    128 tokens."""
    image = 32 if ring == "dense" else 64
    if ring == "flash":
        monkeypatch.setattr(jfa, "flash_preferred", lambda t: True)
        monkeypatch.setattr(mp, "flash_preferred", lambda t, device: True)
    ds = _dataset(image, n_train=4)
    jcfg, tcfg = _configs(batch_size=4)
    jt = jmp.SPTrainer(ds, jcfg)
    tt = mp.SPTrainer(ds, tcfg)
    assert tt.flash == (ring == "flash") and tt.tokens == jt.tokens
    init = jax_flatten(jax.device_get(jt.state.params))
    tt.model.load_state_dict(params_from_jax(init))
    jm = jt.train()
    tm = tt.train()
    assert jt.global_steps == tt.global_steps == 1
    want = jax_flatten(jax.device_get(jt.state.params))
    got, _ = params_to_jax(tt.model)
    assert set(got) == set(want)        # jit returns jax's sorted order
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
        moved += not np.array_equal(got[k], init[k])
    assert moved > 0
    # The trainer's state holds views of the module's own weights.
    assert all(np.array_equal(v.numpy(), got[k])
               for k, v in tt.state.params.items())
    assert set(tm) == set(jm)
    for key in ("mode", "seq_shards", "tokens", "total_workers",
                "global_steps_completed", "total_parameter_updates"):
        assert tm[key] == jm[key], key
    assert tm["mode"] == "sp" and tm["tokens"] == (image // 4) ** 2
    assert tm["final_test_accuracy"] == jm["final_test_accuracy"]
    assert np.isfinite(tt.train_loss_per_epoch).all()


def test_sp_dispatch_follows_flash_preferred(monkeypatch):
    """The ring is the flash ring only when the per-slot length is a
    multiple of 128 and the predicate holds, as in the JAX trainer."""
    ds = _dataset(64, n_train=2)             # 256 tokens
    asked = []
    monkeypatch.setattr(mp, "flash_preferred",
                        lambda t, device: asked.append(t) or True)
    _, tcfg = _configs(batch_size=2)
    assert mp.SPTrainer(ds, tcfg).flash and asked == [128]
    tcfg.num_workers = 4                     # slots of 64: never flash
    assert not mp.SPTrainer(ds, tcfg).flash and asked == [128]
    monkeypatch.undo()
    tcfg.num_workers = 2                     # on the CPU: the dense ring
    assert not mp.SPTrainer(ds, tcfg).flash
    assert fa.flash_preferred(2048, "cuda") and \
        not fa.flash_preferred(2048, "cpu")


def test_sp_errors_match_jax():
    ds = _dataset(32, n_train=2)             # 64 tokens
    for kw, match in ((dict(model="resnet18"), "supports ViT models"),
                      (dict(num_workers=3), "not divisible by 3")):
        jcfg, tcfg = _configs(batch_size=2)
        for cfg in (jcfg, tcfg):
            for k, v in kw.items():
                setattr(cfg, k, v)
        with pytest.raises(ValueError, match=match):
            jmp.SPTrainer(ds, jcfg)
        with pytest.raises(ValueError, match=match):
            mp.SPTrainer(ds, tcfg)


def test_sp_trainer_resumes_from_its_checkpoint(tmp_path):
    """A checkpoint each epoch (the train state and the augment
    generator); a run resumed from epoch 1 ends bit-equal to the
    uninterrupted one."""
    ds = _dataset(32, n_train=4)

    def run(epochs, where, resume=False):
        _, tcfg = _configs(batch_size=2)
        tcfg.num_epochs, tcfg.augment = epochs, True
        trainer = mp.SPTrainer(ds, tcfg)
        trainer.train(checkpoint_dir=str(tmp_path / where), resume=resume)
        return trainer

    full = run(2, "a")
    run(1, "b")
    resumed = run(2, "b", resume=True)
    assert resumed.global_steps == full.global_steps == 4
    for k, v in full.state.params.items():
        assert v.equal(resumed.state.params[k]), k
    assert resumed.train_loss_per_epoch == full.train_loss_per_epoch[1:]


@pytest.mark.parametrize("name,slice_name", [
    ("TPTrainer", "ROADMAP §1 item 10, third part")])
def test_later_trainers_name_their_slice(name, slice_name):
    """Every trainer of the JAX package is ported: the one that named its
    slice (``slice_name``) until that slice landed now trains, with
    JAX's mode and label."""
    _, tcfg = _configs(batch_size=2)
    trainer = getattr(mp, name)(_dataset(32, n_train=2), tcfg)
    assert trainer.mode == getattr(jmp, name).mode
    assert trainer._label() == "tp 2x2"
    metrics = trainer.train()
    assert metrics["global_steps_completed"] == 1
    assert np.isfinite(trainer.train_loss_per_epoch).all()


def test_vit_shapes_and_config_defaults_match_jax():
    assert mp.VIT_SHAPES == jmp.VIT_SHAPES
    j, t = jmp.ModelParallelConfig(), mp.ModelParallelConfig()
    # Every JAX field, with its default.
    honoured = ("model", "num_workers", "tp_degree", "pp_microbatches",
                "dp_degree", "pp_tp_degree", "moe_capacity_factor",
                "moe_aux_weight", "learning_rate", "num_epochs",
                "batch_size", "augment", "num_classes", "dtype", "seed")
    assert set(j.__dataclass_fields__) == set(honoured)
    assert set(t.__dataclass_fields__) == {*honoured, "device"}
    for field in honoured:
        assert getattr(t, field) == getattr(j, field), field
    assert t.device == "cuda"


def _step_both(jt, tt):
    """One epoch of one step in both trainers from the JAX trainer's
    initial weights (loaded through the adapter, checked byte for byte
    on the way back); returns (JAX metrics, port metrics, initial flat
    params)."""
    init = jax_flatten(jax.device_get(jt.state.params))
    tt.model.load_state_dict(params_from_jax(init))
    back, _ = params_to_jax(tt.model)
    assert set(back) == set(init)
    for k in init:
        assert back[k].tobytes() == np.asarray(init[k]).tobytes(), k
    jm, tm = jt.train(), tt.train()
    assert jt.global_steps == tt.global_steps == 1
    want = jax_flatten(jax.device_get(jt.state.params))
    got, _ = params_to_jax(tt.model)
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
        moved += not np.array_equal(got[k], init[k])
    assert moved > 0
    assert all(np.array_equal(v.numpy(), got[k])
               for k, v in tt.state.params.items())
    assert set(tm) == set(jm)
    assert tm["final_test_accuracy"] == jm["final_test_accuracy"]
    return jm, tm, init


def test_moe_step_matches_jax(devices):
    """vit_tiny with 4 experts a block (capacity max(8, 2 x 8 x 64 / 4 /
    4) = 64), batch 8, aux weight 0.01: params, the three MoE metrics and
    the run's metric keys."""
    ds = _dataset(32, n_train=8, n_test=8)
    jcfg, tcfg = _configs(batch_size=8)
    jcfg.num_workers = tcfg.num_workers = 4
    jt, tt = jmp.MoETrainer(ds, jcfg), mp.MoETrainer(ds, tcfg)
    assert tt.capacity == jt.capacity == 64
    jm, tm, _ = _step_both(jt, tt)
    for key in ("n_experts", "expert_capacity", "moe_dp_degree",
                "moe_aux_weight", "moe_capacity_factor", "mode"):
        assert tm[key] == jm[key], key
    (want,), (got,) = jt._moe_step_metrics, tt._moe_step_metrics
    assert set(got) == set(want) == {"moe_aux_loss", "moe_load_imbalance",
                                     "moe_drop_frac"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert 0.0 <= float(got["moe_drop_frac"]) <= 1.0


def test_pp_step_matches_jax(devices):
    """vit_tiny as 2 stages of 2 blocks over 4 microbatches of 2: the
    ``{prologue, stages, epilogue}`` tree carried both ways, params after
    one step."""
    ds = _dataset(32, n_train=8, n_test=8)
    jcfg, tcfg = _configs(batch_size=8, pp_microbatches=4)
    jt, tt = jmp.PipelineTrainer(ds, jcfg), mp.PipelineTrainer(ds, tcfg)
    assert tt.state.params["stages/block_0/attn/qkv/kernel"].shape == \
        (2, 192, 576)
    assert tt.state.params["stages/block_1/ln2/scale"].shape == (2, 192)
    jm, tm, _ = _step_both(jt, tt)
    for key in ("pp_microbatches", "dp_degree", "pp_tp_degree", "mode"):
        assert tm[key] == jm[key], key


@pytest.mark.parametrize("mode,kw,match", [
    ("moe", dict(model="resnet18"), "supports ViT models"),
    ("moe", dict(batch_size=6), "not divisible by 4 token shards"),
    ("moe", dict(batch_size=16), "smaller than the batch"),
    ("pp", dict(model="resnet18"), "supports ViT models"),
    ("pp", dict(num_workers=3), "depth 4 not divisible by 3"),
    ("pp", dict(pp_microbatches=16), "smaller than pp_microbatches"),
    ("pp", dict(batch_size=6), "must split into 4 microbatches"),
])
def test_moe_and_pp_errors_match_jax(mode, kw, match):
    ds = _dataset(32, n_train=8, n_test=8)
    jcfg, tcfg = _configs(batch_size=8, pp_microbatches=4)
    for cfg in (jcfg, tcfg):
        cfg.num_workers = 4 if mode == "moe" else 2
        for k, v in kw.items():
            setattr(cfg, k, v)
    name = {"moe": "MoETrainer", "pp": "PipelineTrainer"}[mode]
    with pytest.raises(ValueError, match=match):
        getattr(jmp, name)(ds, jcfg)
    with pytest.raises(ValueError, match=match):
        getattr(mp, name)(ds, tcfg)


def test_dp_ep_step_matches_jax(devices):
    """dp x ep: ``MoETrainer`` at data 2 x 4 experts (8 token shards,
    capacity max(8, 2 x 64 / 4) = 32) against JAX's on 8 devices: mesh,
    params, the MoE metrics."""
    ds = _dataset(32, n_train=8, n_test=8)
    jcfg, tcfg = _configs(batch_size=8, dp_degree=2)
    jcfg.num_workers = tcfg.num_workers = 4
    jt, tt = jmp.MoETrainer(ds, jcfg), mp.MoETrainer(ds, tcfg)
    assert tt.mesh.shape == jt.mesh.shape == {"data": 2, "expert": 4}
    assert tt.capacity == jt.capacity == 32
    jm, tm, _ = _step_both(jt, tt)
    assert tm["moe_dp_degree"] == jm["moe_dp_degree"] == 2
    (want,), (got,) = jt._moe_step_metrics, tt._moe_step_metrics
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_dp_tp_pp_step_matches_jax(devices):
    """dp x tp x pp: ``PipelineTrainer`` at data 2 x model 2 x 2 stages, 4
    microbatches of 2 (one row a data slot), against JAX's on 8
    devices: mesh, label, params after one step."""
    ds = _dataset(32, n_train=8, n_test=8)
    jcfg, tcfg = _configs(batch_size=8, pp_microbatches=4, dp_degree=2,
                          pp_tp_degree=2)
    jt, tt = jmp.PipelineTrainer(ds, jcfg), mp.PipelineTrainer(ds, tcfg)
    assert tt.mesh.shape == dict(jt.mesh.shape) == \
        {"data": 2, "model": 2, "stage": 2}
    assert tt._label() == jt._label() == \
        "pp 2 stages x4 microbatches x dp2 x tp2"
    jm, tm, _ = _step_both(jt, tt)
    for key in ("pp_microbatches", "dp_degree", "pp_tp_degree"):
        assert tm[key] == jm[key] == jcfg.__dict__[key], key


@pytest.mark.parametrize("name", ["MoETrainer", "PipelineTrainer"])
@pytest.mark.parametrize("field", ["dp_degree", "pp_tp_degree"])
def test_composed_meshes_name_item_10_part_3(name, field):
    """The composed meshes that item 10's third part brought: each
    trainer builds JAX's mesh for the field at 2 and trains a step
    (``MoETrainer`` reads no ``pp_tp_degree``, as JAX's)."""
    _, tcfg = _configs(batch_size=8, pp_microbatches=4)
    setattr(tcfg, field, 2)
    trainer = getattr(mp, name)(_dataset(32, n_train=8, n_test=8), tcfg)
    want = {("MoETrainer", "dp_degree"): {"data": 2, "expert": 2},
            ("MoETrainer", "pp_tp_degree"): {"expert": 2},
            ("PipelineTrainer", "dp_degree"):
                {"data": 2, "model": 1, "stage": 2},
            ("PipelineTrainer", "pp_tp_degree"):
                {"data": 1, "model": 2, "stage": 2}}[name, field]
    assert trainer.mesh.shape == want
    assert list(trainer.mesh.shape) == list(want)
    assert trainer.train()["global_steps_completed"] == 1
    assert np.isfinite(trainer.train_loss_per_epoch).all()


@pytest.mark.parametrize("mode", ["moe", "pp"])
def test_moe_and_pp_trainers_resume_from_their_checkpoint(tmp_path, mode):
    """A checkpoint each epoch; a run resumed from epoch 1 ends bit-equal
    to the uninterrupted one (the stacked stage leaves included)."""
    ds = _dataset(32, n_train=4, n_test=4)
    cls = {"moe": mp.MoETrainer, "pp": mp.PipelineTrainer}[mode]

    def run(epochs, where, resume=False):
        _, tcfg = _configs(batch_size=2, pp_microbatches=2)
        tcfg.num_epochs, tcfg.augment = epochs, True
        trainer = cls(ds, tcfg)
        trainer.train(checkpoint_dir=str(tmp_path / where), resume=resume)
        return trainer

    full = run(2, "a")
    run(1, "b")
    resumed = run(2, "b", resume=True)
    assert resumed.global_steps == full.global_steps == 4
    for k, v in full.state.params.items():
        assert v.equal(resumed.state.params[k]), k


@pytest.mark.parametrize("mode,workers,extra", [
    ("moe", "4", ["--moe-capacity-factor", "1.0", "--moe-aux-weight",
                  "0.0"]),
    ("pp", "2", ["--pp-microbatches", "4"])])
def test_cli_trains_moe_and_pp(capsys, mode, workers, extra):
    rc = cli.main(["train", "--mode", mode, "--model", "vit_tiny",
                   "--workers", workers, "--epochs", "1", "--dataset",
                   "imagenet-synth", "--image-size", "32", "--num-train",
                   "16", "--num-test", "8", "--batch-size", "8",
                   "--emit-metrics", "--device", "cpu", "--dtype",
                   "float32", *extra])
    assert rc == 0
    (row,) = parse_metrics_lines(capsys.readouterr().out)
    assert row["mode"] == mode and row["global_steps_completed"] == 2
    if mode == "moe":
        # max(8, int(1.0 * (8 x 64 / 4) / 4))
        assert row["expert_capacity"] == 32 and row["moe_aux_weight"] == 0.0
        assert 0.0 <= row["moe_drop_frac"] <= 1.0
    else:
        assert row["pp_microbatches"] == 4
    json.dumps(row)


@pytest.mark.parametrize("argv", [
    ["--mode", "tp"], ["--mode", "pp", "--dp-degree", "2"],
    ["--mode", "pp", "--pp-tp-degree", "2"],
    ["--mode", "tp", "--tp-degree", "4"]])
def test_cli_refuses_item_10_part_3(capsys, argv):
    """What the CLI refused until item 10's third part, it now trains:
    ``--mode tp`` and the composed pp flags, with JAX's metric fields."""
    rc = cli.main(["train", *argv, "--model", "vit_tiny", "--workers", "2",
                   "--epochs", "1", "--dataset", "imagenet-synth",
                   "--image-size", "32", "--num-train", "8", "--num-test",
                   "8", "--batch-size", "8", "--pp-microbatches", "2",
                   "--emit-metrics", "--device", "cpu"])
    assert rc == 0
    (row,) = parse_metrics_lines(capsys.readouterr().out)
    assert row["mode"] == argv[1] and row["global_steps_completed"] == 1
    for flag, value in zip(argv[2::2], argv[3::2]):
        assert row[flag[2:].replace("-", "_")] == int(value), flag
    if argv[1] == "tp":
        assert row["tp_degree"] == int(dict(zip(argv[::2], argv[1::2])).get(
            "--tp-degree", 2))


@pytest.mark.parametrize("image,n_train,n_test,seed", [
    (64, 40, 12, 0), (64, 7, 3, 5), (32, 1200, 2, 1)])
def test_synthetic_imagenet_is_byte_equal_to_jax(image, n_train, n_test,
                                                 seed):
    """The same draws in the same order, 1,000 classes; the port builds
    only the templates of the labels it draws."""
    want = jcifar.synthetic_imagenet(n_train=n_train, n_test=n_test,
                                     image_size=image, seed=seed)
    got = cifar.synthetic_imagenet(n_train=n_train, n_test=n_test,
                                   image_size=image, seed=seed)
    assert got.num_classes == want.num_classes == 1000 and got.synthetic
    for a, b in ((got.x_train, want.x_train), (got.y_train, want.y_train),
                 (got.x_test, want.x_test), (got.y_test, want.y_test)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
