"""The port's entry points: ``cli train --mode async`` and ``--mode
sync`` end to end on the CPU (full-width ResNet-18, two steps each), and
the options of later slices refused by name."""

import json

import pytest

from distributed_parameter_server_for_ml_training_tpu_torch import cli
from distributed_parameter_server_for_ml_training_tpu_torch.ps import \
    WorkerConfig
from distributed_parameter_server_for_ml_training_tpu_torch.train \
    .distributed import DistributedConfig
from distributed_parameter_server_for_ml_training_tpu_torch.utils.metrics \
    import parse_metrics_lines


def test_cli_train_async_on_cpu(capsys):
    rc = cli.main(["train", "--mode", "async", "--workers", "1",
                   "--epochs", "1", "--synthetic", "--num-train", "64",
                   "--num-test", "16", "--batch-size", "32",
                   "--emit-metrics", "--device", "cpu", "--dtype",
                   "float32"])
    assert rc == 0
    rows = parse_metrics_lines(capsys.readouterr().out)
    server, worker = rows
    assert server["mode"] == "async" and server["store_backend"] == "python"
    assert server["global_steps_completed"] == 2
    assert worker["local_steps_completed"] == 2
    assert len(worker["train_loss_per_epoch"]) == 1
    json.dumps(rows)


@pytest.mark.parametrize("field,value", [
    ("overlap", True), ("heartbeat_interval", 5.0),
    ("reconnect_timeout", 10.0), ("nan_inject_step", 3),
    ("k_step_mode", "local_sgd")])
def test_worker_options_of_later_slices_are_refused(field, value):
    """The JAX worker's options that earlier slices refused came with
    ROADMAP §1 item 3: each is accepted now and kept as given."""
    assert getattr(WorkerConfig(device="cpu", **{field: value}),
                   field) == value


def test_worker_config_validation():
    with pytest.raises(ValueError):
        WorkerConfig(device="cpu", k_step_mode="bogus")
    with pytest.raises(ValueError):
        WorkerConfig(device="cpu", sync_steps=0)
    assert WorkerConfig(device="cpu", k_step_mode="accumulate",
                        sync_steps=2).sync_steps == 2


@pytest.mark.parametrize("compression", ["int8", "none"])
def test_cli_train_sync_on_cpu(capsys, compression):
    rc = cli.main(["train", "--mode", "sync", "--workers", "2",
                   "--compression", compression, "--epochs", "1",
                   "--synthetic", "--num-train", "32", "--num-test", "16",
                   "--batch-size", "8", "--emit-metrics", "--device", "cpu",
                   "--dtype", "float32"])
    assert rc == 0
    rows = parse_metrics_lines(capsys.readouterr().out)
    server, *workers = rows
    assert server["mode"] == "sync" and server["total_workers"] == 2
    assert server["global_steps_completed"] == 2
    assert [w["worker_id"] for w in workers] == [0, 1]
    assert all(w["local_steps_completed"] == 2 for w in workers)
    assert all(len(w["train_loss_per_epoch"]) == 1 for w in workers)
    json.dumps(rows)


def test_sync_trainer_waits_for_its_slice():
    """Sync mode is ported; a mesh over several cards in one process
    points at ``--multihost`` (one process per card)."""
    from distributed_parameter_server_for_ml_training_tpu_torch.data import \
        synthetic_cifar100
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import make_mesh
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .distributed import SyncTrainer
    cfg = DistributedConfig(mode="sync", device="cpu", num_workers=2)
    assert cfg.compression == "bf16"
    SyncTrainer(synthetic_cifar100(n_train=16, n_test=8), cfg)
    with pytest.raises(NotImplementedError, match="--multihost"):
        make_mesh(2, ["cuda:0", "cuda:1"])
    with pytest.raises(ValueError):
        DistributedConfig(mode="tp", device="cpu")
    with pytest.raises(ValueError):
        DistributedConfig(mode="sync", compression="int4", device="cpu")


@pytest.mark.parametrize("dataset", ["cifar100", "imagenet-synth"])
def test_cli_train_sp_on_cpu(capsys, dataset):
    """``--mode sp``: vit_tiny over 2 sequence slots (the dense ring on the
    CPU), on synthetic CIFAR-100 (64 tokens) or on synthetic ImageNet at
    64 px (256 tokens)."""
    data = ["--synthetic"] if dataset == "cifar100" else [
        "--dataset", "imagenet-synth", "--image-size", "64"]
    rc = cli.main(["train", "--mode", "sp", "--model", "vit_tiny",
                   "--workers", "2", "--epochs", "1", *data,
                   "--num-train", "8", "--num-test", "4", "--batch-size",
                   "4", "--emit-metrics", "--device", "cpu", "--dtype",
                   "float32"])
    assert rc == 0
    (row,) = parse_metrics_lines(capsys.readouterr().out)
    assert row["mode"] == "sp" and row["seq_shards"] == 2
    assert row["tokens"] == (64 if dataset == "cifar100" else 256)
    assert row["global_steps_completed"] == 2
    json.dumps(row)


def test_cli_sp_refuses_what_it_does_not_train():
    """sp trains a ViT; a ResNet under --mode sp is refused (every other
    mode trains every registry model)."""
    with pytest.raises(ValueError, match="--mode sp supports ViT"):
        cli.main(["train", "--mode", "sp", "--model", "resnet50",
                  "--device", "cpu", "--synthetic", "--num-train", "8",
                  "--num-test", "4"])

