"""The port imports no jax/flax/optax/orbax/chex and nothing of the JAX
package, and never continues on the CPU when CUDA is asked for."""

import ast
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "distributed_parameter_server_for_ml_training_tpu_torch"
FORBIDDEN = ("jax", "flax", "optax", "orbax", "chex",
             "distributed_parameter_server_for_ml_training_tpu")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def _files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_files_exist():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    for required in ("cli.py", "data/cifar.py", "models/resnet.py",
                     "models/registry.py", "ops/compression.py",
                     "ops/packed.py", "ops/quantize.py", "ops/_build.py",
                     "ops/device_codec.py", "ps/semantics.py",
                     "ps/store.py", "ps/worker.py", "telemetry/registry.py",
                     "telemetry/spans.py", "telemetry/trace.py",
                     "telemetry/goodput.py", "train/steps.py",
                     "train/distributed.py", "train/optimizers.py",
                     "train/train_state.py", "parallel/mesh.py",
                     "parallel/sync_dp.py", "utils/pytree.py",
                     "utils/metrics.py", "ops/attention.py",
                     "ops/flash_attention.py", "parallel/ring_attention.py",
                     "models/vit.py", "train/model_parallel.py",
                     "train/baseline.py", "train/device_loop.py",
                     "comms/__init__.py", "comms/wire.py",
                     "comms/service.py", "comms/client.py",
                     "ps/device_store.py", "telemetry/journal.py",
                     "checkpoint/__init__.py", "checkpoint/manager.py",
                     "telemetry/health.py", "telemetry/cluster.py",
                     "telemetry/slo.py", "telemetry/stats.py",
                     "telemetry/remediation.py", "telemetry/snapshot.py",
                     "telemetry/prometheus.py", "telemetry/memory.py",
                     "telemetry/incidents.py", "telemetry/profiler.py",
                     "telemetry/proftrigger.py", "utils/tracing.py",
                     "analysis/__init__.py", "analysis/traces.py",
                     "analysis/device_profile.py",
                     "utils/collective_bytes.py", "parallel/multihost.py"):
        assert required in names, required
    for kernel in ("wire_quantize.cu", "block_quantize.cu",
                   "flash_attention.cu"):
        assert (PORT / "ops" / "csrc" / kernel).is_file(), kernel


@pytest.mark.parametrize("path", _files(), ids=lambda p: p.name)
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("module", ["utils.collective_bytes",
                                    "parallel.ring_attention"])
def test_sp_multihost_modules_load_no_jax(module):
    """The byte counter and the ring over ranks, imported in a fresh
    interpreter, load no module of jax and none of the JAX package."""
    name = f"distributed_parameter_server_for_ml_training_tpu_torch.{module}"
    probe = (f"import sys, {name}; print(sorted(m for m in sys.modules "
             f"if m.split('.')[0] in {FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_scan_catches_a_jax_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\n"
                 "from distributed_parameter_server_for_ml_training_tpu"
                 ".ops import packed\n")
    assert [m for m in _imports(f) if _forbidden(m)] == [
        "jax.numpy", "distributed_parameter_server_for_ml_training_tpu.ops"]


def _cuda_entry_points():
    from distributed_parameter_server_for_ml_training_tpu_torch.models \
        import get_model
    from distributed_parameter_server_for_ml_training_tpu_torch.ops \
        .device_codec import DeviceCodec
    from distributed_parameter_server_for_ml_training_tpu_torch.ps \
        import WorkerConfig
    from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
        import read_device_memory
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .baseline import BaselineConfig
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .distributed import DistributedConfig
    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        import resolve_device
    return {
        "resolve_device": lambda: resolve_device("cuda"),
        "get_model": lambda: get_model("resnet18"),
        "DeviceCodec": lambda: DeviceCodec(),
        "WorkerConfig": lambda: WorkerConfig(),
        "DistributedConfig": lambda: DistributedConfig(),
        "BaselineConfig": lambda: BaselineConfig(),
        "read_device_memory": lambda: read_device_memory(),
        "read_device_memory_cuda_1": lambda: read_device_memory("cuda:1"),
    }


@pytest.mark.parametrize("entry", ["resolve_device", "get_model",
                                   "DeviceCodec", "WorkerConfig",
                                   "DistributedConfig", "BaselineConfig",
                                   "read_device_memory",
                                   "read_device_memory_cuda_1"])
def test_cuda_default_raises_without_a_card(entry):
    """Each entry point runs on the card unless asked for the CPU, and
    raises without one; the memory reader of a ``cuda`` device raises
    rather than reading as None (the CPU's reading)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _cuda_entry_points()[entry]()


def test_cli_device_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from distributed_parameter_server_for_ml_training_tpu_torch import cli
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train", "--workers", "1", "--epochs", "1", "--synthetic",
                  "--num-train", "64", "--num-test", "16"])


def test_wire_quantize_counts_only_kernel_launches():
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q
    before = Q.wire_quantize_multi.launches
    Q.wire_quantize(torch.ones(300), 0.5)
    assert Q.wire_quantize_multi.launches == before
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        Q.wire_quantize_flat(torch.ones(4, device="meta"), 0.5, 127)


@pytest.mark.parametrize("kernel", ["wire_quantize", "block_quantize",
                                    "flash_attention"])
def test_nvcc_command_flags(kernel):
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        _build
    cmd = _build.nvcc_command(_build.CSRC / f"{kernel}.cu",
                              pathlib.Path("out.so"))
    joined = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in joined
    assert "--fmad=false" in cmd and "-O3" in cmd
    assert "--use_fast_math" not in joined
    lib = _build.library_path(kernel)
    assert lib.parent == _build.BUILD_DIR and lib.name.endswith(".so")
    assert "build" in lib.parts


@pytest.mark.parametrize("kernel", ["wire_quantize", "block_quantize",
                                    "flash_attention"])
def test_build_without_nvcc_raises(monkeypatch, tmp_path, kernel):
    """A kernel that cannot be built raises; nothing falls back."""
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        _build

    def failing_nvcc(cmd, **kwargs):
        assert cmd[0] == _build.nvcc_path()
        return subprocess.CompletedProcess(cmd, 1, "",
                                           "error: no such target")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.subprocess, "run", failing_nvcc)
    with pytest.raises(RuntimeError, match=f"nvcc failed for {kernel}"):
        _build.build(kernel)
    assert list(tmp_path.iterdir()) == []


def test_cli_worker_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from distributed_parameter_server_for_ml_training_tpu_torch import cli
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["worker", "--server", "127.0.0.1:1", "--synthetic",
                  "--num-train", "64", "--num-test", "16", "--epochs", "1"])


def _relative_imports(path: pathlib.Path):
    """Package-relative import targets of one module, resolved."""
    pkg = path.relative_to(REPO).with_suffix("").parts[:-1]
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level:
            base = pkg[:len(pkg) - node.level + 1]
            yield ".".join(base + tuple(filter(None, [node.module])))


def test_comms_imports_nothing_unported():
    """``comms/`` imports only the wire, the service, the client, the
    telemetry, the packed int4 type and (lazily) the fetch codecs: never
    ``ps/``, whose JAX counterpart drags the device store and jax in."""
    allowed = {"comms", "comms.wire", "comms.service", "comms.client",
               "telemetry", "telemetry.registry", "telemetry.trace",
               "ops.packed", "ops.compression"}
    for path in sorted((PORT / "comms").glob("*.py")):
        for target in _relative_imports(path):
            local = target.split(".", 1)[1] if "." in target else ""
            assert local in allowed, f"{path.name} imports {target}"


def test_sync_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import make_mesh
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from distributed_parameter_server_for_ml_training_tpu_torch import \
            cli
        cli.main(["train", "--mode", "sync", "--workers", "1", "--epochs",
                  "1", "--synthetic", "--num-train", "64", "--num-test",
                  "16"])


def test_baseline_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from distributed_parameter_server_for_ml_training_tpu_torch import cli
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train", "--mode", "baseline", "--epochs", "1",
                  "--synthetic", "--num-train", "64", "--num-test", "16"])


def test_sp_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from distributed_parameter_server_for_ml_training_tpu_torch import cli
    from distributed_parameter_server_for_ml_training_tpu_torch.data import \
        synthetic_imagenet
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import make_mesh
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .model_parallel import SPTrainer
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(2, axis_names=("seq",))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SPTrainer(synthetic_imagenet(n_train=2, n_test=2, image_size=32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train", "--mode", "sp", "--model", "vit_tiny",
                  "--workers", "2", "--epochs", "1", "--synthetic",
                  "--num-train", "4", "--num-test", "4"])


def test_later_flags_name_only_items_8_and_9():
    """The CLI refuses only the flags and verbs of later ROADMAP items:
    item 9's (the service's refusals name item 9 too) and ``perf
    check``, which waits for item 11 (port tooling). Item 8's flags are
    served since its second part (``--telemetry``, ``--metrics-port``,
    ``--incidents-dir``, ``--no-memory-telemetry``, the profile
    triggers, ``--profile-dir``), as are the store options and worker
    modes of item 3, the device store of item 4, the checkpoints of item
    5 and the health monitor, SLO and remediation flags of item 8's first
    part; ``--store-backend native`` is refused naming item 9."""
    from distributed_parameter_server_for_ml_training_tpu_torch import cli
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        import client, service
    items = set()
    for where in (*cli.LATER_FLAGS.values(), *cli.LATER_VERBS.values()):
        items |= {int(n) for n in re.findall(r"item (\d+)", where)}
    assert items == {9, 11}
    for text in (*service.LATER.values(), *client._LATER.values()):
        assert {int(n) for n in re.findall(r"item (\d+)", text)} \
            <= {8, 9}, text
    assert set(cli.LATER_FLAGS) == {"faults", "jobs", "job", "shards",
                                    "store_backend"}
    assert set(cli.LATER_VERBS) == {"perf check"}
    parser = cli.build_parser()
    for argv in (["serve", "--fetch-codec", "bf16", "--elastic",
                  "--worker-timeout", "30", "--sync-quorum", "2",
                  "--round-deadline", "5"],
                 ["serve", "--store-backend", "device", "--checkpoint-dir",
                  "d", "--checkpoint-interval", "5", "--restore"],
                 ["serve", "--remediate", "--remediate-dry-run",
                  "--remediation-cooldown", "5", "--quarantine-secs", "9",
                  "--health-interval", "1", "--dead-after", "9",
                  "--straggler-lag", "3", "--slo-fetch-p99-ms", "50",
                  "--slo-availability", "0.9", "--slo-fast-window", "10",
                  "--slo-slow-window", "20", "--slo-fast-burn", "2",
                  "--slo-slow-burn", "1"],
                 ["serve", "--no-health-monitor", "--no-slo"],
                 ["serve", "--telemetry", "--telemetry-interval", "1",
                  "--metrics-port", "0", "--trace", "--trace-buffer", "64",
                  "--trace-dump-dir", "t", "--journal-dir", "j",
                  "--incidents-dir", "i", "--incident-window", "9",
                  "--incident-cooldown", "9", "--no-memory-telemetry",
                  "--profile-triggers", "--profiles-dir", "p",
                  "--profile-window", "0.5", "--profile-cooldown", "9",
                  "--goodput-drop-threshold", "0.4", "--profile-dir", "d"],
                 ["worker", "--k-step-mode", "local_sgd", "--local-lr",
                  "0.1", "--overlap", "--heartbeat", "2",
                  "--reconnect-timeout", "60", "--telemetry",
                  "--metrics-port", "0", "--trace", "--profile-dir", "d"],
                 ["train", "--mode", "async", "--k-step-mode", "local_sgd",
                  "--overlap", "--heartbeat", "1", "--reconnect-timeout",
                  "9", "--elastic", "--worker-timeout", "3",
                  "--store-backend", "device", "--strict-rounds",
                  "--checkpoint-dir", "d", "--resume", "--telemetry",
                  "--journal-dir", "j", "--profile-dir", "d"]):
        cli._refuse_later_flags(parser.parse_args(argv))
    for verb in ("serve", "train"):
        with pytest.raises(NotImplementedError, match="item 9"):
            cli._refuse_later_flags(parser.parse_args(
                [verb, "--store-backend", "native"]))
    with pytest.raises(NotImplementedError, match="item 11"):
        cli.main(["perf", "check"])
