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
                     "utils/collective_bytes.py", "parallel/multihost.py",
                     "parallel/moe.py", "parallel/pipeline.py",
                     "parallel/tensor.py", "ps/sharding.py",
                     "comms/sharded.py", "native/__init__.py",
                     "native/bindings.py", "native/store.py",
                     "telemetry/fleet.py", "analysis/incidents.py",
                     "analysis/parse_logs.py", "analysis/fleet_series.py",
                     "analysis/pod_logs.py", "analysis/runner.py",
                     "analysis/visualize.py", "comms/faults.py",
                     "comms/replica.py", "comms/loadgen.py",
                     "telemetry/autoscale.py", "ps/supervisor.py"):
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


@pytest.mark.parametrize("module", ["parallel.moe", "parallel.pipeline",
                                    "train.model_parallel"])
def test_model_parallel_over_ranks_modules_load_no_jax(module):
    """The MoE and pipeline modules and the trainers that spread experts
    and stages over ranks, imported in a fresh interpreter, load no
    module of jax and none of the JAX package."""
    name = f"distributed_parameter_server_for_ml_training_tpu_torch.{module}"
    probe = (f"import sys, {name}; print(sorted(m for m in sys.modules "
             f"if m.split('.')[0] in {FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("module", ["ps.sharding", "comms.sharded",
                                    "native.store", "comms.faults",
                                    "comms.replica", "comms.loadgen",
                                    "telemetry.autoscale",
                                    "ps.supervisor"])
def test_serve_tier_modules_load_no_jax(module):
    """The shard partition, the sharded client, the C++ arena's store,
    the fault injector, the replica, the load generator, the autoscaler
    and the replica pool, imported in a fresh interpreter, load no module
    of jax and none of the JAX package."""
    name = f"distributed_parameter_server_for_ml_training_tpu_torch.{module}"
    probe = (f"import sys, {name}; print(sorted(m for m in sys.modules "
             f"if m.split('.')[0] in {FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("module", ["comms.replica", "comms.loadgen",
                                    "telemetry.autoscale", "ps.supervisor",
                                    "cli"])
def test_serve_tier_host_modules_load_no_torch(module):
    """The replica, the load generator, the autoscaler, the replica pool
    and the CLI module are host code: imported in a fresh interpreter,
    they load no torch (a ``cli replica`` process starts in well under a
    second instead of paying torch's import)."""
    name = f"distributed_parameter_server_for_ml_training_tpu_torch.{module}"
    probe = f"import sys, {name}; print('torch' in sys.modules)"
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False", out.stdout


#: What ``cmd_reshard`` and ``_cmd_supervise`` run inside their
#: processes, with every telemetry surface on: the coordinator's client
#: and a reshard plan; the supervisor, the autoscaler's policy head, one
#: supervised child (a bare interpreter) and the snapshot emitter's and
#: metrics endpoint's final flush.
_HOST_VERB_PROBE = """
import sys
from distributed_parameter_server_for_ml_training_tpu_torch import cli
args = cli.build_parser().parse_args(
    ["supervise", "--telemetry", "--telemetry-interval", "0.05",
     "--metrics-port", "0", "--trace", "--", "--server", "h:1"])
with cli._telemetry_session(args, "supervisor"):
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .client import RemoteStore
    from distributed_parameter_server_for_ml_training_tpu_torch.ps \
        .supervisor import SupervisorConfig, WorkerSupervisor
    from distributed_parameter_server_for_ml_training_tpu_torch \
        .telemetry.remediation import (WorkerAutoscalePolicy,
                                       WorkerAutoscaler)
    RemoteStore("127.0.0.1:1").close()
    cli._reshard_plan({"shard_map": {"version": 1, "shards": [
        {"slot_range": [0, 32]}, {"slot_range": [32, 64]}]}},
        0, 1, 16, 32, 2, "m", 30.0)
    sup = WorkerSupervisor(
        lambda slot, attempt: ([sys.executable, "-c", "pass"], None), 1,
        SupervisorConfig(poll_interval=0.01))
    WorkerAutoscaler("j", lambda: {}, supervisor=sup,
                     policy=WorkerAutoscalePolicy()).tick()
    sup.start()
    assert sup.run() == 0
print("torch" in sys.modules)
"""


def test_reshard_and_supervise_processes_load_no_torch():
    """``cli reshard`` and ``cli supervise`` are host code: what their
    commands import and run, under ``_telemetry_session`` with the
    snapshot emitter, the metrics endpoint and tracing on, leaves torch
    unloaded in a fresh interpreter (only the supervised children touch
    the card)."""
    out = subprocess.run([sys.executable, "-c", _HOST_VERB_PROBE],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "False", out.stdout


def _closure(module: str) -> set:
    """The port's modules ``module`` reaches through its imports, at any
    depth and wherever they stand (inside functions too), by the AST."""
    seen, todo = set(), [module]
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        rel = name.split(".")
        path = PORT.joinpath(*rel).with_suffix(".py")
        if not path.is_file():
            path = PORT.joinpath(*rel, "__init__.py")
        if not path.is_file():
            continue
        pkg = rel if path.name == "__init__.py" else rel[:-1]
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level:
                base = pkg[:len(pkg) - node.level + 1]
                target = ".".join(base + ([node.module] if node.module
                                          else []))
                todo.append(target)
                todo.extend(f"{target}.{a.name}" for a in node.names)
    return {m for m in seen
            if PORT.joinpath(*m.split(".")).with_suffix(".py").is_file()
            or PORT.joinpath(*m.split("."), "__init__.py").is_file()}


@pytest.mark.parametrize("module", [
    "telemetry.fleet", "analysis.incidents", "analysis.parse_logs",
    "analysis.fleet_series", "analysis.pod_logs", "analysis.runner",
    "analysis.visualize", "cli"])
def test_fleet_and_analysis_modules_reach_no_jax(module):
    """The fleet observatory, the analysis modules and the CLI that
    drives them: no module they reach imports jax or the JAX package,
    and matplotlib is imported only inside the functions that draw."""
    reached = _closure(module)
    assert module in reached
    for name in reached:
        rel = name.split(".")
        path = PORT.joinpath(*rel).with_suffix(".py")
        if not path.is_file():
            path = PORT.joinpath(*rel, "__init__.py")
        bad = [m for m in _imports(path) if _forbidden(m)]
        assert not bad, f"{name} imports {bad}"
    tree = ast.parse((PORT / "analysis" / "visualize.py").read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    assert not any("matplotlib" in ast.unparse(n) for n in top)


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
    sharded client, the serve tier (fault injector, replica, load
    generator), the telemetry, the packed int4 type, (lazily) the fetch
    codecs and, of ``ps/``, only the shard partition and the tenancy
    table (plain Python, as the JAX service and client import them):
    never a store."""
    allowed = {"comms", "comms.wire", "comms.service", "comms.client",
               "comms.sharded", "comms.faults", "comms.replica",
               "comms.loadgen", "telemetry", "telemetry.registry",
               "telemetry.trace", "telemetry.journal", "telemetry.stats",
               "ops.packed", "ops.compression", "ps.sharding",
               "ps.tenancy"}
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


def test_moe_and_pp_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from distributed_parameter_server_for_ml_training_tpu_torch import cli
    from distributed_parameter_server_for_ml_training_tpu_torch.data import \
        synthetic_imagenet
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import make_mesh
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .model_parallel import MoETrainer, PipelineTrainer
    # The default config's batch of 128 needs a test set of 128.
    ds = synthetic_imagenet(n_train=8, n_test=128, image_size=32)
    for axis in ("expert", "stage"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(2, axis_names=(axis,))
    for trainer in (MoETrainer, PipelineTrainer):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trainer(ds)
    for mode in ("moe", "pp"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["train", "--mode", mode, "--model", "vit_tiny",
                      "--workers", "2", "--epochs", "1", "--dataset",
                      "imagenet-synth", "--image-size", "32",
                      "--num-train", "8", "--num-test", "8",
                      "--batch-size", "8", "--pp-microbatches", "2"])


def test_tp_entry_points_default_to_cuda():
    """``TPTrainer``, the multi-axis meshes and ``cli train --mode tp``
    (and the composed flags) default to the card."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from distributed_parameter_server_for_ml_training_tpu_torch import cli
    from distributed_parameter_server_for_ml_training_tpu_torch.data import \
        synthetic_imagenet
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import make_mesh, mesh_from_shape
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .model_parallel import TPTrainer
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(2, axis_names=("data", "model"), num_slots=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_from_shape({"data": 1, "model": 2, "stage": 2})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TPTrainer(synthetic_imagenet(n_train=8, n_test=8, image_size=32))
    for argv in (["--mode", "tp", "--tp-degree", "4"],
                 ["--mode", "pp", "--dp-degree", "2", "--pp-tp-degree",
                  "2"], ["--mode", "moe", "--dp-degree", "2"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["train", *argv, "--model", "vit_tiny", "--workers",
                      "2", "--epochs", "1", "--dataset", "imagenet-synth",
                      "--image-size", "32", "--num-train", "8",
                      "--num-test", "8", "--batch-size", "8",
                      "--pp-microbatches", "2"])


def test_later_flags_name_only_items_8_and_9():
    """The CLI refuses only ``perf check``, which waits for ROADMAP item
    11 (port tooling); no flag is refused any more. Item 10's third
    part serves ``--tp-degree``, ``--dp-degree`` and ``--pp-tp-degree``
    at every value (the meshes of two and three axes). Item 8's flags are
    served since its second part (``--telemetry``, ``--metrics-port``,
    ``--incidents-dir``, ``--no-memory-telemetry``, the profile
    triggers, ``--profile-dir``), as are the store options and worker
    modes of item 3, the device store of item 4, the checkpoints of item
    5 and the health monitor, SLO and remediation flags of item 8's first
    part, since item 9's first part ``--store-backend native``, the
    ``serve --shard-*`` flags and ``worker --shards``, and since its
    serve tier ``--faults`` (its spec arming the JAX package's schedule),
    ``serve --autoscale*`` and the verbs ``replica``, ``loadgen`` and
    ``infer``, and since its parts 2 and 5 the verbs ``reshard`` and
    ``supervise``, and since its part 6 tenancy's ``--jobs`` and
    ``--job``."""
    from distributed_parameter_server_for_ml_training_tpu_torch import cli
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        import client, loadgen, service
    items = set()
    for where in cli.LATER_VERBS.values():
        items |= {int(n) for n in re.findall(r"item (\d+)", where)}
    assert items == {11}
    for mod, name in ((cli, "LATER_FLAGS"), (service, "LATER"),
                      (client, "_LATER"), (loadgen, "TENANCY")):
        assert not hasattr(mod, name), name
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
                  "--journal-dir", "j", "--profile-dir", "d"],
                 ["train", "--mode", "moe", "--moe-capacity-factor", "1.5",
                  "--moe-aux-weight", "0"],
                 ["train", "--mode", "pp", "--pp-microbatches", "4",
                  "--tp-degree", "2", "--dp-degree", "1",
                  "--pp-tp-degree", "1"]):
        parser.parse_args(argv)
    for flag in ("--tp-degree", "--dp-degree", "--pp-tp-degree"):
        for mode in ("tp", "pp", "moe"):
            args = parser.parse_args(["train", "--mode", mode, flag, "4"])
            assert getattr(args, flag[2:].replace("-", "_")) == 4
    for argv in (["serve", "--store-backend", "native", "--shard-count",
                  "2", "--shard-index", "1", "--shard-peers", "a:1,b:2"],
                 ["train", "--store-backend", "native"],
                 ["worker", "--shards", "a:1,b:2"]):
        parser.parse_args(argv)
    from distributed_parameter_server_for_ml_training_tpu.comms import \
        faults as jfaults
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        import faults
    for argv in (["serve", "--faults", "seed=1;push.unavailable@p=0.3"],
                 ["worker", "--faults", "fetch.drop_reply@n=2"],
                 ["serve", "--autoscale", "--autoscale-min", "1",
                  "--autoscale-max", "2", "--autoscale-qps-high", "9"],
                 ["replica", "--primary", "a:1", "--canary"],
                 ["loadgen", "--targets", "a:1"],
                 ["infer", "--target", "a:1"],
                 ["reshard", "--primaries", "a:1,b:2", "--donor", "0",
                  "--recipient", "1", "--slots", "16:32",
                  "--migration-id", "m", "--lease-ttl", "5",
                  "--crash-after", "import"],
                 ["reshard", "--primaries", "a:1,b:2", "--donor", "1",
                  "--recipient", "0", "--slots", "32:40", "--resume"],
                 ["supervise", "--workers", "3", "--respawn-backoff",
                  "0.5", "--slot-faults", "0:seed=7;push.kill@n=2",
                  "--autoscale-job", "vision", "--autoscale-url",
                  "http://a:1", "--device", "cpu", "--telemetry", "--",
                  "--server", "a:1"]):
        args = parser.parse_args(argv)
        spec = getattr(args, "faults", None)
        if spec:
            for op in ("PushGradrients", "FetchParameters"):
                assert faults.FaultInjector(spec).schedule_preview(op, 20) \
                    == jfaults.FaultInjector(spec).schedule_preview(op, 20)
    for argv, dest in ((["serve", "--jobs", "a:weight=2;b"], "jobs"),
                       (["worker", "--job", "vision"], "job"),
                       (["loadgen", "--targets", "a:1", "--job",
                         "vision,ranker"], "job")):
        assert getattr(parser.parse_args(argv), dest) == argv[-1]
    with pytest.raises(NotImplementedError, match="item 11"):
        cli.main(["perf", "check"])
