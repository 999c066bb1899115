"""The port's perf observatory against the JAX package's
(``…_torch/analysis/traces.py``, ``analysis/device_profile.py``,
``telemetry/profiler.py``, ``utils/tracing.py``): the same span lists,
made from a seed, give equal trace trees, Chrome exports and
critical-path reports; the JAX package's synthetic TPU-style captures
give equal device-time tables, attribution artifacts, diffs and rendered
tables; the card's branch reads a trimmed ``torch.profiler`` capture
taken on an H100 (``tests/torch_cuda_profile_fixture.json.gz``) by its
device-activity categories only; ``step_cost`` counts one matmul and one
unpadded convolution as XLA's cost analysis does. Then the CLI on the
CPU: ``train --mode baseline --device cpu --profile-dir`` (a narrow
ResNet) attributes on ``host_ops`` with each nest of torch ops counted
once, ``perf profile`` and ``perf diff`` exit 0, ``perf check`` is
refused naming its ROADMAP item, and the telemetry flags of ``train``
write snapshot lines, a journal and flight-recorder spans that ``perf
profile --trace-dump-dir`` joins."""

import gzip
import json
import os
import pathlib

import jax
import numpy as np
import pytest
import torch

from distributed_parameter_server_for_ml_training_tpu.analysis import (
    device_profile as JDP, traces as JTR)
from distributed_parameter_server_for_ml_training_tpu.telemetry import \
    profiler as JPF
from distributed_parameter_server_for_ml_training_tpu.utils import \
    tracing as JUT
from distributed_parameter_server_for_ml_training_tpu_torch import cli, \
    models
from distributed_parameter_server_for_ml_training_tpu_torch.analysis import (
    device_profile as PDP, traces as PTR)
from distributed_parameter_server_for_ml_training_tpu_torch.data import \
    synthetic_cifar100
from distributed_parameter_server_for_ml_training_tpu_torch.telemetry import \
    profiler as PPF
from distributed_parameter_server_for_ml_training_tpu_torch.utils import \
    tracing as PUT

FIXTURE = pathlib.Path(__file__).parent / "torch_cuda_profile_fixture.json.gz"


# -- flight-recorder spans: assembly, export, critical path ---------------

def _spans(seed: int) -> list[dict]:
    """Worker steps (compute, fetch wait with a nested codec span, push
    wait with a nested server apply, an overlapped comms subtree), a
    server span reached through the wire, and orphans."""
    rng = np.random.default_rng(seed)
    spans, n = [], [0]

    def span(name, trace, parent, ts, dur, pid=1, role="worker", **attrs):
        n[0] += 1
        sid = f"s{seed}-{n[0]}"
        spans.append({"name": name, "trace_id": trace, "span_id": sid,
                      "parent_id": parent, "ts": round(ts, 6),
                      "dur": round(dur, 6), "role": role, "pid": pid,
                      "tid": 7 + pid, "attrs": attrs})
        return sid

    t = 1000.0
    for step in range(6):
        trace = f"T{seed}-{step}"
        wall = float(rng.uniform(0.05, 0.4))
        root = span("worker.step", trace, None, t, wall, worker=step % 2,
                    step=step, epoch=0, epoch_open=step == 5)
        c = float(rng.uniform(0.2, 0.6)) * wall
        span("worker.compute", trace, root, t, c)
        fw = span("worker.fetch_wait", trace, root, t + c, 0.2 * wall)
        span("worker.codec", trace, fw, t + c, 0.05 * wall)
        pw = span("worker.push_wait", trace, root, t + c + 0.2 * wall,
                  0.25 * wall)
        rpc = span("rpc.server", trace, pw, t + c + 0.21 * wall,
                   0.2 * wall, pid=2, role="server")
        span("store.apply", trace, rpc, t + c + 0.22 * wall, 0.1 * wall,
             pid=2, role="server", staleness=int(rng.integers(0, 4)))
        comms = span("pipeline.comms", trace, root, t, 0.5 * wall)
        span("worker.codec", trace, comms, t, 0.3 * wall)
        t += wall + 0.01
    span("worker.compute", "T-orphan", "missing-parent", t, 0.01)
    span("rpc.server", "T-lone", None, t, 0.02, pid=2, role="server")
    return spans


@pytest.mark.parametrize("seed", [0, 3])
def test_traces_match_jax(seed, tmp_path):
    spans = _spans(seed)
    assert PTR.assemble_traces(spans) == JTR.assemble_traces(spans)
    assert PTR.to_chrome_trace(spans) == JTR.to_chrome_trace(spans)
    for top in (3, 10):
        rep = PTR.critical_path_report(spans, top=top)
        assert rep == JTR.critical_path_report(spans, top=top)
    assert rep["steps"] == 6 and rep["stragglers"][0]["coverage"] > 0.6
    assert PTR.PHASES == JTR.PHASES
    # Dumps on disk: a SIGTERM dump and an atexit dump that overlap.
    for name, part in (("trace-worker-1-sigterm.json", spans[:30]),
                       ("trace-worker-1-exit.json", spans[20:]),
                       ("other.json", spans[:1])):
        with open(tmp_path / name, "w") as f:
            json.dump({"spans": part}, f)
    found = PTR.find_trace_dumps(str(tmp_path))
    assert found == JTR.find_trace_dumps(str(tmp_path)) and len(found) == 2
    assert PTR.load_trace_dumps(found) == JTR.load_trace_dumps(found)
    assert len(PTR.load_trace_dumps(found)) == len(spans)
    out = PTR.save_chrome_trace(spans, str(tmp_path / "x" / "t.json"))
    with open(out) as f:
        assert json.load(f) == JTR.to_chrome_trace(spans)


# -- device-time attribution on the JAX package's synthetic captures ------

def _ev(name, pid, ts, dur, tid=1, **kw):
    return {"ph": "X", "name": name, "pid": pid, "tid": tid, "ts": ts,
            "dur": dur, **kw}


def _meta(pid, name):
    return {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": name}}


TPU_TRACES = {
    "device_lanes": [_meta(1, "/device:TPU:0"), _meta(2, "/host:CPU"),
                     _ev("dot.1", 1, 0, 600.0),
                     _ev("opaque_fusion", 1, 600, 400.0),
                     _ev("all-reduce.2", 1, 1000, 80.0),
                     _ev("quantize_i8.4", 1, 1080, 20.0),
                     _ev("python_frame", 2, 0, 9000.0)],
    "host_ops": [_meta(2, "/host:CPU"), _ev("convolution.687", 2, 0, 500.0),
                 _ev("dot.3", 2, 600, 50.0),
                 _ev("SomePythonFrame", 2, 0, 9000.0),
                 _ev("ThunkExecutor::Execute", 2, 0, 600.0)],
    "host_execute_proxy": [
        _meta(2, "/host:CPU"),
        _ev("ThunkExecutor::Execute (wait for completion)", 2, 0, 1000.0),
        _ev("ThunkExecutor::Execute", 2, 0, 450.0),
        _ev("ThunkExecutor::Execute", 2, 500, 450.0)],
    "none": [],
}


def _capture_dir(root, events, name="host.trace.json"):
    run = root / "plugins" / "profile" / "run1"
    run.mkdir(parents=True)
    (run / name).write_text(json.dumps({"traceEvents": events}))
    return str(root)


@pytest.mark.parametrize("basis", sorted(TPU_TRACES))
def test_device_time_tables_match_jax(basis):
    trace = {"traceEvents": TPU_TRACES[basis]}
    table = PDP.device_time_tables(trace)
    assert table == JDP.device_time_tables(trace)
    assert table["basis"] == basis


def test_attribution_artifacts_and_diffs_match_jax(tmp_path):
    assert PDP.OP_CLASSES == JDP.OP_CLASSES
    for name in ("fusion.all_reduce.dot.3", "dot_general.12",
                 "convolution.687", "quantize_i8.4", "memcpy-h2d",
                 "opaque_fusion_123", "collective-permute.1", "psum.2",
                 "infeed.3", "einsum.4", "dequantize.5", "unpack.6"):
        assert PDP.classify_op(name) == JDP.classify_op(name), name
    tables = [PDP.device_time_tables({"traceEvents": TPU_TRACES[b]})
              for b in ("device_lanes", "host_ops")]
    assert PDP._merge_tables(tables) == JDP._merge_tables(tables)
    critical = JTR.critical_path_report(_spans(1))
    arts = {}
    for pkg, dp in (("port", PDP), ("jax", JDP)):
        for b in ("device_lanes", "host_ops"):
            d = _capture_dir(tmp_path / pkg / b, TPU_TRACES[b])
            arts[pkg, b] = dp.attribute_profile(
                d, critical=critical,
                cost={"flops": 1e9, "bytes_accessed": 2e7},
                mfu_value=0.42, device_kind="TPU v4")
        arts[pkg, "empty"] = dp.attribute_profile(str(tmp_path / "none"))
    for b in ("device_lanes", "host_ops", "empty"):
        assert arts["port", b] == arts["jax", b]
    dev = arts["port", "device_lanes"]
    assert dev["reconciliation"]["attribution_basis"] == "device_lanes"
    assert PDP.render_profile_table(dev) == JDP.render_profile_table(dev)
    other = json.loads(json.dumps(dev))
    other["profile"]["op_classes"]["matmul"]["time_s"] *= 1.5
    del other["profile"]["op_classes"]["collective"]
    other["profile"]["op_classes"]["transfer"] = {
        "time_s": 1e-4, "events": 1, "fraction": 0.1}
    other["reconciliation"]["residual_s"] = 0.5
    for tol in (0.01, 0.6):
        diff = PDP.diff_profiles(dev, other, unchanged_tolerance=tol)
        assert diff == JDP.diff_profiles(dev, other,
                                         unchanged_tolerance=tol)
        assert PDP.render_profile_diff(diff) == JDP.render_profile_diff(diff)
    assert diff["new_classes"] == ["transfer"]
    assert diff["vanished_classes"] == ["collective"]
    for dp in (PDP, JDP):
        with pytest.raises(ValueError, match="attribution basis mismatch"):
            dp.diff_profiles(dev, arts["port", "host_ops"])


# -- the card's branch: a trimmed torch.profiler capture from an H100 -------

def test_card_capture_counts_device_activity_only():
    """The fixture holds the card's lane (kernels, copies, memsets and the
    ``gpu_user_annotation`` ranges that mirror ``record_function``) and
    the host's ops: device time is the sum of the device-activity events,
    the annotations (which cover kernels already counted) count nothing,
    and the host ops on the CPU's lane count nothing either."""
    with gzip.open(FIXTURE, "rt") as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    cats = {e.get("cat") for e in events if e.get("ph") == "X"}
    assert {"kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation",
            "cpu_op"} <= cats
    table = PDP.device_time_tables(trace)
    assert table["basis"] == "device_lanes"
    assert "GPU 0" in table["lanes"] and "GPU 1" not in table["lanes"]
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in PDP.CUDA_DEVICE_CATEGORIES]
    assert table["total_attributed_s"] == pytest.approx(
        sum(e["dur"] for e in device) / 1e6, abs=2e-6)
    assert sum(r["events"] for r in table["op_classes"].values()) \
        == len(device)
    assert sum(r["fraction"] for r in table["op_classes"].values()) \
        == pytest.approx(1.0, abs=1e-3)
    assert table["op_classes"]["conv"]["time_s"] > 0
    assert table["op_classes"]["quantize-pack"]["events"] >= 1
    # Counting the annotations too would add their ranges on top.
    annotations = [e for e in events if e.get("ph") == "X"
                   and e.get("cat") == "gpu_user_annotation"]
    assert annotations and all(
        e["pid"] == device[0]["pid"] for e in annotations)
    top = PDP.top_device_ops(trace, 10)
    assert len(top) == 10 and [r["time_s"] for r in top] == sorted(
        (r["time_s"] for r in top), reverse=True)
    assert not {a["name"] for a in annotations} & {r["name"] for r in top}
    assert {r["class"] for r in top} <= set(PDP.OP_CLASSES)


@pytest.mark.parametrize("name,cls", [
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize64x256x64_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel"
     "__5x_cudnn", "conv"),
    ("sm90_xmma_dgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc"
     "_nhwc_tilesize128x128x64_warpgroupsize1x1x1_g1_strided_execute_"
     "kernel__5x_cudnn", "conv"),
    ("sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc"
     "_nhwc_tilesize128x64x64_warpgroupsize1x1x1_g1_execute_split_k_"
     "kernel__5x_cudnn", "conv"),
    ("_ZN17cutlass__5x_cudnn6KernelINS_4conv6kernel23ImplicitGemmConvolution"
     "INS1_11threadblock22ImplicitGemmMultistageINS_4gemm9GemmShapeILi64E"
     "ELi64ELi64EEENS_6layout9NoPermuteE", "conv"),
    ("void cutlass__5x_cudnn::Kernel<cutlass__5x_cudnn::reduction::kernel::"
     "ReduceSplitK<cutlass__5x_cudnn::MatrixShape<4, 256>>", "conv"),
    ("void nhwcAddPaddingKernel<__nv_bfloat16, __nv_bfloat16, float, true, "
     "(cudnnKernelDataType_t)0>(int)", "conv"),
    ("conv2d_grouped_direct_kernel", "conv"),
    ("nvjet_hsh_128x128_64x4_2x1_v_bz_coopA_TNT", "matmul"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "matmul"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s16816gemm>", "matmul"),
    ("void gemv2T_kernel_val<int, int, float>", "matmul"),
    ("void cublasLt::splitKreduce_kernel<32, 16, int, float, __nv_bfloat16>",
     "matmul"),
    ("wire_quantize_multi_kernel", "quantize-pack"),
    ("void block_quantize_kernel<true>(float const*)", "quantize-pack"),
    ("block_dequantize_kernel", "quantize-pack"),
    ("flash_fwd_wgmma_kernel", "other"),
    ("flash_bwd_kernel", "other"),
    ("Memcpy HtoD (Pageable -> Device)", "transfer"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::"
     "bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)>", "transfer"),
    ("Memset (Device)", "other"),
    ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, "
     "at::native::MeanOps<float, float, float, float>>>", "other"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "collective"),
    ("aten::permute", "other"),
    ("aten::conv2d", "conv"),
    ("aten::addmm", "matmul"),
    ("aten::linear", "matmul"),
    ("aten::copy_", "transfer"),
])
def test_card_and_torch_names_classify(name, cls):
    """Kernel names from ResNet-18 captures on the H100 (cuDNN's Hopper
    convolutions and their helpers, cuBLAS's GEMMs, the port's K1-K4 and
    flash kernels, torch's casts) and torch's host op names; the catalog
    stays the JAX package's: no class is added."""
    assert PDP.classify_op(name) == cls
    assert cls in JDP.OP_CLASSES


def test_host_ops_count_each_nest_once():
    """torch's host ops nest; each counts once, at its outermost matched
    op on its thread; another thread's ops are counted on their own."""
    events = [_meta(5, "python3"),
              _ev("aten::conv2d", 5, 0, 100.0),
              _ev("aten::convolution", 5, 1, 98.0),
              _ev("aten::_convolution", 5, 2, 96.0),
              _ev("aten::copy_", 5, 50, 10.0),
              _ev("aten::linear", 5, 200, 30.0),
              _ev("aten::addmm", 5, 201, 28.0),
              _ev("aten::mm", 5, 202, 10.0, tid=2),
              _ev("aten::relu", 5, 300, 5.0)]
    t = PDP.device_time_tables({"traceEvents": events})
    assert t["basis"] == "host_ops"
    assert {c: (r["time_s"], r["events"]) for c, r in
            t["op_classes"].items()} == {"conv": (1e-4, 1),
                                         "matmul": (4e-5, 2)}


# -- the profiler bracket and FLOP accounting -------------------------------

def test_step_cost_counts_as_xla_does():
    """One matmul and one unpadded convolution: FlopCounterMode's count
    equals XLA's cost analysis of the same op (a padded convolution
    differs: XLA counts only the taps inside the input)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((32, 48)).astype(np.float32)
    b = rng.standard_normal((48, 16)).astype(np.float32)
    j = JPF.compiled_cost(jax.jit(lambda a, b: a @ b).lower(a, b).compile())
    p = PPF.step_cost(torch.mm, torch.from_numpy(a), torch.from_numpy(b))
    assert p == {"flops": j["flops"], "bytes_accessed": None}
    x = rng.standard_normal((2, 9, 9, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 5)).astype(np.float32)
    j = JPF.compiled_cost(jax.jit(lambda x, w: jax.lax.conv_general_dilated(
        x, w, (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))).lower(x, w).compile())
    p = PPF.step_cost(torch.nn.functional.conv2d,
                      torch.from_numpy(x).permute(0, 3, 1, 2),
                      torch.from_numpy(w).permute(3, 2, 0, 1))
    assert p["flops"] == j["flops"] == 2 * 2 * 7 * 7 * 5 * 27
    assert PPF.step_cost(lambda: None) == {"flops": None,
                                           "bytes_accessed": None}


def test_peak_table_and_mfu_match_jax():
    for kind, peak in JPF.PEAK_FLOPS_BY_KIND.items():
        assert PPF.peak_flops(kind) == peak == JPF.peak_flops(kind)
        assert PPF.mfu(1e12, 10.0, kind) == JPF.mfu(1e12, 10.0, kind)
    assert PPF.peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert PPF.mfu(4.26e11, 850.0, "NVIDIA H100 80GB HBM3") \
        == pytest.approx(0.366, abs=1e-3)
    for args in ((None, 1.0, "TPU v4"), (1e9, None, "TPU v4"),
                 (1e9, 1.0, "cpu"), (1e9, 1.0, "TPU v4", 0)):
        assert PPF.mfu(*args) is None and JPF.mfu(*args) is None


def test_find_and_prune_match_jax(tmp_path):
    run = tmp_path / "plugins" / "profile" / "2026_01_01_00_00_00"
    run.mkdir(parents=True)
    for name in ("host_1.123.pt.trace.json.gz", "h.trace.json",
                 "h.xplane.pb"):
        (run / name).write_text("{}")
    (tmp_path / "direct.trace.json").write_text("{}")
    found = PPF.find_profile_dumps(str(tmp_path))
    assert found == JPF.find_profile_dumps(str(tmp_path)) and len(found) == 3
    assert PPF.find_profile_dumps(found[0]) == [found[0]]
    removed = PPF.prune_capture(str(tmp_path))
    assert sorted(removed) == sorted([str(tmp_path / "plugins"),
                                      str(tmp_path / "direct.trace.json")])
    assert PPF.find_profile_dumps(str(tmp_path)) == []


def test_tracing_bracket_writes_where_jax_does(tmp_path):
    with PPF.capture(str(tmp_path / "cap"), "cpu"):
        with PUT.annotate("probe.region"):
            torch.ones(8).sum()
    dumps = PPF.find_profile_dumps(str(tmp_path / "cap"))
    assert len(dumps) == 1 and dumps[0].endswith(".pt.trace.json.gz")
    assert pathlib.Path(dumps[0]).parent.parent.name == "profile"
    names = {e.get("name") for e in
             PDP.load_chrome_trace(dumps[0])["traceEvents"]}
    assert {"probe.region", "aten::sum"} <= names
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with PUT.trace(str(tmp_path / "gpu")):
            pass
    timers = PUT.StepTimer(window=2), JUT.StepTimer(window=2)
    for timer in timers:
        for _ in range(3):
            with timer:
                pass
        assert len(timer.times) == 2 and timer.last >= 0.0
    assert PUT.StepTimer().mean == JUT.StepTimer().mean == 0.0


# -- the CLI on the CPU ------------------------------------------------------

@pytest.fixture
def small(monkeypatch):
    """A narrow ResNet for ``get_model`` and 64 synthetic images."""
    def get_model(name, num_classes=10, device="cpu", **kw):
        return models.ResNet(stage_sizes=(1, 1), num_filters=8,
                             num_classes=num_classes).to(device)

    monkeypatch.setattr(models, "get_model", get_model)
    monkeypatch.setattr(cli, "_load_dataset",
                        lambda args: synthetic_cifar100(64, 16, 10, seed=0))


def _naive_matched(trace) -> int:
    return sum(1 for e in trace["traceEvents"] if e.get("ph") == "X"
               and PDP.classify_op(str(e.get("name"))) != "other")


def test_cli_profile_dir_perf_profile_and_diff(small, tmp_path, capsys):
    prof = str(tmp_path / "prof")
    assert cli.main(["train", "--mode", "baseline", "--device", "cpu",
                     "--epochs", "1", "--batch-size", "16", "--dtype",
                     "float32", "--profile-dir", prof]) == 0
    (dump,) = PPF.find_profile_dumps(prof)
    trace = PDP.load_chrome_trace(dump)
    art = str(tmp_path / "a.json")
    capsys.readouterr()
    assert cli.main(["perf", "profile", "--profile-dir", prof, "--json",
                     "--keep-traces", "--out", art]) == 0
    report = json.loads(capsys.readouterr().out)
    prof_table = report["profile"]
    assert prof_table["basis"] == "host_ops"
    assert report["trace_files"] == [os.path.basename(dump)]
    assert "device_kind" not in report
    events = trace["traceEvents"]
    n_conv = sum(1 for e in events if e.get("name") == "aten::conv2d")
    n_conv_bwd = sum(1 for e in events if e.get("ph") == "X" and str(
        e.get("name")).endswith("evaluate_function: ConvolutionBackward0"))
    assert n_conv > n_conv_bwd > 0            # the eval runs forwards only
    assert prof_table["op_classes"]["conv"]["events"] == n_conv + n_conv_bwd
    counted = sum(r["events"] for r in prof_table["op_classes"].values())
    assert counted < _naive_matched(trace)
    assert prof_table["total_attributed_s"] <= prof_table["trace_wall_s"]
    # Without --keep-traces the raw capture is pruned after the join.
    assert cli.main(["perf", "profile", "--profile-dir", prof]) == 0
    assert "attribution basis: host op events" in capsys.readouterr().out
    assert PPF.find_profile_dumps(prof) == []
    assert cli.main(["perf", "profile", "--profile-dir", prof]) == 1
    assert cli.main(["perf", "diff", art, art, "--json"]) == 0
    diff = json.loads(capsys.readouterr().out)
    assert diff["basis"] == "host_ops" and all(
        r["status"] == "unchanged" for r in diff["op_classes"].values())
    tpu = str(tmp_path / "tpu.json")
    with open(tpu, "w") as f:
        json.dump(PDP.attribute_profile(_capture_dir(
            tmp_path / "tpu", TPU_TRACES["device_lanes"])), f)
    assert cli.main(["perf", "diff", art, tpu]) == 1
    assert "attribution basis mismatch" in capsys.readouterr().err
    assert cli.main(["perf", "diff", art, str(tmp_path / "missing")]) == 1
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 11"):
        cli.main(["perf", "check"])


def test_cli_train_telemetry_flags(small, tmp_path, capsys):
    """``--telemetry``, ``--trace`` and ``--journal-dir`` on an async run:
    snapshot lines on stdout, a sealed journal holding them, and
    ``worker.step`` spans that ``perf profile --trace-dump-dir`` joins
    with the run's ``--profile-dir`` capture."""
    from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
        import disable_tracing, get_recorder, read_journal
    prof, dumps = str(tmp_path / "prof"), str(tmp_path / "dumps")
    journal = str(tmp_path / "journal")
    try:
        assert cli.main(["train", "--mode", "async", "--workers", "1",
                         "--epochs", "1", "--batch-size", "32", "--dtype",
                         "float32", "--device", "cpu", "--telemetry",
                         "--telemetry-interval", "60", "--trace",
                         "--journal-dir", journal, "--profile-dir",
                         prof]) == 0
        get_recorder().dump_to_dir(dumps, "exit")
    finally:
        disable_tracing()
        get_recorder().clear()
    out = capsys.readouterr().out
    snaps = [json.loads(line.split("METRICS_JSON: ", 1)[1])
             for line in out.splitlines() if '"kind": "snapshot"' in line]
    assert snaps and snaps[-1]["role"] == "trainer"
    assert [r["type"] for r in read_journal(journal)].count("snapshot") \
        == len(snaps)
    assert cli.main(["perf", "profile", "--profile-dir", prof,
                     "--trace-dump-dir", dumps, "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    (dump,) = PTR.find_trace_dumps(dumps)
    steps = [s for s in PTR.load_trace_dumps([dump])
             if s["name"] == "worker.step"]
    assert report["critical_path"]["steps"] == len(steps) >= 2
    rec = report["reconciliation"]
    assert rec["attribution_basis"] == "host_ops" \
        and rec["step_wall_s"] > 0


@pytest.mark.parametrize("verb", ["train", "serve", "worker"])
def test_telemetry_flags_and_their_environment(verb, monkeypatch):
    """Every verb takes the JAX CLI's telemetry flags with its ``DPS_*``
    defaults, and ``--profile-dir``."""
    args = cli.build_parser().parse_args([verb])
    assert (args.telemetry, args.telemetry_interval, args.metrics_port,
            args.trace, args.trace_buffer, args.trace_dump_dir,
            args.journal_dir, args.profile_dir) \
        == (False, 5.0, None, False, 4096, None, None, None)
    for env, value in (("DPS_TELEMETRY", "1"),
                       ("DPS_TELEMETRY_INTERVAL", "2.5"),
                       ("DPS_METRICS_PORT", "9100"), ("DPS_TRACE", "1"),
                       ("DPS_TRACE_BUFFER", "64"),
                       ("DPS_TRACE_DUMP_DIR", "d"),
                       ("DPS_JOURNAL_DIR", "j")):
        monkeypatch.setenv(env, value)
    args = cli.build_parser().parse_args([verb])
    assert (args.telemetry, args.telemetry_interval, args.metrics_port,
            args.trace, args.trace_buffer, args.trace_dump_dir,
            args.journal_dir) == (True, 2.5, 9100, True, 64, "d", "j")
