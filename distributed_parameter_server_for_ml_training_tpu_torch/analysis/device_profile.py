"""Parse profiler dumps into device-time attribution tables.

The JAX package's ``analysis/device_profile.py``, with the card's lanes
of a ``torch.profiler`` trace found beside the TPU's. The read half of
the perf observatory (write half: :mod:`..telemetry.profiler`). A
``--profile-dir`` capture leaves one Chrome-format ``*.trace.json.gz``
per process under ``plugins/profile/<run>/``; this module turns that
into per-op-class device time, and a reconciliation against the
flight-recorder ``critical_path_report`` so one artifact attributes each
step's wall end-to-end (host phase -> device op class), with the
unattributed residual REPORTED, not hidden. The op classes
(:data:`OP_CLASSES`) and the artifact's schema are the JAX package's, so
``perf diff`` and the catalog mean the same thing in both packages.

Device lanes, by trace:

- a ``jax.profiler`` trace names them: a process whose name holds
  ``/device:``; every complete event on it counts;
- a ``torch.profiler`` trace puts the card's kernels and copies on the
  card's own pid with the categories :data:`CUDA_DEVICE_CATEGORIES`. The
  same lane carries ``gpu_user_annotation`` ranges, which mirror every
  ``record_function`` range onto the card's timeline over the kernels
  they hold, so only the device-activity categories count there.

Honesty rules:

- Without device lanes (a capture on the CPU) the host lane still
  carries per-op events (XLA thunks like ``convolution.687``, or torch's
  ``aten::conv2d``), which classify into real op classes (``basis:
  "host_ops"``). torch's host ops nest (``aten::conv2d`` ->
  ``aten::convolution`` -> ``aten::_convolution`` -> ...), so each
  matched op counts once: the outermost matched one on its thread. A
  capture with no op events at all degrades to the executor-wrapper
  time (``basis: "host_execute_proxy"``, excluding the double-counting
  "wait for completion" variant). Either way ``device_lanes_present``
  stays False and the residual stays visible — host attribution is never
  presented as measured device time.
- Op classification is by name pattern; on device lanes anything
  unmatched (fused kernels with opaque names; the port's flash kernels,
  as a Pallas custom call on the TPU) lands in ``other`` — the fractions
  always sum to 1 over attributed time. On host lanes unmatched names
  are python frames/bookkeeping, NOT ops, so they stay unattributed
  rather than polluting ``other``.
"""

from __future__ import annotations

import gzip
import json
import os
import re

__all__ = [
    "CUDA_DEVICE_CATEGORIES",
    "OP_CLASSES",
    "attribute_profile",
    "classify_op",
    "device_time_tables",
    "diff_profiles",
    "load_chrome_trace",
    "render_profile_diff",
    "render_profile_table",
    "top_device_ops",
]

#: op class -> one-line meaning: the JAX package's catalog, row for row.
OP_CLASSES = {
    "matmul": "dense MXU work: dot/matmul/gemm/einsum kernels",
    "conv": "convolution kernels",
    "collective": "cross-device comms: all-reduce/all-gather/"
                  "reduce-scatter/all-to-all/permute/psum",
    "quantize-pack": "codec arithmetic: quantize/dequantize/pack/unpack",
    "transfer": "host<->device + on-device copies, infeed/outfeed",
    "host_execute": "host-side executable dispatch (the CPU-backend "
                    "proxy when no device lanes exist)",
    "other": "unclassified device ops (opaque fusion names)",
}

#: Ordered (class, pattern) — first match wins, so collectives beat the
#: ``dot`` inside a fused all-reduce name. Beside the JAX package's
#: patterns, the card's and torch's names: cuDNN's Hopper convolutions
#: (``sm90_xmma_fprop_implicit_gemm_..._cudnn``, ``...dgrad...``,
#: ``...wgrad...``) and their helpers (split-K reductions, padding, all
#: in cuDNN's ``__5x_cudnn`` namespace) hold ``gemm`` or ``cutlass`` but
#: no ``conv``, so ``fprop|dgrad|wgrad|cudnn`` sit in the conv class,
#: ahead of matmul; cuBLAS's GEMMs may be ``nvjet_...`` or CUTLASS
#: kernels with no ``gemm`` in the name (and its split-K reductions
#: ``cublasLt::splitKreduce_kernel``), and torch's host matmuls are
#: ``aten::mm``, ``aten::addmm``, ``aten::bmm``, ``aten::baddbmm``,
#: ``aten::linear``. ``permute`` is a collective only as a word of its
#: own (XLA's ``collective-permute``): torch's ``aten::permute`` is a
#: view, and CUTLASS's ``NoPermute`` a template argument.
_CLASS_PATTERNS = (
    ("collective", re.compile(
        r"all[-_]?reduce|all[-_]?gather|reduce[-_]?scatter|"
        r"all[-_]?to[-_]?all|collective|psum|(?<![a-z:])permute", re.I)),
    ("quantize-pack", re.compile(r"quant|dequant|pack|unpack", re.I)),
    ("transfer", re.compile(
        r"copy|memcpy|infeed|outfeed|transfer|h2d|d2h", re.I)),
    ("conv", re.compile(r"conv|fprop|dgrad|wgrad|cudnn", re.I)),
    ("matmul", re.compile(
        r"dot|matmul|gemm|einsum|nvjet|cutlass|cublas|gemv|"
        r"aten::(?:add|baddb|b)?mm\b|aten::linear", re.I)),
)

#: ``cat`` of a ``torch.profiler`` event that is the card's own activity:
#: a kernel, a copy, a memset. The ``gpu_user_annotation`` ranges on the
#: same lane are not: they cover kernels already counted.
CUDA_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

#: Host events that ARE the executable running (the last-resort CPU
#: proxy for device time). ParseArguments/donation bookkeeping etc. stay
#: unattributed; the "(wait for completion)" variant is excluded in code
#: because it wraps the inner Execute events and would double-count.
_HOST_EXECUTE_RE = re.compile(
    r"Executable::Execute|ExecuteOnLocalDevice|ThunkExecutor::Execute",
    re.I)


def classify_op(name: str) -> str:
    for cls, pat in _CLASS_PATTERNS:
        if pat.search(name):
            return cls
    return "other"


def load_chrome_trace(path: str) -> dict:
    """One dumped Chrome trace (gzipped or plain JSON)."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        return json.load(f)


def _lanes(events: list) -> dict[int, str]:
    """pid -> process name, from the "M" (metadata) events. A
    ``torch.profiler`` trace's ``process_labels`` (``"CPU"``, ``"GPU
    0"``) name a pid in place of its process name, and label every card
    the host has: a labelled pid without a complete event is no lane."""
    names: dict[int, str] = {}
    labels: dict[int, str] = {}
    for ev in events:
        if ev.get("ph") != "M":
            continue
        pid = ev.get("pid")
        args = ev.get("args") or {}
        if not isinstance(pid, int):
            continue
        if ev.get("name") == "process_name" \
                and isinstance(args.get("name"), str):
            names[pid] = args["name"]
        elif ev.get("name") == "process_labels" \
                and isinstance(args.get("labels"), str):
            labels[pid] = args["labels"]
    if labels:
        active = {ev.get("pid") for ev in _complete(events)}
        for pid in set(labels) - active:
            names.pop(pid, None)
            del labels[pid]
    return {**names, **labels}


def _complete(events: list):
    """The complete ("X") events with a usable duration."""
    for ev in events:
        if ev.get("ph") != "X":
            continue
        dur = ev.get("dur")
        if isinstance(dur, (int, float)) and dur >= 0:
            yield ev


def _device_counter(events: list):
    """``(device pids, counts(event))``: the pids of the device lanes, and
    whether an event on one of them is device activity (every event on a
    ``/device:`` lane; the :data:`CUDA_DEVICE_CATEGORIES` on a card's)."""
    lanes = _lanes(events)
    xla = {p for p, n in lanes.items() if "/device:" in n}
    cuda = {ev.get("pid") for ev in _complete(events)
            if ev.get("cat") in CUDA_DEVICE_CATEGORIES}

    def counts(ev: dict) -> bool:
        return ev.get("pid") in xla \
            or ev.get("cat") in CUDA_DEVICE_CATEGORIES

    return xla | cuda, counts


def _outermost(candidates: list) -> list:
    """Of ``(thread, ts, dur, payload)`` host events, those no other
    candidate on the same thread encloses: nested torch ops count once,
    at their outermost matched op."""
    out, ends = [], {}
    timed = sorted((c for c in candidates
                    if isinstance(c[1], (int, float))),
                   key=lambda c: (c[0], c[1], -c[2]))
    for thread, ts, dur, payload in timed:
        if ts < ends.get(thread, float("-inf")):
            continue
        ends[thread] = ts + dur
        out.append(payload)
    return out + [c[3] for c in candidates
                  if not isinstance(c[1], (int, float))]


def device_time_tables(trace: dict) -> dict:
    """Per-op-class device-time table for one Chrome trace dict.

    Durations are summed over complete ("X") events. Attribution basis,
    in preference order (reported as ``"basis"``):

    - ``device_lanes`` — device activity on the device lanes (module
      docstring); unmatched names -> ``other``.
    - ``host_ops`` — no device lanes, but the host lane carries per-op
      events (a CPU capture); only pattern-matched op names count, each
      nest of them once.
    - ``host_execute_proxy`` — no op events either; executor-wrapper
      time stands in (excluding the outer "wait for completion" events,
      which wrap the inner Execute and would double-count).
    - ``none`` — nothing attributable.
    """
    events = trace.get("traceEvents") or []
    lanes = _lanes(events)
    device_pids, counts = _device_counter(events)
    device_ops: dict[str, dict] = {}
    host_ops: dict[str, dict] = {}
    host_exec: dict[str, dict] = {}
    host_candidates: list = []
    t_min, t_max = None, None

    def add(table: dict, cls: str, dur_s: float) -> None:
        row = table.setdefault(cls, {"time_s": 0.0, "events": 0})
        row["time_s"] += dur_s
        row["events"] += 1

    for ev in _complete(events):
        dur = ev["dur"]
        ts = ev.get("ts")
        if isinstance(ts, (int, float)):
            t_min = ts if t_min is None else min(t_min, ts)
            t_max = ts + dur if t_max is None else max(t_max, ts + dur)
        name = str(ev.get("name", ""))
        if device_pids:
            if ev.get("pid") in device_pids and counts(ev):
                add(device_ops, classify_op(name), dur / 1e6)  # dur: us
        else:
            cls = classify_op(name)
            if cls != "other":
                host_candidates.append(
                    ((ev.get("pid"), ev.get("tid")), ts, dur,
                     (cls, dur)))
            elif _HOST_EXECUTE_RE.search(name) \
                    and "wait for completion" not in name:
                add(host_exec, "host_execute", dur / 1e6)
    for cls, dur in _outermost(host_candidates):
        add(host_ops, cls, dur / 1e6)

    if device_pids:
        basis, per_class = "device_lanes", device_ops
    elif host_ops:
        basis, per_class = "host_ops", host_ops
    elif host_exec:
        basis, per_class = "host_execute_proxy", host_exec
    else:
        basis, per_class = "none", {}
    total = sum(r["time_s"] for r in per_class.values())
    for row in per_class.values():
        row["time_s"] = round(row["time_s"], 6)
        row["fraction"] = round(row["time_s"] / total, 4) if total else 0.0
    return {
        "basis": basis,
        "device_lanes_present": bool(device_pids),
        "lanes": sorted(lanes.values()),
        "op_classes": per_class,
        "total_attributed_s": round(total, 6),
        "trace_wall_s": round((t_max - t_min) / 1e6, 6)
        if t_min is not None else 0.0,
    }


def top_device_ops(trace: dict, n: int = 10) -> list[dict]:
    """The ``n`` device ops (kernels, copies) of one Chrome trace dict
    with the most device time, summed by name: ``{"name", "class",
    "time_s", "events"}``, largest first. Empty without device lanes."""
    events = trace.get("traceEvents") or []
    device_pids, counts = _device_counter(events)
    by_name: dict[str, list] = {}
    for ev in _complete(events):
        if ev.get("pid") in device_pids and counts(ev):
            row = by_name.setdefault(str(ev.get("name", "")), [0.0, 0])
            row[0] += ev["dur"] / 1e6
            row[1] += 1
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return [{"name": name, "class": classify_op(name),
             "time_s": round(t, 6), "events": k}
            for name, (t, k) in rows]


def _merge_tables(tables: list[dict]) -> dict:
    """Sum per-class rows across hosts/files into one table. Mixed bases
    (one host dumped device lanes, another only host events) keep the
    strongest basis and sum only the files that share it — averaging a
    proxy into measured device time would corrupt both."""
    order = ("device_lanes", "host_ops", "host_execute_proxy", "none")
    basis = min((t.get("basis", "none") for t in tables),
                key=order.index, default="none")
    counted = [t for t in tables if t.get("basis", "none") == basis]
    merged: dict = {
        "basis": basis,
        "device_lanes_present": any(t["device_lanes_present"]
                                    for t in tables),
        "lanes": sorted({ln for t in tables for ln in t["lanes"]}),
        "op_classes": {},
        "total_attributed_s": 0.0,
        "trace_wall_s": max((t["trace_wall_s"] for t in tables),
                            default=0.0),
    }
    for t in counted:
        for cls, row in t["op_classes"].items():
            m = merged["op_classes"].setdefault(
                cls, {"time_s": 0.0, "events": 0})
            m["time_s"] += row["time_s"]
            m["events"] += row["events"]
    total = sum(r["time_s"] for r in merged["op_classes"].values())
    merged["total_attributed_s"] = round(total, 6)
    for row in merged["op_classes"].values():
        row["time_s"] = round(row["time_s"], 6)
        row["fraction"] = round(row["time_s"] / total, 4) if total else 0.0
    return merged


def attribute_profile(logdir: str, critical: dict | None = None,
                      cost: dict | None = None,
                      mfu_value: float | None = None,
                      device_kind: str | None = None) -> dict:
    """The merged perf-observatory artifact for one capture.

    ``critical`` is an ``analysis.traces.critical_path_report`` result
    (host-phase surface), ``cost`` a ``telemetry.profiler.compiled_cost``
    result; both optional — whatever is absent is reported absent.
    Reconciliation: span-level step wall vs profiler-attributed time,
    residual = wall - attributed, clamped at 0 and REPORTED.
    """
    from ..telemetry.profiler import find_profile_dumps
    paths = find_profile_dumps(logdir)
    tables = []
    errors = []
    for p in paths:
        try:
            tables.append(device_time_tables(load_chrome_trace(p)))
        except (OSError, ValueError, json.JSONDecodeError) as e:
            errors.append({"file": os.path.basename(p), "error": str(e)})
    profile = _merge_tables(tables) if tables else {
        "basis": "none", "device_lanes_present": False, "lanes": [],
        "op_classes": {}, "total_attributed_s": 0.0, "trace_wall_s": 0.0,
    }
    out: dict = {
        "profile": profile,
        "trace_files": [os.path.basename(p) for p in paths],
        "parse_errors": errors,
    }
    if device_kind is not None:
        out["device_kind"] = device_kind
    if cost is not None:
        out["cost"] = dict(cost)
        out["cost"]["mfu"] = mfu_value
    if critical is not None:
        out["critical_path"] = critical
        wall = float(sum((critical.get("phase_totals_s") or {}).values()))
        step_wall = critical.get("step_wall_total_s")
        if step_wall is None:  # older report shape: top-N lower bound
            step_wall = sum(s.get("wall_s", 0.0)
                            for s in critical.get("stragglers") or [])
        step_wall = float(step_wall)
        attributed = profile["total_attributed_s"]
        out["reconciliation"] = {
            "step_wall_s": round(step_wall, 6),
            "phase_covered_s": round(wall, 6),
            "attributed_s": round(attributed, 6),
            "attribution_basis": profile.get("basis", "none"),
            "residual_s": round(max(0.0, step_wall - attributed), 6),
            "residual_fraction": round(
                max(0.0, step_wall - attributed) / step_wall, 4)
            if step_wall > 0 else None,
        }
    return out


def _inner_profile(artifact: dict) -> dict:
    """The per-op-class table inside a recorded artifact — accepts a
    full ``attribute_profile`` result, a ``PROFILE_*.json`` ledger
    record (same nesting), or the bare inner profile dict."""
    if not isinstance(artifact, dict):
        return {}
    prof = artifact.get("profile")
    return prof if isinstance(prof, dict) else artifact


def diff_profiles(a: dict, b: dict,
                  unchanged_tolerance: float = 0.01) -> dict:
    """Per-op-class delta between two attribution artifacts (``a`` the
    baseline, ``b`` the candidate) — the before/after table every
    kernel PR cites.

    HONEST-BASIS RULE: artifacts attributed on different bases
    (``device_lanes`` vs ``host_ops`` vs ``host_execute_proxy``) are
    not comparable — a host-proxy number against real device lanes
    would manufacture a regression out of methodology — so a basis
    mismatch raises ``ValueError`` instead of producing a table.
    Classes present on one side only are reported as ``new`` /
    ``vanished``; a class whose time moved less than
    ``unchanged_tolerance`` (relative) is ``unchanged``. Reconciliation
    residuals diff too, when both sides carry them.
    """
    pa, pb = _inner_profile(a), _inner_profile(b)
    basis_a = pa.get("basis", "none")
    basis_b = pb.get("basis", "none")
    if basis_a != basis_b:
        raise ValueError(
            f"attribution basis mismatch: baseline={basis_a!r} vs "
            f"candidate={basis_b!r} — these artifacts measure different "
            f"things and cannot be diffed honestly")
    ops_a = pa.get("op_classes") or {}
    ops_b = pb.get("op_classes") or {}
    rows = {}
    for cls in sorted(set(ops_a) | set(ops_b)):
        ta = float((ops_a.get(cls) or {}).get("time_s") or 0.0)
        tb = float((ops_b.get(cls) or {}).get("time_s") or 0.0)
        if cls not in ops_a:
            status = "new"
        elif cls not in ops_b:
            status = "vanished"
        elif ta > 0 and abs(tb - ta) / ta <= unchanged_tolerance:
            status = "unchanged"
        else:
            status = "changed"
        rows[cls] = {
            "baseline_s": round(ta, 6),
            "candidate_s": round(tb, 6),
            "delta_s": round(tb - ta, 6),
            "ratio": round(tb / ta, 4) if ta > 0 else None,
            "baseline_fraction": (ops_a.get(cls) or {}).get("fraction"),
            "candidate_fraction": (ops_b.get(cls) or {}).get("fraction"),
            "status": status,
        }
    total_a = float(pa.get("total_attributed_s") or 0.0)
    total_b = float(pb.get("total_attributed_s") or 0.0)
    out = {
        "basis": basis_a,
        "op_classes": rows,
        "total_baseline_s": round(total_a, 6),
        "total_candidate_s": round(total_b, 6),
        "total_delta_s": round(total_b - total_a, 6),
        "new_classes": sorted(c for c, r in rows.items()
                              if r["status"] == "new"),
        "vanished_classes": sorted(c for c, r in rows.items()
                                   if r["status"] == "vanished"),
    }
    rec_a = (a or {}).get("reconciliation") if isinstance(a, dict) else None
    rec_b = (b or {}).get("reconciliation") if isinstance(b, dict) else None
    if isinstance(rec_a, dict) and isinstance(rec_b, dict):
        ra = float(rec_a.get("residual_s") or 0.0)
        rb = float(rec_b.get("residual_s") or 0.0)
        out["residual"] = {
            "baseline_s": round(ra, 6),
            "candidate_s": round(rb, 6),
            "delta_s": round(rb - ra, 6),
        }
    return out


def render_profile_diff(diff: dict) -> str:
    """Human-readable delta table for ``cli perf diff`` — slowest-moving
    class first, so the regression's culprit is the top row."""
    lines = [f"attribution basis: {diff.get('basis', 'none')} "
             f"(both artifacts)"]
    rows = sorted((diff.get("op_classes") or {}).items(),
                  key=lambda kv: -abs(kv[1]["delta_s"]))
    if rows:
        lines.append(f"{'op class':<15} {'baseline_s':>12} "
                     f"{'candidate_s':>12} {'delta_s':>11} {'ratio':>7} "
                     f"{'status':>10}")
        for cls, r in rows:
            ratio = "-" if r["ratio"] is None else f"{r['ratio']:.2f}x"
            lines.append(f"{cls:<15} {r['baseline_s']:>12.6f} "
                         f"{r['candidate_s']:>12.6f} "
                         f"{r['delta_s']:>+11.6f} {ratio:>7} "
                         f"{r['status']:>10}")
    else:
        lines.append("(no attributed op classes on either side)")
    lines.append(f"total attributed: {diff.get('total_baseline_s', 0):.6f}s "
                 f"-> {diff.get('total_candidate_s', 0):.6f}s "
                 f"({diff.get('total_delta_s', 0):+.6f}s)")
    if diff.get("new_classes"):
        lines.append("new classes: " + ", ".join(diff["new_classes"]))
    if diff.get("vanished_classes"):
        lines.append("vanished classes: "
                     + ", ".join(diff["vanished_classes"]))
    res = diff.get("residual")
    if res:
        lines.append(f"reconciliation residual: {res['baseline_s']:.6f}s "
                     f"-> {res['candidate_s']:.6f}s "
                     f"({res['delta_s']:+.6f}s)")
    return "\n".join(lines)


def render_profile_table(report: dict) -> str:
    """Human-readable table for ``cli perf profile``."""
    lines = []
    prof = report.get("profile") or {}
    basis_text = {
        "device_lanes": "device lanes",
        "host_ops": "host op events (no device lanes in this capture)",
        "host_execute_proxy": "host-execute proxy (no device lanes or "
                              "op events in this capture)",
        "none": "none (nothing attributable)",
    }
    basis = prof.get("basis", "none")
    lines.append(f"attribution basis: {basis_text.get(basis, basis)}")
    rows = sorted((prof.get("op_classes") or {}).items(),
                  key=lambda kv: -kv[1]["time_s"])
    if rows:
        lines.append(f"{'op class':<15} {'time_s':>12} {'share':>7} "
                     f"{'events':>8}")
        for cls, r in rows:
            lines.append(f"{cls:<15} {r['time_s']:>12.6f} "
                         f"{r['fraction']*100:>6.1f}% {r['events']:>8}")
    else:
        lines.append("(no attributable events in the capture)")
    cost = report.get("cost")
    if cost:
        flops = cost.get("flops")
        by = cost.get("bytes_accessed")
        mfu_v = cost.get("mfu")
        lines.append(f"per-step cost: flops="
                     f"{'n/a' if flops is None else f'{flops:.3e}'} "
                     f"bytes={'n/a' if by is None else f'{by:.3e}'}")
        lines.append("mfu: " + ("n/a (unknown device peak)"
                                if mfu_v is None else f"{mfu_v*100:.2f}%"))
    rec = report.get("reconciliation")
    if rec:
        lines.append(
            f"reconciliation: step wall {rec['step_wall_s']:.4f}s, "
            f"attributed {rec['attributed_s']:.4f}s "
            f"({rec['attribution_basis']}), residual "
            f"{rec['residual_s']:.4f}s")
    return "\n".join(lines)
