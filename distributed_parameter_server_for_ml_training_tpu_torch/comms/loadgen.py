"""Fetch-path load generator (docs/SHARDING.md "Serve-path load").

The JAX package's ``comms/loadgen.py``, carried over (host code over
grpc; the port keeps its own copy). Drives ``FetchParameters`` at
open-throttle concurrency against one or more targets (shard primaries
and/or replicas, of either package) and reports aggregate QPS plus
client-observed latency percentiles. Tenancy's ``job`` stamp comes with
ROADMAP §1 item 9 (tenancy): ``job=`` is refused until then.

Deliberately NOT built on RemoteStore: the generator unpacks only the
reply envelope and never decodes tensors, so the client side stays far
from saturation and the measured ceiling is the SERVER's. Each worker
thread owns its own channel (no client-side multiplexing bottleneck)
and round-robins over the target list by thread index.

Modes:
- ``full``  — every fetch ships the whole model (the production read
  workload: parameter consumers arriving cold).
- ``delta`` — fetches carry ``have_step`` at the target's current step,
  so an idle server answers header-only NOT_MODIFIED (the replica-
  refresh / heartbeat workload).
- ``infer`` — the inference-serving workload against a canary-enabled
  replica tier (docs/SHARDING.md "Serve tier"): each request carries
  ``infer`` and piggybacks a quality score for the PREVIOUS response
  (``quality_fn(serving_step)``), and the result breaks fetch counts,
  latency, and mean quality out per serving arm — the canary split is
  directly visible in the numbers.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import grpc

from ..telemetry.registry import LATENCY_BUCKETS, Histogram
from ..telemetry.stats import histogram_quantile, merge_histograms
from ..telemetry.stats import latency_summary as _latency_summary
from .service import GRPC_OPTIONS, SERVICE_NAME, pack_msg, unpack_msg

__all__ = ["loadgen_child_argv", "merge_loadgen_reports",
           "parse_loadgen_json", "run_loadgen", "run_loadgen_scaled"]

#: Where the ``job`` stamp comes (the port refuses it until then, as it
#: refuses ``worker --job``).
TENANCY = "ROADMAP §1 item 9 (tenancy)"

#: The machine-readable line ``cli loadgen`` prints (and the scale-out
#: parent greps from each child's stdout).
LOADGEN_JSON_PREFIX = "LOADGEN_JSON "


def _latency_hist(lat_s: list) -> dict:
    """Client-observed latencies on the pinned SLO bucket scheme — the
    LOADGEN_JSON field that makes reports MERGEABLE: percentiles of
    percentiles are not percentiles, but pinned-scheme histograms merge
    exactly (telemetry/stats.merge_histograms)."""
    h = Histogram("loadgen_latency", buckets=LATENCY_BUCKETS)
    for v in lat_s:
        h.observe(v)
    return h.snapshot()


def merge_loadgen_reports(reports: list) -> dict:
    """Merge LOADGEN_JSON reports into one honest aggregate report.

    The building block for distributed load generation (N generator
    processes hammering one fleet): counts/bytes sum, QPS sums (the
    generators ran concurrently), duration takes the max, targets union
    — and the latency percentiles come from merging each report's
    ``latency_hist`` on the pinned bucket scheme, so the merged
    p50/p95/p99 are the union percentiles, not an average of
    per-report percentiles. Raises on reports without ``latency_hist``
    (pre-merge-era records cannot be merged honestly).
    """
    if not reports:
        raise ValueError("merge_loadgen_reports needs at least one report")
    for i, r in enumerate(reports):
        if "latency_hist" not in r:
            raise ValueError(
                f"report {i} has no latency_hist — re-run the generator "
                f"(pre-fleet reports cannot be merged honestly)")
    merged_hist = merge_histograms([r["latency_hist"] for r in reports])
    targets: list = []
    for r in reports:
        for t in r.get("targets", []):
            if t not in targets:
                targets.append(t)
    latency_ms = {"samples": int(merged_hist["count"])}
    for pct, key in ((50, "p50"), (95, "p95"), (99, "p99")):
        q = histogram_quantile(merged_hist["le"], merged_hist["counts"],
                               pct)
        latency_ms[key] = None if q is None else round(q * 1e3, 3)
    total_bytes = sum(r.get("bytes_in", 0) for r in reports)
    return {
        "targets": targets,
        "reports": len(reports),
        "modes": sorted({r.get("mode", "?") for r in reports}),
        "concurrency": sum(int(r.get("concurrency", 0)) for r in reports),
        "duration_s": round(max(float(r.get("duration_s", 0.0))
                                for r in reports), 3),
        "fetches_ok": sum(int(r.get("fetches_ok", 0)) for r in reports),
        "fetches_err": sum(int(r.get("fetches_err", 0)) for r in reports),
        "not_modified": sum(int(r.get("not_modified", 0))
                            for r in reports),
        "bytes_in": total_bytes,
        "qps": round(sum(float(r.get("qps", 0.0)) for r in reports), 1),
        "mb_per_s": round(sum(float(r.get("mb_per_s", 0.0))
                              for r in reports), 2),
        "latency_ms": latency_ms,
        "latency_hist": merged_hist,
    }


def _refuse_job(job) -> None:
    if job:
        raise NotImplementedError(
            f"job {job!r}: not ported yet; it comes with {TENANCY}")


def _fetch_stub(channel):
    ident = lambda b: b  # noqa: E731
    return channel.unary_unary(f"/{SERVICE_NAME}/FetchParameters",
                               request_serializer=ident,
                               response_deserializer=ident)


def run_loadgen(targets, duration_s: float = 5.0, concurrency: int = 4,
                mode: str = "full", rpc_timeout: float = 10.0,
                quality_fn=None, job=None) -> dict:
    """Hammer ``targets`` with fetches for ``duration_s`` using
    ``concurrency`` threads; returns the aggregate result dict (also the
    ``LOADGEN_JSON`` schema ``cli loadgen`` emits). In ``infer`` mode
    ``quality_fn(serving_step) -> float`` scores each served response
    (default: constant 1.0); the score rides the NEXT request as canary
    feedback. ``job`` (the JAX function's per-tenant stamp) is refused:
    tenancy is not ported yet."""
    if isinstance(targets, str):
        targets = [t for t in targets.split(",") if t]
    if not targets:
        raise ValueError("loadgen needs at least one target")
    if mode not in ("full", "delta", "infer"):
        raise ValueError(f"mode must be full|delta|infer, got {mode!r}")
    _refuse_job(job)

    lock = threading.Lock()
    per_target = {t: {"ok": 0, "err": 0, "bytes_in": 0,
                      "not_modified": 0} for t in targets}
    latencies: list[float] = []  # guarded by: lock
    # Per-arm accounting (infer mode; guarded by: lock). Literal arm
    # names: these ARE the wire values a canary replica stamps replies
    # with.
    arms = {a: {"ok": 0, "quality_sum": 0.0, "quality_n": 0,
                "latency_s": [], "steps": set()}
            for a in ("stable", "canary")}
    stop = threading.Event()

    def worker(idx: int) -> None:
        target = targets[idx % len(targets)]
        channel = grpc.insecure_channel(target, options=GRPC_OPTIONS)
        stub = _fetch_stub(channel)
        ok = err = nbytes = nm = 0
        lat: list[float] = []
        arm_local = {a: {"ok": 0, "quality_sum": 0.0, "quality_n": 0,
                         "latency_s": [], "steps": set()}
                     for a in ("stable", "canary")}
        have = None
        if mode == "delta":
            # Learn the target's current step once, then poll at it so
            # the steady state is all NOT_MODIFIED replies.
            try:
                meta, _ = unpack_msg(stub(pack_msg({}),
                                          timeout=rpc_timeout))
                have = int(meta["global_step"])
            except Exception:  # noqa: BLE001 — count as errors below
                have = 0
        if mode == "infer":
            request = pack_msg({"infer": True})
        else:
            request = pack_msg({} if have is None
                               else {"have_step": have})
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                reply = stub(request, timeout=rpc_timeout)
            except Exception:  # noqa: BLE001 — grpc errors only
                err += 1
                continue
            dt = time.perf_counter() - t0
            ok += 1
            nbytes += len(reply)
            lat.append(dt)
            if mode == "delta":
                rmeta, _ = unpack_msg(reply)
                if rmeta.get("not_modified"):
                    nm += 1
                else:
                    # The target advanced: re-arm at the new step so the
                    # loop keeps measuring the NM path, not full ships.
                    have = int(rmeta["global_step"])
                    request = pack_msg({"have_step": have})
            elif mode == "infer":
                rmeta, _ = unpack_msg(reply)
                arm = str(rmeta.get("arm") or "stable")
                if arm not in arm_local:
                    arm = "stable"
                step = rmeta.get("serving_step")
                row = arm_local[arm]
                row["ok"] += 1
                row["latency_s"].append(dt)
                meta: dict = {"infer": True}
                if step is not None:
                    row["steps"].add(int(step))
                    try:
                        q = (1.0 if quality_fn is None
                             else float(quality_fn(int(step))))
                    except Exception:  # noqa: BLE001 — scorer bug only
                        q = None       # costs one feedback sample
                    if q is not None:
                        row["quality_sum"] += q
                        row["quality_n"] += 1
                        # Feedback rides the NEXT request: arm + step
                        # identify which window the score lands in.
                        meta["quality"] = {"arm": arm,
                                           "step": int(step),
                                           "value": q}
                request = pack_msg(meta)
        channel.close()
        with lock:
            row = per_target[target]
            row["ok"] += ok
            row["err"] += err
            row["bytes_in"] += nbytes
            row["not_modified"] += nm
            latencies.extend(lat)
            for a, src in arm_local.items():
                dst = arms[a]
                dst["ok"] += src["ok"]
                dst["quality_sum"] += src["quality_sum"]
                dst["quality_n"] += src["quality_n"]
                dst["latency_s"].extend(src["latency_s"])
                dst["steps"] |= src["steps"]

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(int(concurrency))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    time.sleep(float(duration_s))
    stop.set()
    for t in threads:
        t.join(timeout=max(10.0, rpc_timeout * 2))
    elapsed = time.monotonic() - t0
    total_ok = sum(r["ok"] for r in per_target.values())
    total_err = sum(r["err"] for r in per_target.values())
    total_bytes = sum(r["bytes_in"] for r in per_target.values())
    result = {
        "targets": list(targets),
        "mode": mode,
        "concurrency": int(concurrency),
        "duration_s": round(elapsed, 3),
        "fetches_ok": total_ok,
        "fetches_err": total_err,
        "not_modified": sum(r["not_modified"]
                            for r in per_target.values()),
        "bytes_in": total_bytes,
        "qps": round(total_ok / elapsed, 1) if elapsed > 0 else 0.0,
        "mb_per_s": round(total_bytes / elapsed / 1e6, 2)
        if elapsed > 0 else 0.0,
        "latency_ms": _latency_summary(latencies),
        "latency_hist": _latency_hist(latencies),
        "errors_by_target": {t: r["err"] for t, r in per_target.items()},
        "per_target": per_target,
    }
    if mode == "infer":
        result["arms"] = {
            a: {"ok": r["ok"],
                "quality_mean": (round(r["quality_sum"] / r["quality_n"], 4)
                                 if r["quality_n"] else None),
                "latency_ms": _latency_summary(r["latency_s"]),
                "serving_steps": sorted(r["steps"])}
            for a, r in arms.items()}
    return result


def loadgen_child_argv(targets, duration_s: float, concurrency: int,
                       mode: str, job=None,
                       python: str | None = None) -> list[str]:
    """One scale-out child's command line: a plain ``cli loadgen``
    invocation (no ``--scale-out`` — children never recurse). Pure, so
    tests pin the fan-out contract without spawning anything."""
    _refuse_job(job)
    if isinstance(targets, str):
        targets = [t for t in targets.split(",") if t]
    pkg = __name__.rsplit(".", 2)[0]
    argv = [python or sys.executable, "-m", f"{pkg}.cli", "loadgen",
            "--targets", ",".join(targets),
            "--duration", str(float(duration_s)),
            "--concurrency", str(int(concurrency)),
            "--fetch-mode", str(mode)]
    return argv


def parse_loadgen_json(text: str) -> dict | None:
    """Extract the LOADGEN_JSON report from one generator's stdout
    (last match wins — logs may precede it). None when absent or
    garbled: the scale-out parent drops that child from the merge and
    says so, instead of averaging in junk."""
    found = None
    for line in str(text).splitlines():
        if line.startswith(LOADGEN_JSON_PREFIX):
            try:
                found = json.loads(line[len(LOADGEN_JSON_PREFIX):])
            except ValueError:
                continue
        # tolerate prefixed wrapping (e.g. a supervisor log line)
        elif LOADGEN_JSON_PREFIX in line:
            try:
                found = json.loads(
                    line.split(LOADGEN_JSON_PREFIX, 1)[1])
            except ValueError:
                continue
    return found if isinstance(found, dict) else None


def run_loadgen_scaled(targets, duration_s: float = 5.0,
                       concurrency: int = 4, mode: str = "full",
                       job=None, scale_out: int = 2,
                       rpc_timeout: float = 10.0,
                       python: str | None = None, spawn=None) -> dict:
    """Distributed load generation (docs/SHARDING.md "Fan-out trees"):
    launch ``scale_out`` coordinated generator PROCESSES (each a plain
    ``cli loadgen`` with ``concurrency`` threads), then merge their
    LOADGEN_JSON reports through :func:`merge_loadgen_reports` — the
    merged percentiles come from the bucket-exact histogram union, never
    from averaging per-process percentiles. One process behaves exactly
    like :func:`run_loadgen` plus the subprocess overhead; the fan-out
    exists so a single GIL-bound generator stops being the thing the
    measurement saturates. ``spawn(argv) -> Popen-like`` is injectable
    for tests. Raises ``RuntimeError`` when no child produced a report.
    """
    n = max(1, int(scale_out))
    argv = loadgen_child_argv(targets, duration_s, concurrency, mode,
                              job=job, python=python)
    if spawn is None:
        def spawn(a):  # pragma: no cover — exercised by the slow drill
            return subprocess.Popen(a, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
    procs = [spawn(list(argv)) for _ in range(n)]
    reports, failed = [], 0
    deadline = time.monotonic() + float(duration_s) + 8 * rpc_timeout
    for p in procs:
        try:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        report = parse_loadgen_json(out or "")
        if report is None:
            failed += 1
        else:
            reports.append(report)
    if not reports:
        raise RuntimeError(
            f"scale-out loadgen: none of the {n} generator processes "
            f"produced a LOADGEN_JSON report")
    merged = merge_loadgen_reports(reports)
    merged["scale_out"] = n
    merged["generators_failed"] = failed
    merged["per_process_qps"] = [round(float(r.get("qps", 0.0)), 1)
                                 for r in reports]
    return merged
