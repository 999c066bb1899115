"""Latency-summary math: nearest-rank percentiles, the bucketed quantile
the SLO evaluator reads off histogram snapshots, and the exact merge of
histogram snapshots.

The JAX package's ``telemetry/stats.py``, carried over whole (it is
framework-neutral). :func:`histogram_quantile` is the bucketed
counterpart of :func:`percentile`, used server-side
(``telemetry/slo.py``) where only histogram snapshots exist, not raw
samples.
"""

from __future__ import annotations

__all__ = ["histogram_quantile", "latency_summary", "merge_histograms",
           "percentile"]


def percentile(sorted_vals: list[float], p: float) -> float:
    """Nearest-rank percentile over an already-sorted sample."""
    if not sorted_vals:
        return 0.0
    k = round(p / 100.0 * (len(sorted_vals) - 1))
    return sorted_vals[min(len(sorted_vals) - 1, max(0, k))]


def histogram_quantile(edges: list[float], counts: list[int],
                       p: float) -> float | None:
    """Quantile estimate from a fixed-bucket histogram snapshot.

    ``edges`` are the inclusive upper bounds; ``counts`` are the
    NON-cumulative per-bucket counts, optionally with one extra trailing
    overflow slot (the registry's ``snapshot()`` shape). Returns the
    upper edge of the bucket containing the p-th observation — a
    conservative (never-understated) estimate, which is the right bias
    for SLO checks. None when the histogram is empty or the quantile
    lands in the overflow bucket (no finite upper bound to report).
    """
    total = sum(counts)
    if total <= 0:
        return None
    rank = p / 100.0 * total
    seen = 0
    for i, c in enumerate(counts):
        seen += c
        if seen >= rank and c > 0:
            if i >= len(edges):
                return None  # overflow bucket: unbounded above
            return float(edges[i])
    return None


def merge_histograms(snaps: list[dict]) -> dict:
    """Merge registry histogram snapshots into one EXACT union histogram.

    Exactness is the whole point (and what the fleet rollups advertise):
    because bucket schemes are pinned in ``registry.py``, every process
    in the fleet records the same series into identical edges, so the
    merged per-bucket counts equal the counts a single histogram would
    have accumulated over the union of all observations — fleet
    p50/p95/p99 from :func:`histogram_quantile` over the merge are the
    true union quantiles, not an estimate-of-estimates. Mismatched
    ``le`` schemes raise (merging them could only be approximate, which
    would silently break that contract).

    The operation is associative and commutative with ``{le, counts:
    zeros, sum: 0, count: 0}`` as identity — property-tested in
    the JAX package's fleet tests. Per-bucket ``exemplars`` (when present) merge
    by newest timestamp: the surviving exemplar per bucket is the most
    recently sampled one across the fleet.
    """
    if not snaps:
        raise ValueError("merge_histograms needs at least one snapshot")
    le = list(snaps[0]["le"])
    n_counts = len(snaps[0]["counts"])
    merged_counts = [0] * n_counts
    merged_sum = 0.0
    merged_count = 0
    merged_ex: dict[str, dict] = {}
    for snap in snaps:
        if list(snap["le"]) != le or len(snap["counts"]) != n_counts:
            raise ValueError(
                f"cannot merge histograms with different bucket schemes: "
                f"{le!r} vs {snap['le']!r}")
        for i, c in enumerate(snap["counts"]):
            merged_counts[i] += c
        merged_sum += snap["sum"]
        merged_count += snap["count"]
        for idx, ex in (snap.get("exemplars") or {}).items():
            cur = merged_ex.get(idx)
            if cur is None or ex.get("ts", 0) >= cur.get("ts", 0):
                merged_ex[idx] = dict(ex)
    out = {"le": le, "counts": merged_counts, "sum": merged_sum,
           "count": merged_count}
    if merged_ex:
        out["exemplars"] = merged_ex
    return out


def latency_summary(lat_s: list[float]) -> dict:
    """p50/p95/p99 in milliseconds (the LOADGEN_JSON convention)."""
    s = sorted(lat_s)
    return {"p50": round(percentile(s, 50) * 1e3, 3),
            "p95": round(percentile(s, 95) * 1e3, 3),
            "p99": round(percentile(s, 99) * 1e3, 3),
            "samples": len(s)}
