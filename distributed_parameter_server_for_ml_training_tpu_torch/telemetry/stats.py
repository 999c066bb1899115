"""Latency-summary math of the server-side SLO evaluator.

The JAX package's ``telemetry/stats.py`` for what the port runs:
:func:`histogram_quantile`, the bucketed quantile ``telemetry/slo.py``
reads off histogram snapshots. The raw-sample summaries and the fleet
histogram merge come with the load generator and the fleet rollups
(ROADMAP §1 items 8 and 9).
"""

from __future__ import annotations

__all__ = ["histogram_quantile"]


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
