"""Structured metrics emission/parsing: the METRICS_JSON convention.

The reference's entire observability pipeline is stdout prints plus ONE
structured line per process at exit — ``METRICS_JSON: {...}`` (server.py:367,
worker.py:435) — scraped from CloudWatch by regex
(scripts/parse_cloudwatch_logs.py:100: ``r'METRICS_JSON:\\s*(\\{.*\\})'``).
Emitters and the parser here keep that exact wire convention so the
reference's downstream ETL/plots work unchanged against our logs.
"""

from __future__ import annotations

import json
import re
import sys
import time
from typing import IO, Iterable

METRICS_RE = re.compile(r"METRICS_JSON:\s*(\{.*\})")


def emit_metrics_json(payload: dict, stream: IO | None = None) -> str:
    """Print the one structured line (server.py:367 / worker.py:435).
    The line and its newline go out in one write: ``print`` writes them
    separately, and another thread's print between the two (a snapshot
    emitter, an autoscaler's log) would run its text onto the line."""
    line = "METRICS_JSON: " + json.dumps(payload)
    out = stream or sys.stdout
    out.write(line + "\n")
    out.flush()
    return line


def parse_metrics_lines(text: str | Iterable[str]) -> list[dict]:
    """Extract all METRICS_JSON payloads from log text
    (parse_cloudwatch_logs.py:100-121 equivalent)."""
    if not isinstance(text, str):
        text = "\n".join(text)
    out = []
    for m in METRICS_RE.finditer(text):
        try:
            out.append(json.loads(m.group(1)))
        except json.JSONDecodeError:
            continue
    return out


class Stopwatch:
    """Coarse wall-clock timing, the reference's only 'profiler'
    (SURVEY.md §5.1: time.time() deltas)."""

    def __init__(self):
        self.t0 = time.time()

    def elapsed(self) -> float:
        return time.time() - self.t0

    def lap(self) -> float:
        now = time.time()
        dt = now - self.t0
        self.t0 = now
        return dt
