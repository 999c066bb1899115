"""Distributed tracing + crash-safe flight recorder (a copy of the JAX
package's ``telemetry/trace.py``, stdlib only).

- **Trace context** — every worker step opens a root span with a fresh
  ``trace_id``; child spans (fetch wait, compute, codec, store apply)
  nest via a thread-local context stack.
- **Flight recorder** — a bounded in-memory ring buffer of finished spans
  per process, dumped as JSON on SIGTERM / unhandled exception / atexit
  when a dump directory is configured.

Tracing is OFF by default: every span site costs one module-global check
plus a shared no-op context manager. Span names come from
:data:`SPAN_CATALOG`, the JAX package's names (docs/OBSERVABILITY.md).
"""

from __future__ import annotations

import atexit
import json
import os
import signal
import sys
import threading
import time
from collections import deque
from time import perf_counter as _pc
from typing import NamedTuple

__all__ = [
    "SPAN_CATALOG",
    "TraceContext",
    "FlightRecorder",
    "enable_tracing",
    "disable_tracing",
    "trace_enabled",
    "get_recorder",
    "trace_span",
    "current_context",
    "current_wire_trace",
    "use_wire_context",
    "install_shutdown_hooks",
    "add_shutdown_flush",
    "remove_shutdown_flush",
]

#: Canonical span names -> one-line meaning: every ``trace_span(...)``
#: call site uses a key from this table.
SPAN_CATALOG = {
    "worker.step": "one PS-worker loop iteration (root; attrs: worker, "
                   "step, epoch; epoch_open=True for the epoch's opening "
                   "fetch-only entry)",
    "worker.fetch_wait": "training thread blocked on a params fetch "
                         "(serial fetch or pipeline await)",
    "worker.push_wait": "training thread blocked on a gradient push "
                        "(serial push or pipeline submit backpressure)",
    "worker.compute": "compiled grad-step call (synchronized on the "
                      "result while tracing, so device time is "
                      "attributed here, not to the first consumer)",
    "worker.codec": "worker-side codec work (attr stage=encode|decode: "
                    "flatten+compress before push / decompress+unflatten "
                    "after fetch)",
    "worker.eval": "per-epoch full test-set eval (root)",
    "worker.reconnect": "session-resume state machine after a lost "
                        "server connection (root; attrs attempts, "
                        "new_worker_id, inflight=repushed|discarded|none, "
                        "outcome=gave_up on failure)",
    "pipeline.comms": "overlapped comms-thread item: push + prefetch, "
                      "parented under the submitting step",
    "rpc.client": "one client RPC attempt (attr rpc=<name>; failures "
                  "recorded with error attr)",
    "rpc.server": "server-side handler span (attr rpc=<name>), parented "
                  "on the wire-propagated worker context",
    "rpc.replica_serve": "replica serving one client fetch/infer from "
                         "cached bytes (local root; attr shard) — the "
                         "serve-tier exemplar source",
    "store.push": "store push incl. codec decode (attrs backend, "
                  "accepted)",
    "store.fetch": "store fetch incl. codec encode (attrs backend, "
                   "not_modified when delta-gated)",
    "store.apply": "parameter update apply (sync round aggregate+apply "
                   "or async staleness-weighted apply; attrs backend, "
                   "staleness/weight in async mode)",
    "trainer.step": "SPMD sync-trainer step (root; attr mode=sync)",
}


class TraceContext(NamedTuple):
    """Identity of one span: (trace_id, span_id, parent span_id|None)."""

    trace_id: str
    span_id: str
    parent_id: str | None = None


def _new_id() -> str:
    return os.urandom(8).hex()


class FlightRecorder:
    """Bounded ring buffer of finished spans (dicts), oldest evicted first.

    A record is one lock'd deque append — cheap enough to leave on for a
    whole run; the bound means a week-long process still holds only the
    tail, which is exactly what a post-mortem wants (what was it doing
    *when it died*, not in hour one).
    """

    def __init__(self, maxlen: int = 4096, role: str = "process"):
        if maxlen < 1:
            raise ValueError(f"maxlen must be >= 1, got {maxlen}")
        self.maxlen = int(maxlen)
        self.role = role
        self._spans: deque = deque(maxlen=self.maxlen)  # guarded by: self._lock
        self._lock = threading.Lock()
        self._dropped = 0  # guarded by: self._lock

    def record(self, span: dict) -> None:
        with self._lock:
            if len(self._spans) == self.maxlen:
                self._dropped += 1
            self._spans.append(span)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def tail(self, n: int | None = None) -> list[dict]:
        """Most recent ``n`` spans (all when None), oldest first."""
        with self._lock:
            spans = list(self._spans)
        if n is None:
            return spans
        n = int(n)
        return spans[-n:] if n > 0 else []  # [-0:] would mean "all"

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._dropped = 0

    def dump_payload(self, reason: str = "on_demand",
                     n: int | None = None) -> dict:
        """JSON-ready post-mortem record (the /debug/trace body and the
        crash-dump file content share this shape)."""
        spans = self.tail(n)
        with self._lock:
            dropped = self._dropped
        return {
            "kind": "flight_recorder",
            "role": self.role,
            "pid": os.getpid(),
            "reason": reason,
            "dumped_at": round(time.time(), 6),
            "buffer_size": self.maxlen,
            "dropped_spans": dropped,
            "span_count": len(spans),
            "spans": spans,
        }

    def dump_to_dir(self, dump_dir: str, reason: str) -> str:
        """Write the tail as ``trace-<role>-<pid>-<reason>.json``; returns
        the path. One file per (process, reason): a SIGTERM dump is never
        clobbered by the atexit dump that follows it."""
        os.makedirs(dump_dir, exist_ok=True)
        path = os.path.join(
            dump_dir, f"trace-{self.role}-{os.getpid()}-{reason}.json")
        payload = self.dump_payload(reason)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)  # crash mid-write never leaves torn JSON
        return path


# -- process-global state ----------------------------------------------------

_RECORDER = FlightRecorder()
_ENABLED = False
_TLS = threading.local()


def get_recorder() -> FlightRecorder:
    return _RECORDER


def trace_enabled() -> bool:
    return _ENABLED


def enable_tracing(buffer: int | None = None,
                   role: str | None = None) -> FlightRecorder:
    """Turn span recording on (idempotent). ``buffer`` resizes the ring
    (existing tail kept); ``role`` labels this process's spans/dumps."""
    global _ENABLED, _RECORDER
    if buffer is not None and int(buffer) != _RECORDER.maxlen:
        fresh = FlightRecorder(maxlen=int(buffer), role=_RECORDER.role)
        for s in _RECORDER.tail():
            fresh.record(s)
        _RECORDER = fresh
    if role is not None:
        _RECORDER.role = role
    _ENABLED = True
    return _RECORDER


def disable_tracing() -> None:
    global _ENABLED
    _ENABLED = False


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def current_context() -> TraceContext | None:
    st = getattr(_TLS, "stack", None)
    return st[-1] if st else None


def current_wire_trace() -> dict | None:
    """Current context as the wire header field ``{"trace_id", "span_id"}``
    (docs/WIRE_PROTOCOL.md), or None when tracing is off / no span open."""
    if not _ENABLED:
        return None
    ctx = current_context()
    if ctx is None:
        return None
    return {"trace_id": ctx.trace_id, "span_id": ctx.span_id}


class _NullSpan:
    """Shared no-op for disabled tracing: the entire cost of a disabled
    span site is one global check + this allocation-free enter/exit."""

    __slots__ = ()
    ctx = None

    @property
    def attrs(self) -> dict:
        # Fresh throwaway per access: call sites may write into it
        # (``sp.attrs["accepted"] = ok``) and a shared dict would leak
        # state between unrelated disabled spans.
        return {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Live span: pushes its context for the body, records on exit.

    ``__enter__`` returns the span itself — call sites may mutate
    ``.attrs`` before exit (e.g. ``sp.attrs["accepted"] = ok``) and read
    ``.ctx`` for explicit propagation (the comms pipeline captures it at
    submit time)."""

    __slots__ = ("name", "attrs", "ctx", "_root", "_ts", "_t0")

    def __init__(self, name: str, root: bool, attrs: dict):
        self.name = name
        self.attrs = attrs
        self._root = root

    def __enter__(self):
        parent = None if self._root else current_context()
        if parent is None:
            self.ctx = TraceContext(_new_id(), _new_id(), None)
        else:
            self.ctx = TraceContext(parent.trace_id, _new_id(),
                                    parent.span_id)
        _stack().append(self.ctx)
        self._ts = time.time()
        self._t0 = _pc()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = _pc() - self._t0
        st = _stack()
        if st and st[-1] is self.ctx:
            st.pop()
        elif self.ctx in st:  # misnested exit: drop ours, keep the rest
            st.remove(self.ctx)
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        span = {
            "name": self.name,
            "trace_id": self.ctx.trace_id,
            "span_id": self.ctx.span_id,
            "parent_id": self.ctx.parent_id,
            "ts": self._ts,
            "dur": dur,
            "role": _RECORDER.role,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if self.attrs:
            span["attrs"] = self.attrs
        _RECORDER.record(span)
        return False


def trace_span(name: str, root: bool = False, **attrs):
    """Context manager recording one flight-recorder span around the body.

    No-op (shared singleton, ~100 ns) when tracing is disabled. ``root``
    opens a fresh ``trace_id`` regardless of the current context (worker
    step / trainer step roots); otherwise the span parents on the
    thread-local current context (or becomes a root if there is none).
    """
    if not _ENABLED:
        return _NULL_SPAN
    return _Span(name, root, attrs)


class _WireCtx:
    """Adopt a wire-propagated ``{"trace_id", "span_id"}`` as the current
    context, so server-side spans parent on the originating worker span."""

    __slots__ = ("_ctx",)

    def __init__(self, ctx: TraceContext):
        self._ctx = ctx

    def __enter__(self):
        _stack().append(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        st = _stack()
        if st and st[-1] is self._ctx:
            st.pop()
        return False


def use_wire_context(trace_field) -> "_WireCtx | _NullSpan":
    """Context manager entering a remote peer's context. Accepts the wire
    header field dict; anything malformed (or tracing off) degrades to a
    no-op — a garbled trace field must never fail an RPC."""
    if not _ENABLED or not isinstance(trace_field, dict):
        return _NULL_SPAN
    tid, sid = trace_field.get("trace_id"), trace_field.get("span_id")
    if (not isinstance(tid, str) or not isinstance(sid, str)
            or not 0 < len(tid) <= 64 or not 0 < len(sid) <= 64):
        return _NULL_SPAN
    return _WireCtx(TraceContext(tid, sid, None))


# -- crash-safe shutdown: SIGTERM / unhandled fault / atexit -----------------

_shutdown_lock = threading.Lock()
_flush_fns: list = []
_exit_hooks_installed = False
_sigterm_installed = False
_dump_dir: str | None = None
_prev_sigterm = None
_prev_excepthook = None


def add_shutdown_flush(fn) -> None:
    """Register ``fn()`` to run at SIGTERM/atexit/unhandled-fault (e.g.
    the snapshot emitter's final flush, so a terminating process's tail
    interval is never silently dropped). Idempotent per callable."""
    with _shutdown_lock:
        if fn not in _flush_fns:
            _flush_fns.append(fn)


def remove_shutdown_flush(fn) -> None:
    with _shutdown_lock:
        if fn in _flush_fns:
            _flush_fns.remove(fn)


def _run_shutdown(reason: str) -> None:
    """Dump the recorder tail (if a dump dir is configured and anything
    was recorded) and run every registered flush. Never raises: this runs
    on the way DOWN, where a secondary failure would mask the first."""
    with _shutdown_lock:
        fns = list(_flush_fns)
        dump_dir = _dump_dir
    if dump_dir and len(_RECORDER):
        try:
            path = _RECORDER.dump_to_dir(dump_dir, reason)
            print(f"flight recorder: dumped {len(_RECORDER)} spans -> "
                  f"{path} ({reason})", file=sys.stderr, flush=True)
        except Exception:  # noqa: BLE001 — crash dump is best-effort
            pass
    for fn in fns:
        try:
            fn()
        except Exception:  # noqa: BLE001 — one bad hook can't block the rest
            pass


def _sigterm_handler(signum, frame):
    _run_shutdown("sigterm")
    if callable(_prev_sigterm):
        _prev_sigterm(signum, frame)
        return
    # Default disposition would have killed us with no cleanup; the dump
    # and flushes above ARE the cleanup. Exit hard rather than unwinding:
    # raising SystemExit from a signal handler tears down live worker
    # threads mid-computation, which can crash the interpreter on the
    # way out. 143 = 128 +
    # SIGTERM, the status a shell reports for a TERM'd process.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(143)


def _excepthook(exc_type, exc, tb):
    _run_shutdown("unhandled_exception")
    (_prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)


def install_shutdown_hooks(dump_dir: str | None = None,
                           role: str | None = None) -> None:
    """Install the SIGTERM handler, ``sys.excepthook`` wrapper, and atexit
    hook (once per process; later calls just update ``dump_dir``/role).

    Safe from non-main threads: ``signal.signal`` only works on the main
    thread, so there the SIGTERM leg is skipped (atexit/excepthook still
    fire) — in-process CLI tests run command bodies on daemon threads.
    """
    global _exit_hooks_installed, _sigterm_installed, _dump_dir, \
        _prev_sigterm, _prev_excepthook
    with _shutdown_lock:
        if dump_dir is not None:
            _dump_dir = dump_dir
        if role is not None:
            _RECORDER.role = role
        install_exit = not _exit_hooks_installed
        _exit_hooks_installed = True
        # The SIGTERM leg is tracked SEPARATELY: a first call from a
        # non-main thread must not latch it off for the process — the
        # next main-thread call still gets to install the handler.
        try_sigterm = not _sigterm_installed
    if try_sigterm:
        try:
            prev = signal.signal(signal.SIGTERM, _sigterm_handler)
        except ValueError:
            pass  # not the main thread; retry on a later call
        else:
            with _shutdown_lock:
                _sigterm_installed = True
            _prev_sigterm = prev
    if install_exit:
        _prev_excepthook, sys.excepthook = sys.excepthook, _excepthook
        atexit.register(_run_shutdown, "atexit")
