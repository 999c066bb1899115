"""gRPC client of the port: a remote ParameterStore with the in-process
interface.

The JAX package's ``comms/client.py``, carried over for a single-job,
unsharded server. :class:`RemoteStore` duck-types the worker-facing API of
:class:`~..ps.store.ParameterStore` (register_worker / fetch / push /
gradient_scales / job_finished), so :class:`~..ps.worker.PSWorker` runs
unchanged against a server in another process or on another host — the
port's or the JAX package's: both speak the same bytes.

Reference parity: registration retries 5x with exponential backoff
(worker.py:215-229); channel options match worker.py:203-209. Beyond the
reference, as in the JAX client: the hot RPCs carry a deadline and a
bounded retry on transient failures, and every push carries a unique
``nonce:count`` token (the request bytes are packed once and retried
verbatim), which the server's dedupe turns into exactly-once applies.
Trace context and the CRC-32 trailer ride only to servers that advertised
them. Directives are received and acked; the worker acting on them comes
with ROADMAP §1 item 3.

Not in this slice, each refused with ``NotImplementedError`` naming the
ROADMAP item: client-side fault injection, tenancy (``job``,
``submit_job``, ``drain_job``), the shard map and ``reshard_op`` (§1 item
9), elastic membership and session resume (``repush_last``; item 3).
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid

import grpc
import numpy as np

from ..telemetry import get_registry, now as _tnow, trace_span
from ..telemetry.trace import current_wire_trace
from .service import GRPC_OPTIONS, RPC_NAMES, SERVICE_NAME, RawJSON, \
    pack_msg, unpack_msg
from .wire import decode_tensor_dict, encode_tensor_dict

#: The RPCs this client calls: the four of the worker's lifecycle (the
#: admin plane, ``Reshard`` and ``SubmitJob``, comes with item 9).
CLIENT_RPCS = RPC_NAMES[:4]

#: Transient codes worth retrying; anything else (e.g. INVALID_ARGUMENT,
#: UNIMPLEMENTED) indicates a real protocol problem and raises immediately.
RETRYABLE_CODES = frozenset({
    grpc.StatusCode.UNAVAILABLE,
    grpc.StatusCode.DEADLINE_EXCEEDED,
    grpc.StatusCode.RESOURCE_EXHAUSTED,
})

_LATER = {
    "faults": "client-side fault injection comes with the serve tier "
              "(ROADMAP §1 item 9: comms/faults.py)",
    "jobs": "tenancy (job, SubmitJob) comes with the serve tier (ROADMAP "
            "§1 item 9: ps/tenancy.py)",
    "sharding": "the shard map and reshard come with the serve tier "
                "(ROADMAP §1 item 9: comms/sharded.py)",
    "elastic": "elastic membership comes with the store options and "
               "worker features (ROADMAP §1 item 3)",
    "resume": "session resume comes with the worker features (ROADMAP §1 "
              "item 3)",
}


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: not ported yet; {_LATER[what]}")


class SessionLostError(ConnectionError):
    """Transient failures outlived the retry budget: the server is most
    likely down or restarting. A distinct, catchable signal (the JAX
    worker's reconnect state machine acts on it; the port's worker, which
    has no session resume yet, fails). The last wire error rides as
    ``__cause__``."""


class _RemoteConfig:
    """Server-side StoreConfig facts the client learns at registration."""

    def __init__(self):
        self.elastic = False
        self.mode = "sync"
        self.learning_rate = 0.1
        self.staleness_bound = 5


class RemoteStore:
    """Client-side stand-in for ParameterStore over gRPC."""

    #: fetch() returns fp32 regardless of the server's fetch codec — the
    #: decompress happens HERE (client side).
    decompresses_fetches = True

    def __init__(self, address: str = "localhost:8000",
                 register_retries: int = 5,
                 rpc_timeout: float = 60.0,
                 rpc_retries: int = 3,
                 rpc_backoff: float = 0.5,
                 faults=None,
                 job: str | None = None):
        if faults is not None or os.environ.get("DPS_FAULTS_CLIENT"):
            raise _later("faults")
        if job is not None:
            raise _later("jobs")
        self.address = address
        self.register_retries = register_retries
        self.rpc_timeout = rpc_timeout
        self.rpc_retries = rpc_retries
        self.rpc_backoff = rpc_backoff
        #: Filled in at registration from the server's config.
        self.push_codec = "none"
        self.fetch_codec = "none"
        #: Capabilities the server advertised at registration; each gates
        #: what this client attaches (legacy pairings degrade).
        self.supports_delta_fetch = False
        self.supports_trace_context = False
        self.supports_health_report = False
        self.supports_compressed_domain = False
        self.supports_directives = False
        self.supports_checksum = False
        #: Directives received but not yet taken, and the highest seq seen
        #: (the dedupe/ack watermark).
        self._pending_directives: list[dict] = []  # guarded by: self._wire_lock
        self._directive_last_seq = 0  # guarded by: self._wire_lock
        #: Server-published per-layer gradient ABSMAX table + version.
        self._qscales: dict[str, float] = {}  # guarded by: self._wire_lock
        self._qscale_step = 0  # guarded by: self._wire_lock
        #: Zero-arg callables for a piggybacked health report and its
        #: revision; attached only when the server advertised
        #: ``health_report`` (the port's server does not).
        self.health_provider = None
        self.health_revision = None
        self._health_enc: tuple | None = None  # guarded by: self._wire_lock
        self.config = _RemoteConfig()
        # Wire accounting of SUCCESSFUL RPCs (wire_stats), under a lock:
        # concurrent RPCs release the GIL.
        self._wire_lock = threading.Lock()
        self.wire_bytes_out = 0  # guarded by: self._wire_lock
        self.wire_bytes_in = 0  # guarded by: self._wire_lock
        self.rpc_counts: dict[str, int] = {}  # guarded by: self._wire_lock
        # Push-dedupe token source: a per-client nonce + counter.
        self._push_nonce = uuid.uuid4().hex[:12]
        self._push_count = 0
        reg = get_registry()
        self._tm_rpc: dict[str, tuple] = {}
        for name in CLIENT_RPCS:
            self._tm_rpc[name] = (
                reg.histogram("dps_rpc_client_seconds", rpc=name),
                reg.counter("dps_rpc_client_bytes_total", rpc=name,
                            direction="out"),
                reg.counter("dps_rpc_client_bytes_total", rpc=name,
                            direction="in"),
                reg.counter("dps_rpc_client_calls_total", rpc=name,
                            outcome="ok"),
                reg.counter("dps_rpc_client_calls_total", rpc=name,
                            outcome="retry"),
                reg.counter("dps_rpc_client_calls_total", rpc=name,
                            outcome="error"),
            )
        self._tm_fetch_nm = reg.counter(
            "dps_rpc_client_fetch_not_modified_total")
        self._channel = grpc.insecure_channel(address, options=GRPC_OPTIONS)
        ident = lambda b: b  # noqa: E731
        self._call = {
            name: self._channel.unary_unary(
                f"/{SERVICE_NAME}/{name}",
                request_serializer=ident, response_deserializer=ident)
            for name in CLIENT_RPCS
        }

    def _invoke(self, name: str, request: bytes):
        """Call RPC ``name`` with a deadline, retrying transient failures
        (RETRYABLE_CODES) up to ``rpc_retries`` times with exponential
        backoff. Non-transient codes raise immediately."""
        hist, b_out, b_in, c_ok, c_retry, c_err = self._tm_rpc[name]
        delay = self.rpc_backoff
        for attempt in range(self.rpc_retries + 1):
            t0 = _tnow()
            # One trace span per ATTEMPT: a retried RPC's trace shows each
            # wire round trip.
            with trace_span("rpc.client", rpc=name, attempt=attempt) as sp:
                try:
                    reply = self._call[name](request,
                                             timeout=self.rpc_timeout)
                except grpc.RpcError as e:
                    hist.observe(_tnow() - t0)
                    code = e.code() if callable(getattr(e, "code", None)) \
                        else None
                    sp.attrs["error"] = (code.name if code is not None
                                         else type(e).__name__)
                    if code not in RETRYABLE_CODES:
                        c_err.inc()
                        raise
                    if attempt >= self.rpc_retries:
                        c_err.inc()
                        raise SessionLostError(
                            f"{name} failed with {code.name} after "
                            f"{attempt + 1} attempts against "
                            f"{self.address}") from e
                    c_retry.inc()
                else:
                    hist.observe(_tnow() - t0)
                    with self._wire_lock:
                        self.wire_bytes_out += len(request)
                        self.wire_bytes_in += len(reply)
                        self.rpc_counts[name] = \
                            self.rpc_counts.get(name, 0) + 1
                    b_out.inc(len(request))
                    b_in.inc(len(reply))
                    c_ok.inc()
                    return reply
            time.sleep(delay)
            delay *= 2

    def wire_stats(self) -> dict:
        """Cumulative client-side wire accounting (bytes + per-RPC counts
        of successful calls); PSWorker merges this into its METRICS_JSON
        row."""
        with self._wire_lock:
            return {"wire_bytes_out": self.wire_bytes_out,
                    "wire_bytes_in": self.wire_bytes_in,
                    "rpc_counts": dict(self.rpc_counts)}

    def _note_reply(self, reply_meta: dict) -> None:
        """What a register/fetch/push reply may carry that this slice
        does not serve: refused, never silently ignored."""
        if reply_meta.get("shard_map") is not None:
            raise _later("sharding")

    def _note_directives(self, reply_meta: dict) -> None:
        """Collect piggybacked server->worker directives off a reply
        (capability-gated), deduped by seq: the server re-attaches
        outstanding directives until acked. Malformed entries are dropped;
        directives must never fail the RPC that carried them."""
        if not self.supports_directives:
            return
        ds = reply_meta.get("directives")
        if not isinstance(ds, list):
            return
        with self._wire_lock:
            for d in ds:
                if not isinstance(d, dict):
                    continue
                try:
                    seq = int(d["seq"])
                except (KeyError, TypeError, ValueError):
                    continue
                if seq <= self._directive_last_seq \
                        or not isinstance(d.get("action"), str):
                    continue
                self._directive_last_seq = seq
                self._pending_directives.append(dict(d))

    def take_directives(self) -> list[dict]:
        """Drain the pending directives."""
        with self._wire_lock:
            out, self._pending_directives = self._pending_directives, []
            return out

    def _attach_directive_ack(self, meta: dict) -> None:
        if self.supports_directives:
            with self._wire_lock:
                meta["directives_ack"] = self._directive_last_seq

    def _note_qscales(self, reply_meta: dict) -> None:
        """Adopt a piggybacked shared-scale table (register/fetch reply
        meta). A malformed table degrades to the cached one."""
        if not self.supports_compressed_domain:
            return
        qs = reply_meta.get("qscales")
        if not isinstance(qs, dict):
            return
        try:
            table = {str(k): float(v) for k, v in qs.items()}
            step = int(reply_meta.get("qscale_step", 0))
        except (TypeError, ValueError):
            return
        with self._wire_lock:
            self._qscales = table
            self._qscale_step = step

    def gradient_scales(self) -> tuple[dict[str, float], int]:
        """Client-side cache of the server's per-layer gradient absmax
        table (PSWorker quantizes against it)."""
        with self._wire_lock:
            return dict(self._qscales), self._qscale_step

    def register_worker(self, worker_name: str = "") -> tuple[int, int]:
        """Retry x5 with exponential backoff (worker.py:215-229)."""
        hist, b_out, b_in, c_ok, c_retry, c_err = \
            self._tm_rpc["RegisterWorker"]
        delay = 1.0
        last_err = None
        for attempt in range(self.register_retries):
            t0 = _tnow()
            try:
                # ``capabilities`` advertises what THIS client takes
                # (directives flow server->worker).
                request = pack_msg({"worker_name": worker_name,
                                    "capabilities": ["directives"]})
                raw = self._call["RegisterWorker"](request,
                                                   timeout=self.rpc_timeout)
                hist.observe(_tnow() - t0)
                b_out.inc(len(request))
                b_in.inc(len(raw))
                c_ok.inc()
                reply, _ = unpack_msg(raw)
                self._note_reply(reply)
                if reply.get("elastic"):
                    raise _later("elastic")
                self.push_codec = reply.get("push_codec", "none")
                self.fetch_codec = reply.get("fetch_codec", "none")
                self.supports_delta_fetch = bool(
                    reply.get("delta_fetch", False))
                self.supports_trace_context = bool(
                    reply.get("trace_context", False))
                self.supports_health_report = bool(
                    reply.get("health_report", False))
                self.supports_compressed_domain = bool(
                    reply.get("compressed_domain", False))
                self.supports_directives = bool(
                    reply.get("directives", False))
                self.supports_checksum = bool(
                    reply.get("checksum", False))
                # A fresh registration starts a fresh directive stream and
                # scale table.
                with self._wire_lock:
                    self._pending_directives = []
                    self._directive_last_seq = 0
                    self._qscales, self._qscale_step = {}, 0
                self._note_qscales(reply)
                self.config.mode = reply.get("mode", "sync")
                self.config.learning_rate = float(
                    reply.get("learning_rate", 0.1))
                self.config.staleness_bound = int(
                    reply.get("staleness_bound", 5))
                return int(reply["worker_id"]), int(reply["total_workers"])
            except grpc.RpcError as e:
                hist.observe(_tnow() - t0)
                if attempt == self.register_retries - 1:
                    c_err.inc()
                else:
                    c_retry.inc()
                    time.sleep(delay)
                    delay *= 2
                last_err = e
        raise ConnectionError(
            f"registration failed after {self.register_retries} attempts: "
            f"{last_err}")

    def _attach_health(self, meta: dict) -> None:
        """Piggyback the worker's health report on an outbound envelope
        (capability-gated). A provider failure degrades to a report-less
        message."""
        if not self.supports_health_report or self.health_provider is None:
            return
        rev = None
        if self.health_revision is not None:
            try:
                rev = self.health_revision()
            except Exception:  # noqa: BLE001
                rev = None
        if rev is not None:
            with self._wire_lock:
                cached = self._health_enc
            if cached is not None and cached[0] == rev:
                meta["health"] = cached[1]
                return
        try:
            report = self.health_provider()
        except Exception:  # noqa: BLE001
            return
        if isinstance(report, dict) and report:
            if rev is None:
                meta["health"] = report
                return
            enc = RawJSON(json.dumps(report))
            with self._wire_lock:
                self._health_enc = (rev, enc)
            meta["health"] = enc

    def fetch(self, worker_id: int | None = None,
              have_step: int | None = None
              ) -> tuple[dict[str, np.ndarray], int]:
        """Fetch params (+ step). With ``have_step`` (and a server that
        advertised ``delta_fetch``), a server whose step hasn't advanced
        replies NOT_MODIFIED — returned as ``({}, step)`` with ``step ==
        have_step``. Decoded arrays are read-only views into the reply."""
        meta = {} if worker_id is None else {"worker_id": worker_id}
        if worker_id is not None:
            self._attach_health(meta)
            self._attach_directive_ack(meta)
        if have_step is not None and self.supports_delta_fetch:
            meta["have_step"] = int(have_step)
        if self.supports_compressed_domain:
            with self._wire_lock:
                meta["have_qscales"] = self._qscale_step
        if self.supports_trace_context:
            wt = current_wire_trace()
            if wt is not None:
                meta["trace"] = wt
        reply = self._invoke("FetchParameters", pack_msg(meta))
        rmeta, payload = unpack_msg(reply)
        self._note_reply(rmeta)
        self._note_qscales(rmeta)
        self._note_directives(rmeta)
        if rmeta.get("not_modified"):
            self._tm_fetch_nm.inc()
            return {}, int(rmeta["global_step"])
        with trace_span("worker.codec", stage="decode"):
            params = decode_tensor_dict(payload)
            if self.fetch_codec == "fp16":
                from ..ops.compression import fp16_decompress
                params = fp16_decompress(params)
            elif self.fetch_codec == "bf16":
                from ..ops.compression import bf16_decompress
                params = bf16_decompress(params)
        return params, int(rmeta["global_step"])

    def push(self, worker_id: int, gradients: dict, fetched_step: int) -> bool:
        """Encode and send as-is: the caller (PSWorker._push) applies the
        codec, so compressed bytes hit the wire exactly once."""
        self._push_count += 1
        wt = current_wire_trace() if self.supports_trace_context else None
        token = f"{self._push_nonce}:{self._push_count}"
        meta = {"worker_id": worker_id, "fetched_step": fetched_step,
                "push_token": token}
        if wt is not None:
            meta["trace"] = wt
        self._attach_health(meta)
        self._attach_directive_ack(meta)
        payload = encode_tensor_dict(gradients, trace=wt,
                                     checksum=self.supports_checksum)
        reply = self._invoke("PushGradrients", pack_msg(meta, payload))
        rmeta, _ = unpack_msg(reply)
        self._note_reply(rmeta)
        self._note_directives(rmeta)
        return bool(rmeta["accepted"])

    def reshard_op(self, op: str, payload: bytes = b"", **fields):
        raise _later("sharding")

    def submit_job(self, spec: str) -> dict:
        raise _later("jobs")

    def drain_job(self, name: str) -> dict:
        raise _later("jobs")

    def repush_last(self, worker_id: int):
        raise _later("resume")

    def job_finished(self, worker_id: int) -> None:
        self._invoke("JobFinished", pack_msg({"worker_id": worker_id}))

    def close(self) -> None:
        self._channel.close()
