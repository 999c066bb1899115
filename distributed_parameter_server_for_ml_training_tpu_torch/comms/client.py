"""gRPC client of the port: a remote ParameterStore with the in-process
interface.

The JAX package's ``comms/client.py``, carried over for a single-job
server, unsharded or one shard primary. :class:`RemoteStore` duck-types
the worker-facing API of
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
them. Directives are received and acked; the worker acts on them
(``ps/worker.py:_apply_directive``). An elastic server's live membership is cached off
its register and fetch replies (``membership_snapshot``). Session resume
rides on ``register_worker(retries=1)``, ``reset_channel`` and
``repush_last``, which replays the most recent push under the SAME token.
A shard primary's map is adopted off the register and fetch replies
(validated first: a garbled refresh keeps the cached map), sent back as
``have_shard_map``, and the keys a push reply names ``disowned`` are kept
in ``last_disowned`` for ``comms/sharded.py`` to re-route.

Deterministic client-side fault injection (``faults=`` or env
``DPS_FAULTS_CLIENT``, ``comms/faults.py``) sits between the retry layer
and the channel, so injected faults exercise the real backoff and
reconnect paths; it survives ``reset_channel``.

``reshard_op`` carries the admin plane's ``Reshard`` RPC for ``cli
reshard``. Not in this slice, refused with ``NotImplementedError`` naming
the ROADMAP item: tenancy (``job``, ``submit_job``, ``drain_job``, §1
item 9).
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid

import grpc
import numpy as np

from ..ps.sharding import validate_shard_map
from ..telemetry import get_registry, now as _tnow, trace_span
from ..telemetry.trace import current_wire_trace
from .service import GRPC_OPTIONS, RPC_NAMES, SERVICE_NAME, RawJSON, \
    pack_msg, unpack_msg
from .wire import decode_tensor_dict, encode_tensor_dict

#: The RPCs this client calls: the four of the worker's lifecycle and
#: the admin plane's ``Reshard`` (``SubmitJob`` comes with tenancy,
#: ROADMAP §1 item 9).
CLIENT_RPCS = RPC_NAMES[:5]

#: Transient codes worth retrying; anything else (e.g. INVALID_ARGUMENT,
#: UNIMPLEMENTED) indicates a real protocol problem and raises immediately.
RETRYABLE_CODES = frozenset({
    grpc.StatusCode.UNAVAILABLE,
    grpc.StatusCode.DEADLINE_EXCEEDED,
    grpc.StatusCode.RESOURCE_EXHAUSTED,
})

_LATER = {
    "jobs": "tenancy (job, SubmitJob) comes with the serve tier (ROADMAP "
            "§1 item 9: ps/tenancy.py)",
}


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: not ported yet; {_LATER[what]}")


class SessionLostError(ConnectionError):
    """Transient failures outlived the retry budget: the server is most
    likely down or restarting. A distinct, catchable signal the worker's
    reconnect state machine acts on (``ps/worker.py:_recover_session``):
    re-register, re-fetch at the restored step, reconcile the in-flight
    gradient. The last wire error rides as ``__cause__``."""


class _RemoteConfig:
    """Server-side StoreConfig facts the client learns at registration
    (the worker reads ``elastic`` for its shard and ``mode`` and
    ``staleness_bound`` to reconcile a gradient stranded by a session
    loss)."""

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
        #: A shard primary's published map (``ps/sharding.py`` schema),
        #: adopted off the register reply (its presence is the capability)
        #: and refreshed off fetch replies, delta-gated on the version sent
        #: back as ``have_shard_map``. None against an unsharded server.
        self.shard_map = None
        self._shard_map_version = 0
        #: Keys the last push reply named disowned: the primary's map moved
        #: while this client pushed on a cached one, so that slice did not
        #: apply there (``comms/sharded.py`` re-routes it).
        self.last_disowned: list[str] = []
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
        # Last membership seen on the wire (elastic servers piggyback it on
        # register and fetch replies).
        self._membership: list[int] = []
        # The most recent push's (token, payload, fetched_step): after a
        # session loss repush_last re-sends it verbatim but for the worker
        # id.
        self._last_push: tuple[str, bytes, int] | None = None
        # Deterministic client-side fault injection (comms/faults.py): a
        # spec string (or a prebuilt FaultInjector) interposes between the
        # retry layer and the channel. Env DPS_FAULTS_CLIENT applies when
        # the caller passes nothing.
        if faults is None:
            faults = os.environ.get("DPS_FAULTS_CLIENT") or None
        if isinstance(faults, str):
            from .faults import FaultInjector
            faults = FaultInjector(faults, side="client")
        self.faults = faults
        self._channel = None
        self._build_channel()

    def _build_channel(self) -> None:
        """(Re)build the channel and the method stubs: the one place the
        method list and channel options are wired, shared by construction
        and ``reset_channel``."""
        self._channel = grpc.insecure_channel(self.address,
                                              options=GRPC_OPTIONS)
        ident = lambda b: b  # noqa: E731
        self._call = {
            name: self._channel.unary_unary(
                f"/{SERVICE_NAME}/{name}",
                request_serializer=ident, response_deserializer=ident)
            for name in CLIENT_RPCS
        }
        if self.faults is not None:
            # Re-applied on every rebuild: the injector is shared, so its
            # n=/every= schedules keep counting across a reset.
            from .faults import install_client_faults
            install_client_faults(self, self.faults)

    def reset_channel(self) -> None:
        """Tear down and rebuild the channel and its stubs. A channel
        connected to a server process that DIED can stay wedged in
        connect backoff after a replacement listens on the same port; the
        worker's reconnect state machine calls this before each
        re-registration attempt. The old channel is closed BEFORE its
        replacement is built, so at most one is live."""
        old, self._channel = self._channel, None
        try:
            old.close()
        except Exception:  # noqa: BLE001 — a dead channel may complain
            pass
        self._build_channel()

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

    def _note_shard_map(self, reply_meta: dict) -> None:
        """Adopt a piggybacked shard map (register/fetch/push reply meta).
        Validated before adoption; a garbled or older map leaves the
        cached one in place, so routing never regresses off a bad
        refresh."""
        m = reply_meta.get("shard_map")
        if m is None:
            return
        try:
            norm = validate_shard_map(m)
        except ValueError:
            return
        if self.shard_map is None \
                or norm["version"] >= self._shard_map_version:
            self.shard_map = norm
            self._shard_map_version = norm["version"]

    def _note_membership(self, reply_meta: dict) -> None:
        m = reply_meta.get("active_workers")
        if m is not None:
            self._membership = [int(w) for w in m]

    def membership_snapshot(self) -> list[int]:
        """Client-side view of the server's live membership (sorted ids),
        as of the most recent register/fetch reply. Empty until the first
        reply from an elastic server."""
        return list(self._membership)

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

    def register_worker(self, worker_name: str = "",
                        retries: int | None = None) -> tuple[int, int]:
        """Retry x5 with exponential backoff (worker.py:215-229).
        ``retries`` overrides the constructor's budget: the reconnect state
        machine passes 1 and paces its own backoff."""
        hist, b_out, b_in, c_ok, c_retry, c_err = \
            self._tm_rpc["RegisterWorker"]
        delay = 1.0
        last_err = None
        register_retries = (self.register_retries if retries is None
                            else max(1, int(retries)))
        for attempt in range(register_retries):
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
                # A restarted primary's map versions restart from 1, so
                # the cached version must not suppress the fresh map.
                self.shard_map, self._shard_map_version = None, 0
                self._note_shard_map(reply)
                self.config.elastic = bool(reply.get("elastic", False))
                self.config.mode = reply.get("mode", "sync")
                self.config.learning_rate = float(
                    reply.get("learning_rate", 0.1))
                self.config.staleness_bound = int(
                    reply.get("staleness_bound", 5))
                self._note_membership(reply)
                return int(reply["worker_id"]), int(reply["total_workers"])
            except grpc.RpcError as e:
                hist.observe(_tnow() - t0)
                if attempt == register_retries - 1:
                    c_err.inc()
                else:
                    c_retry.inc()
                    time.sleep(delay)
                    delay *= 2
                last_err = e
        raise ConnectionError(
            f"registration failed after {register_retries} attempts: "
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
        if self.shard_map is not None:
            meta["have_shard_map"] = self._shard_map_version
        if self.supports_trace_context:
            wt = current_wire_trace()
            if wt is not None:
                meta["trace"] = wt
        reply = self._invoke("FetchParameters", pack_msg(meta))
        rmeta, payload = unpack_msg(reply)
        self._note_membership(rmeta)
        self._note_qscales(rmeta)
        self._note_directives(rmeta)
        self._note_shard_map(rmeta)
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
        # Recorded BEFORE the send: a push that dies mid-RPC is exactly
        # the one the reconnect path must be able to re-send verbatim.
        self._last_push = (token, payload, int(fetched_step))
        reply = self._invoke("PushGradrients", pack_msg(meta, payload))
        rmeta, _ = unpack_msg(reply)
        self._note_directives(rmeta)
        # A push that raced a map move comes back with the primary's fresh
        # map and the keys it disowned; the map is adopted first, so a
        # re-route already targets the new owner.
        self._note_shard_map(rmeta)
        if self.shard_map is not None:
            d = rmeta.get("disowned")
            self.last_disowned = \
                [str(k) for k in d] if isinstance(d, list) else []
        return bool(rmeta["accepted"])

    def reshard_op(self, op: str, payload: bytes = b"",
                   **fields) -> tuple[dict, memoryview]:
        """Admin-plane Reshard RPC (docs/SHARDING.md "Migration
        protocol"): one of ``RESHARD_OPS`` against ONE primary. Returns
        the raw reply ``(meta, payload)``: the coordinator (``cli
        reshard``) owns the protocol ordering and interprets the fields;
        this client only carries the envelope. Extra keyword fields
        (``slot_lo``, ``slot_hi``, ``ranges``, ``map_version``,
        ``journal``, ``migration``) pass through to the request meta
        verbatim."""
        request = pack_msg({"op": op, **fields}, payload)
        reply = self._invoke("Reshard", request)
        return unpack_msg(reply)

    def submit_job(self, spec: str) -> dict:
        raise _later("jobs")

    def drain_job(self, name: str) -> dict:
        raise _later("jobs")

    def repush_last(self, worker_id: int) -> bool | None:
        """Re-send the most recent push — same token, same payload, same
        ``fetched_step`` — under (possibly) a new worker id: the
        session-resume reconciliation. The server's dedupe is keyed by the
        token's nonce, so a push the server already applied replays as a
        duplicate instead of applying twice; one whose apply was lost
        applies now. Returns the accepted outcome, or None when there is
        nothing to re-send."""
        if self._last_push is None:
            return None
        token, payload, fetched_step = self._last_push
        meta = {"worker_id": worker_id, "fetched_step": fetched_step,
                "push_token": token}
        reply = self._invoke("PushGradrients", pack_msg(meta, payload))
        rmeta, _ = unpack_msg(reply)
        return bool(rmeta["accepted"])

    def job_finished(self, worker_id: int) -> None:
        self._invoke("JobFinished", pack_msg({"worker_id": worker_id}))

    def close(self) -> None:
        self._channel.close()
