"""Deterministic, seeded fault injection for the comms layer.

The JAX package's ``comms/faults.py``, carried over whole (it is plain
Python over grpc; the port keeps its own copy, with the port's
registry): the same grammar, the same per-rule seeding, so one spec
gives the same schedule in both packages.

The crash-recovery subsystem (docs/ROBUSTNESS.md) is only credible if its
claims hold under *injected* faults, reproducibly — "we survived one lucky
run" is not fault tolerance. This module is the single injection point both
sides of the wire share:

- **client side** (`install_client_faults`): wraps ``RemoteStore``'s raw
  gRPC callables, so an injected UNAVAILABLE/DEADLINE_EXCEEDED exercises
  the real retry + reconnect machinery (`comms/client.py`), and an
  injected ``drop_reply`` performs the REAL call and then discards the
  reply — the server applied the gradient, the client never heard — which
  is exactly the lost-reply case the push-token exactly-once dedupe exists
  for (`comms/service.py`);
- **server side** (``ParameterService(faults=...)``): wraps the RPC
  handler bodies — delays model a slow server, aborts model an
  overloaded one, ``drop_reply`` aborts AFTER the handler (and therefore
  the store apply) completed, and ``kill`` hard-exits the process
  mid-handler to produce a deterministic crash point for restart drills
  (the JAX package's ``experiments/run_chaos_soak.py``).

Determinism: every rule owns a counter and, for probabilistic rules, a
``random.Random`` seeded from ``(spec seed, rule index)``. A decision is a
pure function of the spec and the per-op call index, so the same seed and
the same call sequence replay the same fault schedule
(``tests/test_torch_faults.py`` holds it to the JAX package's).

Spec grammar (CLI ``--faults`` / env ``DPS_FAULTS_CLIENT`` /
``DPS_FAULTS_SERVER``)::

    spec  := [ 'seed=' int ';' ] rule ( ';' rule )*
    rule  := op '.' kind [ '=' float ] '@' when
    op    := 'push' | 'fetch' | 'register' | 'finish' | 'any' | 'compute'
           | 'reshard' | 'refresh' | 'subscribe'
    kind  := 'unavailable' | 'deadline' | 'delay' | 'drop_reply' | 'kill'
           | 'delay_compute' | 'partition' | 'corrupt'
    when  := 'p=' float          # per-call probability (seeded RNG)
           | 'n=' int(,int)*     # specific 1-based call indices for op
           | 'every=' int        # every k-th call

Examples::

    seed=7;push.unavailable@p=0.2        # 20% of pushes fail UNAVAILABLE
    fetch.delay=0.05@every=3             # every 3rd fetch sleeps 50 ms
    push.drop_reply@n=2,5                # pushes 2 and 5 apply, reply lost
    any.kill@n=40                        # the 40th RPC kills the server
    compute.delay_compute=0.25@every=1   # every local step +250 ms (a
                                         # deterministic straggler; the
                                         # worker loop polls this op once
                                         # per step — 'any' never matches)
    reshard.kill@n=2                     # 2nd migration op kills the
                                         # primary mid-handoff
    refresh.partition=2@n=5              # the replica's 5th refresh
                                         # opens a 2 s partition window
    push.corrupt@every=4                 # every 4th push payload gets a
                                         # deterministic byte flip

The first matching rule per call wins. ``delay`` composes with nothing —
it IS the action (the call proceeds after the sleep).

Serve-tier ops: ``reshard`` targets the admin-plane Reshard RPC (a
shard primary's migration ops, wrapped server side like the four worker
RPCs, and client side under ``RemoteStore.reshard_op``); ``refresh``
the replica's subscription poll against its primary (client side of
`comms/replica.py`); ``subscribe`` the replica's OWN fetch-serving
handler. ``any`` still means exactly the four worker RPCs
(``ANY_EXCLUDED``) so pre-existing seeded chaos schedules replay
byte-identically.

New kinds: ``partition`` drops every matching call — both directions,
nothing sent, nothing executed — for a ``value``-second window opened
when the rule triggers (default 1 s); ``corrupt`` flips one
deterministically-chosen byte of the request's tensor-payload region and
lets the call proceed, which is exactly what the wire CRC trailer
(comms/wire.py FLAG_CRC) must catch.
"""

from __future__ import annotations

import os
import random
import struct
import threading
import time
from dataclasses import dataclass

import grpc

__all__ = [
    "ANY_EXCLUDED",
    "COMPUTE_OP",
    "FAULT_KINDS",
    "FAULT_OPS",
    "REFRESH_OP",
    "SUBSCRIBE_OP",
    "FaultInjector",
    "FaultRule",
    "InjectedRpcError",
    "corrupt_request",
    "install_client_faults",
    "parse_fault_spec",
]

#: The pseudo-op the worker loop polls once per LOCAL STEP for injected
#: compute slowdowns (``ps/worker.py`` via :meth:`maybe_delay_compute`) —
#: deliberately not a real RPC name, so RPC-side wrappers never see it
#: and ``any`` rules (which span the four RPCs) never match it.
COMPUTE_OP = "__compute__"

#: Pseudo-RPC names for the replica tier's two wire directions
#: (comms/replica.py): the subscription poll replica->primary (client
#: side) and the replica's own fetch-serving handler (server side). Both
#: are FetchParameters on the real wire, but a chaos schedule must be
#: able to partition the SUBSCRIPTION without touching serve traffic
#: (and vice versa), so each direction decides under its own op name.
REFRESH_OP = "__replica_refresh__"
SUBSCRIBE_OP = "__replica_subscribe__"

#: op name (spec vocabulary) -> RPC method name (None = 'any').
FAULT_OPS = {
    "push": "PushGradrients",  # quirk 1 typo is the wire contract
    "fetch": "FetchParameters",
    "register": "RegisterWorker",
    "finish": "JobFinished",
    "any": None,
    "compute": COMPUTE_OP,  # worker-loop per-step hook, not an RPC
    "reshard": "Reshard",  # admin-plane migration protocol
    "refresh": REFRESH_OP,  # replica subscription poll (client side)
    "subscribe": SUBSCRIBE_OP,  # replica's serving handler (server side)
}

#: RPC/pseudo-op names an 'any' rule never matches. 'any' has always
#: meant "the four worker RPCs"; keeping the admin plane and the replica
#: tier out preserves every pre-existing seeded schedule byte-for-byte
#: (an 'any.kill@n=40' chaos soak must not start counting reshard ops).
ANY_EXCLUDED = frozenset({COMPUTE_OP, "Reshard", REFRESH_OP,
                          SUBSCRIBE_OP})

FAULT_KINDS = ("unavailable", "deadline", "delay", "drop_reply", "kill",
               "delay_compute", "partition", "corrupt")

_STATUS = {
    "unavailable": grpc.StatusCode.UNAVAILABLE,
    "deadline": grpc.StatusCode.DEADLINE_EXCEEDED,
    "drop_reply": grpc.StatusCode.UNAVAILABLE,  # a lost reply looks transient
    "partition": grpc.StatusCode.UNAVAILABLE,  # a dropped packet looks down
}


class InjectedRpcError(grpc.RpcError):
    """Client-side injected failure, shaped like a live-channel error (the
    retry layer only reads ``.code()``)."""

    def __init__(self, code: grpc.StatusCode, detail: str):
        super().__init__()
        self._code = code
        self._detail = detail

    def code(self) -> grpc.StatusCode:
        return self._code

    def details(self) -> str:
        return self._detail

    def __str__(self) -> str:
        return f"injected {self._code.name}: {self._detail}"


@dataclass(frozen=True)
class FaultRule:
    op: str                        # key of FAULT_OPS
    kind: str                      # one of FAULT_KINDS
    value: float = 0.0             # delay seconds (kind='delay')
    prob: float | None = None      # when := p=
    at: frozenset | None = None    # when := n= (1-based per-op call index)
    every: int | None = None       # when := every=

    def matches_rpc(self, rpc_name: str) -> bool:
        target = FAULT_OPS[self.op]
        if target is None:
            # 'any' spans the four worker RPCs; compute, the admin
            # plane, and the replica tier are only ever hit by their own
            # explicit op rules (ANY_EXCLUDED — schedule stability).
            return rpc_name not in ANY_EXCLUDED
        return target == rpc_name


def corrupt_request(data: bytes, salt: int) -> bytes:
    """Flip ONE byte of an envelope's tensor-payload region,
    deterministically chosen from ``salt`` (the rule's per-hit counter) —
    same spec, same call sequence, same flipped byte, so a corrupt drill
    is as replayable as every other kind. Falls back to the meta JSON for
    header-only envelopes (still a corrupt request — the server's
    envelope parse fails loud instead of the CRC check)."""
    buf = bytearray(data)
    if len(buf) <= 4:
        return bytes(buf)  # no envelope to speak of; nothing to flip
    start = 4
    try:
        (hlen,) = struct.unpack_from("<I", data, 0)
    except struct.error:
        hlen = 0
    if 0 < hlen <= len(buf) - 4 - 1:
        # Flip inside the tensor payload (after the meta JSON) when one
        # exists — the case the wire CRC trailer must catch.
        start = 4 + hlen
    off = start + (salt * 2654435761) % (len(buf) - start)
    buf[off] ^= 0xFF
    return bytes(buf)


def parse_fault_spec(spec: str) -> tuple[int, list[FaultRule]]:
    """Parse a spec string -> (seed, rules). Raises ValueError with the
    offending fragment on any malformed rule — a typo'd chaos schedule must
    fail the run at startup, not silently inject nothing."""
    seed = 0
    rules: list[FaultRule] = []
    for raw in spec.split(";"):
        part = raw.strip()
        if not part:
            continue
        if part.startswith("seed="):
            seed = int(part[5:])
            continue
        try:
            head, when = part.split("@", 1)
            op, _, kind_val = head.partition(".")
            kind, _, val = kind_val.partition("=")
            if op not in FAULT_OPS:
                raise ValueError(f"unknown op {op!r}")
            if kind not in FAULT_KINDS:
                raise ValueError(f"unknown kind {kind!r}")
            if (kind == "delay_compute") != (op == "compute"):
                # delay_compute is the compute pseudo-op's ONLY kind: a
                # compute slowdown on an RPC op (or an RPC fault on the
                # compute op) is a typo'd schedule, and a typo'd chaos
                # schedule must fail at startup.
                raise ValueError(
                    "delay_compute pairs with op 'compute' (and "
                    "'compute' supports only delay_compute)")
            value = float(val) if val else 0.0
            prob = at = every = None
            if when.startswith("p="):
                prob = float(when[2:])
                if not 0.0 <= prob <= 1.0:
                    raise ValueError(f"p={prob} outside [0, 1]")
            elif when.startswith("n="):
                at = frozenset(int(x) for x in when[2:].split(","))
                if not at or min(at) < 1:
                    raise ValueError("n= wants 1-based call indices")
            elif when.startswith("every="):
                every = int(when[6:])
                if every < 1:
                    raise ValueError("every= wants a positive int")
            else:
                raise ValueError(f"unknown trigger {when!r}")
            rules.append(FaultRule(op=op, kind=kind, value=value,
                                   prob=prob, at=at, every=every))
        except ValueError as e:
            raise ValueError(f"bad fault rule {part!r}: {e}") from None
    if not rules:
        raise ValueError(f"fault spec {spec!r} contains no rules")
    return seed, rules


class FaultInjector:
    """Decides, per RPC call, which fault (if any) to inject.

    One injector instance per process side; thread-safe (RPCs arrive on
    gRPC's thread pool / the worker's comms thread). Decisions consume
    per-rule state (call counters, seeded RNG draws), so two injectors
    built from the same spec replay identical schedules for identical
    call sequences.
    """

    def __init__(self, spec: str, side: str = "client",
                 _telemetry: bool = True):
        self.spec = spec
        self.side = side
        self.seed, self.rules = parse_fault_spec(spec)
        self._lock = threading.Lock()
        # Per-op call counters (1-based at decision time) + one RNG per
        # rule: a probabilistic rule's draw sequence must not shift when an
        # unrelated rule is added or another op is called.
        self._op_calls: dict[str, int] = {}
        self._rngs = [random.Random((self.seed << 8) ^ (i * 2654435761))
                      for i in range(len(self.rules))]
        # Partition windows: rule index -> wall-clock deadline. While a
        # rule's window is open EVERY matching call drops (both
        # directions dead), not just the triggering one — that is what
        # makes it a partition rather than a point failure.
        self._partition_until: dict[int, float] = {}  # guarded by: self._lock
        # Per-rule hit counters salting the corrupt byte-flip offset.
        self._rule_hits: dict[int, int] = {}  # guarded by: self._lock
        # _telemetry=False (schedule_preview's probe) keeps phantom
        # counters out of the process registry: a preview replays the
        # schedule without claiming injections happened on the wire.
        if _telemetry:
            from ..telemetry import get_registry
            reg = get_registry()
            self._tm = {
                (op, kind): reg.counter("dps_fault_injections_total",
                                        side=side, op=op, kind=kind)
                for op in FAULT_OPS for kind in FAULT_KINDS
            }
        else:
            class _Noop:
                def inc(self, n=1):
                    pass
            noop = _Noop()
            self._tm = {(op, kind): noop
                        for op in FAULT_OPS for kind in FAULT_KINDS}

    def decide(self, rpc_name: str) -> FaultRule | None:
        """One decision per RPC call: the first rule that matches and
        triggers wins; None = no fault this call."""
        with self._lock:
            n = self._op_calls.get(rpc_name, 0) + 1
            self._op_calls[rpc_name] = n
            for i, rule in enumerate(self.rules):
                if not rule.matches_rpc(rpc_name):
                    continue
                if rule.kind == "partition" and \
                        time.time() < self._partition_until.get(i, 0.0):
                    # Open window: the call drops without consuming the
                    # rule's trigger state — the window IS the fault.
                    self._tm[(rule.op, rule.kind)].inc()
                    return rule
                if rule.at is not None:
                    hit = n in rule.at
                elif rule.every is not None:
                    hit = n % rule.every == 0
                else:
                    # The draw happens on every matching call (hit or not)
                    # so the sequence is reproducible regardless of which
                    # draws land.
                    hit = self._rngs[i].random() < (rule.prob or 0.0)
                if hit:
                    if rule.kind == "partition":
                        self._partition_until[i] = \
                            time.time() + (rule.value or 1.0)
                    self._rule_hits[i] = self._rule_hits.get(i, 0) + 1
                    self._tm[(rule.op, rule.kind)].inc()
                    return rule
        return None

    def corrupt_salt(self, rule: FaultRule) -> int:
        """The number of times ``rule`` has triggered so far (1-based at
        the moment of a hit) — the deterministic salt
        :func:`corrupt_request` flips with."""
        for i, r in enumerate(self.rules):
            if r is rule:
                with self._lock:
                    return self._rule_hits.get(i, 0)
        return 0

    def maybe_delay_compute(self) -> float:
        """Worker-loop hook (``ps/worker.py``): one decision per local
        step against the compute pseudo-op; sleeps and returns the
        injected seconds on a hit, 0.0 otherwise. The deterministic
        straggler knob — ``compute.delay_compute=0.25@every=1`` slows
        every step by 250 ms, same seed -> same schedule."""
        rule = self.decide(COMPUTE_OP)
        if rule is None or rule.kind != "delay_compute":
            return 0.0
        if rule.value > 0:
            time.sleep(rule.value)
        return rule.value

    def schedule_preview(self, rpc_name: str, calls: int) -> list:
        """The schedule a FRESH injector with this spec would produce for
        ``calls`` consecutive ``rpc_name`` calls — determinism evidence for
        tests and for the chaos artifact's provenance record."""
        probe = FaultInjector(self.spec, side=f"{self.side}-preview",
                              _telemetry=False)
        out = []
        for _ in range(calls):
            rule = probe.decide(rpc_name)
            out.append(None if rule is None else (rule.kind, rule.value))
        return out

    # -- server side ---------------------------------------------------------

    def wrap_handler(self, rpc_name: str, fn):
        """Wrap one service RPC body. ``delay`` sleeps then runs;
        ``unavailable``/``deadline`` abort BEFORE the store is touched;
        ``drop_reply`` runs the body (the apply happens) then aborts — the
        reply is lost after the side effect, the exactly-once crucible;
        ``kill`` hard-exits mid-handler (the chaos soak's crash point)."""

        def wrapped(request: bytes, ctx) -> bytes:
            rule = self.decide(rpc_name)
            if rule is None:
                return fn(request, ctx)
            if rule.kind == "delay":
                time.sleep(rule.value)
                return fn(request, ctx)
            if rule.kind == "corrupt":
                # Ingress corruption: the handler sees a byte-flipped
                # request, exactly as if the wire damaged it — the CRC
                # refusal path (comms/service.py) is what's under test.
                return fn(corrupt_request(request,
                                          self.corrupt_salt(rule)), ctx)
            if rule.kind == "kill":
                print(f"fault injection: killing server mid-{rpc_name}",
                      flush=True)
                os._exit(137)  # SIGKILL-alike: no flush, no atexit
            if rule.kind == "drop_reply":
                fn(request, ctx)  # the apply HAPPENS; the reply does not
                self._abort(ctx, "drop_reply", rpc_name)
            # unavailable / deadline / partition: nothing executes. For
            # partition the abort doubles as "request never arrived" —
            # and the open window keeps dropping follow-ups both ways.
            self._abort(ctx, rule.kind, rpc_name)

        return wrapped

    def _abort(self, ctx, kind: str, rpc_name: str):
        code = _STATUS[kind]
        if ctx is not None:
            ctx.abort(code, f"injected {kind} ({rpc_name})")
        raise InjectedRpcError(code, f"server-side {kind} ({rpc_name})")


class _FaultyCall:
    """Client-side wrapper over one raw gRPC callable."""

    def __init__(self, inner, injector: FaultInjector, rpc_name: str):
        self._inner = inner
        self._injector = injector
        self._rpc_name = rpc_name

    def __call__(self, request, timeout=None):
        rule = self._injector.decide(self._rpc_name)
        if rule is None:
            return self._inner(request, timeout=timeout)
        if rule.kind == "delay":
            time.sleep(rule.value)
            return self._inner(request, timeout=timeout)
        if rule.kind == "corrupt":
            # Egress corruption: the wire damages this client's request
            # in flight; the server's CRC check must refuse it.
            return self._inner(
                corrupt_request(request, self._injector.corrupt_salt(rule)),
                timeout=timeout)
        if rule.kind == "kill":
            print(f"fault injection: killing client mid-{self._rpc_name}",
                  flush=True)
            os._exit(137)
        if rule.kind == "drop_reply":
            self._inner(request, timeout=timeout)  # server saw it...
            raise InjectedRpcError(_STATUS["drop_reply"],
                                   f"reply dropped ({self._rpc_name})")
        raise InjectedRpcError(_STATUS[rule.kind],
                               f"client-side {rule.kind} "
                               f"({self._rpc_name})")


def install_client_faults(remote_store, injector: FaultInjector) -> None:
    """Interpose the injector between RemoteStore and its channel. The
    wrappers sit UNDER the retry layer, so injected transients exercise
    the same backoff/reconnect paths a real flaky network would."""
    remote_store._call = {
        name: _FaultyCall(call, injector, name)
        for name, call in remote_store._call.items()
    }
