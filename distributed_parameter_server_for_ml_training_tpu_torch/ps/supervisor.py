"""Process supervisors: the worker supervisor and the replica pool.

The JAX package's ``ps/supervisor.py``, both halves.

:class:`WorkerSupervisor` is the rung of the self-healing ladder that
brings a dead worker back (docs/ROBUSTNESS.md). ``cli supervise`` runs it
next to the worker processes, the place a process can be restarted:

- it spawns N ``cli worker`` children of the port's package from one
  argv template (:func:`build_worker_argv`), each with its own
  ``--worker-name`` slot; the children train on the card, the supervisor
  itself loads no torch;
- it watches them: a child that exits 0 is done, a child that dies is
  **respawned after exponential backoff** (``backoff_initial`` doubling to
  ``backoff_max``; a child that stayed alive ``healthy_after`` seconds
  resets its slot's backoff);
- **crash-loop latch**: ``crash_loop_after`` consecutive fast deaths
  (lived < ``healthy_after``) latch the slot, visible in the status and
  the ``crash_loop`` outcome counter;
- each respawn (and latch) lands in
  ``dps_remediation_actions_total{action="respawn",outcome}``, the metric
  the server-side remediation engine uses, plus greppable
  ``SUPERVISOR_RESPAWN`` / ``SUPERVISOR_CRASH_LOOP`` log lines;
- its slot count is the actuator of
  :class:`~..telemetry.remediation.WorkerAutoscaler` (``grow``/``shrink``,
  indices never reused).

The respawned process re-registers through the ordinary lifecycle: under
``--elastic`` + ``--worker-timeout`` it takes the dead session's freed id
slot, and the push-token journal dedupes any pre-death push retry, so the
supervisor needs no protocol of its own. Chaos drills use per-slot
**first-spawn-only** fault specs/env: the injected ``push.kill`` that
proves the respawn path runs once, and the replacement runs clean.

:func:`build_replica_argv` and :class:`ReplicaPool` are the execute half
of replica autoscaling: the pool spawns ``cli replica`` children, and its
size is the variable :class:`~..telemetry.autoscale.ReplicaAutoscaler`
controls (``cli serve --autoscale`` wires both).
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass

__all__ = ["ReplicaPool", "SupervisorConfig", "WorkerSupervisor",
           "build_replica_argv", "build_worker_argv",
           "install_signal_stop"]


def _default_spawn(argv, env):
    """``subprocess.Popen(argv)`` with ``env`` merged over the process's
    own environment (or none)."""
    full_env = dict(os.environ)
    if env:
        full_env.update({k: str(v) for k, v in env.items()})
    return subprocess.Popen(argv, env=full_env)


def _normalize(built):
    """An argv builder's result as ``(argv, env|None)``: builders return
    either that pair or a bare argv."""
    if isinstance(built, tuple):
        argv, env = built
        return list(argv), env
    return list(built), None


def _terminate(procs, graceful_timeout: float) -> None:
    """SIGTERM every process, then SIGKILL those still alive after the
    grace window."""
    for p in procs:
        try:
            p.terminate()
        except OSError:
            pass
    deadline = time.time() + graceful_timeout
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            try:
                p.kill()
                p.wait(timeout=5)
            except (OSError, subprocess.TimeoutExpired):
                pass


@dataclass
class SupervisorConfig:
    """Respawn discipline knobs (documented in docs/ROBUSTNESS.md)."""

    respawn: bool = True
    backoff_initial: float = 1.0
    backoff_max: float = 30.0
    #: A child alive at least this long counts as having come up: its
    #: slot's backoff and crash-loop count reset.
    healthy_after: float = 5.0
    #: Consecutive fast deaths (lived < healthy_after) before the slot
    #: latches as crash-looping and stops respawning.
    crash_loop_after: int = 3
    poll_interval: float = 0.2
    #: SIGTERM -> SIGKILL grace when stopping children.
    graceful_timeout: float = 10.0


@dataclass
class _Slot:
    index: int
    proc: subprocess.Popen | None = None
    attempt: int = 0              # spawns so far (0 before the first)
    started_ts: float = 0.0
    backoff: float = 0.0
    fast_crashes: int = 0
    respawns: int = 0
    last_rc: int | None = None
    next_spawn_ts: float = 0.0    # backoff gate
    done: bool = False            # exited 0 (or latched/retired)
    latched: bool = False
    retired: bool = False         # removed by a worker_shrink


class WorkerSupervisor:
    """Spawn-and-babysit loop over N worker subprocess slots.

    ``argv_for(slot_index, attempt)`` returns ``(argv, env_overrides)``
    for one spawn — ``env_overrides`` (or None) is merged over
    ``os.environ``. The builder sees the attempt number, so chaos drills
    can inject faults into the first spawn only. ``clock`` and ``spawn``
    are injectable (tests drive the supervisor with fake processes on a
    fake clock).
    """

    def __init__(self, argv_for, n_workers: int,
                 config: SupervisorConfig | None = None,
                 clock=time.monotonic, spawn=None,
                 log=print):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.argv_for = argv_for
        self.config = config or SupervisorConfig()
        self.clock = clock
        self.log = log
        self._spawn_fn = spawn or _default_spawn
        self.slots = [_Slot(index=i) for i in range(n_workers)]
        # Next index for a grown slot: indices are never reused, so a
        # grown worker's ``--worker-name sup-w{slot}`` never collides
        # with a retired one's. guarded by: self._slots_lock
        self._next_slot_index = n_workers
        self._stop = threading.Event()
        # Serializes supervision passes against stop(): stop() is called
        # from signal handlers / other threads, and a child spawned by a
        # pass mid-respawn must not miss stop()'s snapshot.
        self._slots_lock = threading.Lock()
        from ..telemetry import get_registry
        self._tm_children = get_registry().gauge("dps_supervisor_children")
        # The respawn half of dps_remediation_actions_total lives here:
        # the supervisor is the process that can restart one.
        from ..telemetry.remediation import note_action
        self._note_action = note_action

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        """Initial spawn of every slot."""
        with self._slots_lock:
            for slot in self.slots:
                self._spawn(slot)
        self._tm_children.set(self.running_count())

    def _spawn(self, slot: _Slot) -> None:
        argv, env = _normalize(self.argv_for(slot.index, slot.attempt))
        slot.proc = self._spawn_fn(argv, env)
        slot.started_ts = self.clock()
        slot.attempt += 1
        self.log(f"SUPERVISOR_SPAWN slot={slot.index} "
                 f"attempt={slot.attempt} "
                 f"pid={getattr(slot.proc, 'pid', '?')}", flush=True)

    def poll_once(self) -> None:
        """One supervision pass: reap exits, schedule/execute respawns.
        The whole pass holds the slots lock (every step is non-blocking
        polls and bookkeeping) so stop() can never interleave with a
        respawn."""
        with self._slots_lock:
            self._poll_locked()
        self._tm_children.set(self.running_count())

    def _poll_locked(self) -> None:
        now = self.clock()
        cfg = self.config
        for slot in self.slots:
            if slot.done:
                continue
            if slot.proc is not None:
                rc = slot.proc.poll()
                if rc is None:
                    if slot.fast_crashes \
                            and now - slot.started_ts >= cfg.healthy_after:
                        # Came up for real: the slot earned its reset.
                        slot.fast_crashes = 0
                        slot.backoff = 0.0
                    continue
                self._reap_locked(slot, rc, now)
                continue
            # No process: a respawn is pending its backoff.
            if now >= slot.next_spawn_ts:
                slot.respawns += 1
                self._spawn(slot)
                self._note_action("respawn", "ok")
                self.log(f"SUPERVISOR_RESPAWN slot={slot.index} "
                         f"attempt={slot.attempt} "
                         f"after_rc={slot.last_rc}", flush=True)

    def _reap_locked(self, slot: _Slot, rc: int, now: float) -> None:
        """Book a child's exit: done on rc 0 or with respawn off, latched
        at ``crash_loop_after`` consecutive fast crashes, else a respawn
        scheduled after the slot's doubled backoff."""
        cfg = self.config
        lived = now - slot.started_ts
        slot.last_rc = rc
        slot.proc = None
        if rc == 0:
            slot.done = True
            self.log(f"SUPERVISOR_DONE slot={slot.index} rc=0", flush=True)
            return
        if not cfg.respawn:
            slot.done = True
            self.log(f"SUPERVISOR_EXIT slot={slot.index} rc={rc} "
                     f"(respawn disabled)", flush=True)
            return
        if lived < cfg.healthy_after:
            slot.fast_crashes += 1
            # Latch AT crash_loop_after consecutive fast crashes, not one
            # extra.
            if slot.fast_crashes >= cfg.crash_loop_after:
                slot.latched = True
                slot.done = True
                self._note_action("respawn", "crash_loop")
                self.log(f"SUPERVISOR_CRASH_LOOP slot={slot.index} "
                         f"rc={rc} fast_crashes={slot.fast_crashes}"
                         f" (latched, no further respawns)", flush=True)
                return
        else:
            slot.fast_crashes = 0
            slot.backoff = 0.0
        slot.backoff = (cfg.backoff_initial if slot.backoff <= 0
                        else min(slot.backoff * 2.0, cfg.backoff_max))
        slot.next_spawn_ts = now + slot.backoff
        self.log(f"SUPERVISOR_CHILD_DIED slot={slot.index} rc={rc} "
                 f"lived={lived:.1f}s respawn_in={slot.backoff:.1f}s",
                 flush=True)

    # -- elastic slots (worker autoscaling) -----------------------------------

    def add_slot(self) -> int:
        """Grow by one slot: append a fresh slot and spawn it NOW, under
        the slots lock, so the new child can never miss stop()'s
        snapshot. Returns the new slot index (never a reused one)."""
        with self._slots_lock:
            # stop() sets the flag before it takes this lock: a grow that
            # loses the race spawns nothing instead of an orphan.
            if self._stop.is_set():
                raise RuntimeError("supervisor is stopped")
            slot = _Slot(index=self._next_slot_index)
            self._next_slot_index += 1
            self.slots.append(slot)
            self._spawn(slot)
        self._tm_children.set(self.running_count())
        self.log(f"SUPERVISOR_GROW slot={slot.index}", flush=True)
        return slot.index

    def remove_slot(self) -> int | None:
        """Shrink by one: retire the YOUNGEST live slot (highest index
        not yet done: the worker the job has depended on for the
        shortest time). The slot stays in the list marked done (its
        history keeps rendering in status); the child gets SIGTERM then
        SIGKILL after the grace window. Returns the retired index, or
        None when no slot is removable."""
        with self._slots_lock:
            live = [s for s in self.slots if not s.done]
            if not live:
                return None
            slot = max(live, key=lambda s: s.index)
            slot.done = True
            slot.retired = True
            proc, slot.proc = slot.proc, None
        if proc is not None and proc.poll() is None:
            _terminate([proc], self.config.graceful_timeout)
        self._tm_children.set(self.running_count())
        self.log(f"SUPERVISOR_SHRINK slot={slot.index}", flush=True)
        return slot.index

    # WorkerAutoscaler actuator surface (telemetry/remediation.py): the
    # verbs ReplicaPool exposes to the replica autoscaler.
    def grow(self) -> int:
        return self.add_slot()

    def shrink(self) -> int | None:
        return self.remove_slot()

    def count(self) -> int:
        return self.running_count()

    def run(self) -> int:
        """Supervise until every slot is done. Exit code: 0 when all
        slots finished cleanly, 1 when any latched as crash-looping or
        ended on a nonzero rc with respawn disabled."""
        try:
            while not self._stop.is_set():
                self.poll_once()
                if all(s.done for s in self.slots):
                    break
                self._stop.wait(self.config.poll_interval)
        finally:
            self.stop()
        # Retired slots are a deliberate shrink, not a failure (their
        # last_rc may be stale from a pre-retirement respawn).
        bad = [s for s in self.slots
               if s.latched or (s.done and not s.retired
                                and s.last_rc not in (0, None))]
        latched = [s.index for s in self.slots if s.latched]
        if latched:
            self.log(f"SUPERVISOR_EXIT latched_slots={latched}",
                     flush=True)
        return 1 if bad else 0

    def stop(self) -> None:
        """Terminate every running child (SIGTERM, then SIGKILL after the
        grace window)."""
        self._stop.set()
        # Taken AFTER setting the stop flag: an in-flight pass finishes
        # (possibly spawning), then the snapshot sees its child too.
        with self._slots_lock:
            procs = [s.proc for s in self.slots if s.proc is not None]
        _terminate(procs, self.config.graceful_timeout)
        self._tm_children.set(0)

    # -- read side ------------------------------------------------------------

    def running_count(self) -> int:
        return sum(1 for s in self.slots
                   if s.proc is not None and s.proc.poll() is None)

    def status(self) -> dict:
        return {
            "slots": [{
                "slot": s.index,
                "running": s.proc is not None and s.proc.poll() is None,
                "pid": getattr(s.proc, "pid", None) if s.proc else None,
                "attempt": s.attempt,
                "respawns": s.respawns,
                "fast_crashes": s.fast_crashes,
                "last_rc": s.last_rc,
                "latched": s.latched,
                "done": s.done,
                "retired": s.retired,
            } for s in self.slots],
            "running": self.running_count(),
        }


def install_signal_stop(supervisor: WorkerSupervisor) -> None:
    """SIGTERM/SIGINT -> stop children then exit (cli supervise).
    Installed only on the main thread; no-op elsewhere."""
    if threading.current_thread() is not threading.main_thread():
        return

    def _handler(signum, frame):  # noqa: ARG001
        supervisor.stop()
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, _handler)
    signal.signal(signal.SIGINT, _handler)


def build_worker_argv(base_args: list[str], slot: int,
                      first_spawn_faults: dict[int, str] | None = None,
                      first_spawn_env: dict[int, dict] | None = None,
                      attempt: int = 0,
                      python: str | None = None) -> tuple[list, dict | None]:
    """cli supervise's argv builder: one ``cli worker`` command line of
    the port's package per (slot, attempt). ``base_args`` is everything
    the operator wrote after ``--``, passed to every child verbatim; the
    slot's ``--worker-name`` is appended unless already present.
    First-spawn-only fault specs and env vars implement the chaos drills
    (the respawned replacement runs clean)."""
    pkg = __name__.rsplit(".", 2)[0]
    argv = [python or sys.executable, "-m", f"{pkg}.cli", "worker"]
    argv += list(base_args)
    if "--worker-name" not in base_args:
        argv += ["--worker-name", f"sup-w{slot}"]
    env = None
    if attempt == 0:
        spec = (first_spawn_faults or {}).get(slot)
        if spec:
            argv += ["--faults", spec]
        env = (first_spawn_env or {}).get(slot)
    return argv, env


def build_replica_argv(primary: str, base_args: list[str] | None = None,
                       index: int = 0,
                       python: str | None = None,
                       parent: str | None = None) -> tuple[list, None]:
    """One ``cli replica`` command line for a pool slot — the autoscaler's
    spawn template (telemetry/autoscale.py). ``base_args`` pass through
    verbatim (``--shard-id``, ``--poll-interval``, ...); the bound port is
    always ephemeral — a grown replica announces itself to the primary,
    clients learn it from the published shard map, so no port coordination
    is needed. ``parent`` points the new replica's SUBSCRIPTION at an
    interior node of the fan-out tree (tree-aware grow placement);
    ``--primary`` stays the authority writes redirect to either way."""
    pkg = __name__.rsplit(".", 2)[0]
    argv = [python or sys.executable, "-m", f"{pkg}.cli", "replica",
            "--primary", primary, "--port", "0"]
    if parent:
        argv += ["--parent", str(parent)]
    argv += list(base_args or [])
    return argv, None


class ReplicaPool:
    """Dynamic pool of replica subprocesses: the EXECUTE half of replica
    autoscaling (docs/SHARDING.md "Serve tier"). Its size is the
    controlled variable — :class:`~..telemetry.autoscale.
    ReplicaAutoscaler` calls :meth:`grow`/:meth:`shrink` and reads
    :meth:`count`. No respawn discipline: a replica that dies simply
    lowers the live count, and the autoscaler's next tick re-grows if the
    load still warrants it — the pool stays a pure actuator."""

    def __init__(self, argv_for, spawn=None, log=print,
                 graceful_timeout: float = 10.0):
        #: ``argv_for(index) -> (argv, env|None)`` builds one spawn;
        #: ``spawn(argv, env)`` is injectable so tests run the pool with
        #: fake processes.
        self.argv_for = argv_for
        self._spawn_fn = spawn or _default_spawn
        self.log = log
        self.graceful_timeout = float(graceful_timeout)
        self._lock = threading.Lock()
        self._procs: dict[int, subprocess.Popen] = {}  # guarded by: self._lock
        self._next_index = 0  # guarded by: self._lock
        self._stopped = False  # guarded by: self._lock
        from ..telemetry import get_registry
        self._tm_live = get_registry().gauge("dps_replicas_live")

    def _reap_locked(self) -> None:
        for idx in [i for i, p in self._procs.items()
                    if p.poll() is not None]:
            self.log(f"REPLICA_POOL_EXIT index={idx} "
                     f"rc={self._procs[idx].poll()}", flush=True)
            del self._procs[idx]

    def count(self) -> int:
        with self._lock:
            self._reap_locked()
            n = len(self._procs)
        self._tm_live.set(n)
        return n

    def grow(self, parent: str | None = None) -> int:
        """Spawn one replica; returns its pool index. ``parent`` routes
        tree-aware placement through to the argv builder (a two-arg
        ``argv_for``); the plain call keeps 1-arg builders working."""
        with self._lock:
            # An autoscaler tick that lands after stop() must not leave
            # an orphan replica behind the exiting primary.
            if self._stopped:
                raise RuntimeError("replica pool is stopped")
            idx = self._next_index
            self._next_index += 1
            built = self.argv_for(idx) if parent is None \
                else self.argv_for(idx, parent)
            argv, env = _normalize(built)
            self._procs[idx] = self._spawn_fn(argv, env)
            n = len(self._procs)
        self.log(f"REPLICA_POOL_GROW index={idx} live={n}"
                 + (f" parent={parent}" if parent else ""), flush=True)
        self._tm_live.set(n)
        return idx

    def shrink(self) -> int | None:
        """Terminate the YOUNGEST replica (the one clients have depended
        on for the shortest time); returns its index, or None when the
        pool is empty."""
        with self._lock:
            self._reap_locked()
            if not self._procs:
                return None
            idx = max(self._procs)
            proc = self._procs.pop(idx)
            n = len(self._procs)
        try:
            proc.terminate()
        except OSError:
            pass
        self.log(f"REPLICA_POOL_SHRINK index={idx} live={n}", flush=True)
        self._tm_live.set(n)
        return idx

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            procs = list(self._procs.values())
            self._procs.clear()
        _terminate(procs, self.graceful_timeout)
        self._tm_live.set(0)

    def status(self) -> dict:
        with self._lock:
            self._reap_locked()
            return {"live": len(self._procs),
                    "indices": sorted(self._procs),
                    "spawned_total": self._next_index}
