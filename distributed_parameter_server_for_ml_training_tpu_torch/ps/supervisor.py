"""The replica pool: the execute half of replica autoscaling.

The replica half of the JAX package's ``ps/supervisor.py``:
:func:`build_replica_argv` and :class:`ReplicaPool`, with the spawn and
argv helpers they borrow from the JAX ``WorkerSupervisor``. The pool
spawns ``cli replica`` children of the port's package; its size is the
variable :class:`~..telemetry.autoscale.ReplicaAutoscaler` controls
(``cli serve --autoscale`` wires both). The worker supervisor itself and
``cli supervise`` come with ROADMAP §1 item 9 (part 5).
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

__all__ = ["ReplicaPool", "build_replica_argv"]


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
            procs = list(self._procs.values())
            self._procs.clear()
        for p in procs:
            try:
                p.terminate()
            except OSError:
                pass
        deadline = time.time() + self.graceful_timeout
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                try:
                    p.kill()
                    p.wait(timeout=5)
                except (OSError, subprocess.TimeoutExpired):
                    pass
        self._tm_live.set(0)

    def status(self) -> dict:
        with self._lock:
            self._reap_locked()
            return {"live": len(self._procs),
                    "indices": sorted(self._procs),
                    "spawned_total": self._next_index}
