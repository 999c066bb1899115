"""Checkpoint managers of the port: ``torch.save`` for train states, npz
for the parameter store.

The store snapshots are the JAX package's ``checkpoint/manager.py``,
carried over line for line and format-identical: the params npz, the v4
metadata JSON (global step, aggregation block, push-token journal,
``shard`` and ``job`` identity, ``npz_crc32``/``npz_size`` stamps), the
journal captured before the params and the json published before the
npz. Each package restores the other's records.

Train states are saved with ``torch.save`` in place of Orbax, one file a
step (``ckpt_<step>.pt``, written under a temporary name and published
with ``os.replace``); Orbax's directory layout is not reproduced, so the
two packages' train-state checkpoints are not interchangeable.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import zlib

import numpy as np
import torch

from ..telemetry.journal import journal_event

_CKPT_RE = re.compile(r"^ckpt_(\d{8,})\.pt$")


def _host(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _copy_into(targets: dict, saved: dict, what: str,
               rows=None) -> None:
    """Copy saved tensors into the caller's tensors, in place: a CUDA
    graph that replays over them keeps reading the same memory.
    ``rows(name, saved_tensor)``, where given, picks the part of each
    saved tensor that the caller holds."""
    if set(targets) != set(saved):
        missing = sorted(set(targets) ^ set(saved))
        raise ValueError(f"checkpoint {what} names differ from the "
                         f"state's: {missing[:5]}")
    for k, t in targets.items():
        t.copy_(saved[k] if rows is None else rows(k, saved[k]))


class CheckpointManager:
    """``torch.save`` checkpointing of a
    :class:`~..train.train_state.TrainState`: params, optimizer state
    (momentum and update count), batch statistics and step, plus an
    optional ``extra`` dict of tensors and numbers (a trainer's generator
    state). Keeps the newest
    ``max_to_keep`` checkpoints. :meth:`restore` copies the saved tensors
    INTO the template's tensors and returns the template: a trainer whose
    step is a captured CUDA graph over those tensors keeps training the
    restored state."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{int(step):08d}.pt")

    def steps(self) -> list[int]:
        """Steps of the checkpoints on disk, oldest first."""
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _CKPT_RE.match(f)))

    def save(self, state, step: int | None = None, wait: bool = True,
             extra: dict | None = None) -> int:
        """Save ``state`` at ``step`` (its own step by default); returns
        the step. ``torch.save`` writes synchronously, so ``wait`` (the
        JAX surface's) has nothing to wait for."""
        step = int(state.step) if step is None else int(step)
        opt = state.opt_state
        payload = {
            "params": _host(state.params),
            "opt_state": None if opt is None else {
                "trace": _host(opt.trace),
                "count": opt.count.detach().to("cpu", copy=True)},
            "batch_stats": _host(state.batch_stats),
            "step": step,
            "extra": dict(extra or {}),
        }
        tmp = os.path.join(self.directory, f".tmp-{os.getpid()}-"
                                           f"{threading.get_ident()}.pt")
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        if self.max_to_keep:
            for old in self.steps()[:-self.max_to_keep]:
                os.remove(self._path(old))
        return step

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def _load(self, step: int | None) -> dict:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    @torch.no_grad()
    def restore(self, template_state, step: int | None = None, rows=None):
        """Restore the newest (or given) checkpoint into
        ``template_state``'s tensors, in place; returns the template with
        its step set. ``rows(name, tensor)`` (a rank of a model split over
        ranks) cuts each saved param and momentum to the rank's part."""
        saved = self._load(step)
        _copy_into(template_state.params, saved["params"], "params", rows)
        _copy_into(template_state.batch_stats, saved["batch_stats"],
                   "batch_stats")
        opt, sopt = template_state.opt_state, saved["opt_state"]
        if (opt is None) != (sopt is None):
            raise ValueError("checkpoint optimizer state does not match "
                             "the state's optimizer")
        if opt is not None:
            _copy_into(opt.trace, sopt["trace"], "momentum", rows)
            opt.count.copy_(sopt["count"])
        template_state.step = int(saved["step"])
        return template_state

    def restore_extra(self, step: int | None = None) -> dict:
        """The ``extra`` dict saved with the newest (or given) step."""
        return self._load(step)["extra"]

    def close(self) -> None:
        """Nothing is held open between calls (the JAX surface's close)."""


# -- async store snapshots ----------------------------------------------------

#: Store-snapshot record format. v1 was (npz, {global_step,...} json); v2
#: adds the aggregation-config block and the push-token journal that make a
#: server restart transparent to retrying clients (docs/ROBUSTNESS.md); v3
#: adds the npz CRC-32 integrity stamp (torn/corrupt snapshots detected at
#: restore, falling back to the previous valid record) and the in-flight
#: migration ledger block (docs/ROBUSTNESS.md "Migration failure matrix");
#: v4 adds the ``job`` identity (docs/TENANCY.md) so a restore into the
#: wrong job's namespace is refused like a cross-shard restore — pre-v4
#: records count as the ``default`` job. Restore accepts all four.
STORE_SNAPSHOT_VERSION = 4


def save_store(store, directory: str,
               journal_fn=None, migration_fn=None) -> str:
    """Atomic, versioned snapshot of a parameter store: params npz +
    metadata JSON (format v2: global step, aggregation-mode config, and —
    via ``journal_fn``, typically ``ParameterService.journal_snapshot`` —
    the bounded journal of recent push-token outcomes, so a restarted
    server still dedupes pre-crash push retries).

    Works for every store backend through the uniform ``snapshot()`` surface:
    host-numpy ParameterStore (copy under param_lock) and the
    device-resident DeviceParameterStore (its tensors, never written in
    place, copied to the host outside the lock). Enables the <30 s
    recovery the reference targeted but never built
    (baseline_summary.json distributed_system_targets; SURVEY.md §4).
    """
    os.makedirs(directory, exist_ok=True)
    # Journal BEFORE params: steps are monotonic, so every journaled
    # outcome's apply is at a step <= the snapshot step and therefore
    # INCLUDED in the saved params — a restored server can never answer
    # "duplicate, accepted" for a gradient its restored params lack (the
    # silent-loss failure). The reverse ordering would allow exactly
    # that. The residual window (a push applying between the two
    # captures is in params but not the journal, so its retry re-applies
    # after a crash) is microseconds wide and errs toward an extra
    # down-weighted gradient rather than a lost-but-claimed one.
    journal = list(journal_fn()) if journal_fn is not None else []
    arrays, step = store.snapshot()
    cfg = store.config
    meta = {
        "format_version": STORE_SNAPSHOT_VERSION,
        "global_step": step,
        "mode": cfg.mode,
        "total_workers": cfg.total_workers,
        "learning_rate": cfg.learning_rate,
        "staleness_bound": cfg.staleness_bound,
        "aggregation": {
            "mode": cfg.mode,
            "learning_rate": cfg.learning_rate,
            "staleness_bound": cfg.staleness_bound,
            "total_workers": cfg.total_workers,
            "strict_rounds": bool(getattr(cfg, "strict_rounds", False)),
            "elastic": bool(getattr(cfg, "elastic", False)),
            "push_codec": getattr(store, "push_codec", None),
            "fetch_codec": getattr(store, "fetch_codec", "none"),
        },
        "push_journal": journal,
        # Shard identity (docs/SHARDING.md): each shard primary runs its
        # own checkpointer over its own key subset, so a snapshot is only
        # valid for the SAME slot of the SAME partition — restore refuses
        # anything else. Absent in pre-sharding records (== 0-of-1).
        "shard": {
            "shard_index": int(getattr(cfg, "shard_index", 0)),
            "shard_count": int(getattr(cfg, "shard_count", 1)),
        },
        # Job identity (v4, docs/TENANCY.md): each job's checkpointer
        # writes its own lineage directory, and a snapshot is only valid
        # for the SAME job — restore refuses cross-job exactly like the
        # shard block above refuses cross-shard. Absent pre-v4
        # (== "default").
        "job": str(getattr(cfg, "job_id", "default")),
        "saved_at": time.time(),
    }
    # In-flight migration ledger (docs/ROBUSTNESS.md "Migration failure
    # matrix"): a primary that crashes mid-reshard restores its ledger
    # record with the params, so `cli reshard --resume` can read the
    # crash point and the donor's lease keeps its original deadline.
    if migration_fn is not None:
        mig = migration_fn()
        if mig is not None:
            meta["migration"] = mig
    # Unique temp names per call: concurrent snapshots (periodic thread +
    # final snapshot) must never interleave writes into one file. Publish
    # order is json THEN npz: restore discovers records by .npz, so a
    # crash between the two renames leaves either a harmless orphan json
    # or nothing — never a visible npz without its metadata.
    suffix = f"{os.getpid()}-{threading.get_ident()}"
    tmp_npz = os.path.join(directory, f".tmp-{suffix}.npz")
    tmp_json = os.path.join(directory, f".tmp-{suffix}.json")
    np.savez(tmp_npz, **arrays)
    # CRC the STAGED npz bytes (v3): restore re-hashes the published
    # file against this stamp, so a torn write, a crash mid-rename, or
    # later on-disk damage is detected and restore falls back to the
    # previous valid snapshot instead of silently loading garbage.
    crc, size = 0, 0
    with open(tmp_npz, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    meta["npz_crc32"] = crc
    meta["npz_size"] = size
    with open(tmp_json, "w") as f:
        json.dump(meta, f)
    final = os.path.join(directory, f"store_{step:08d}.npz")
    os.replace(tmp_json, os.path.join(directory, f"store_{step:08d}.json"))
    os.replace(tmp_npz, final)
    journal_event("checkpoint", step=int(step), path=final,
                  bytes=size)
    return final


def _read_record(directory: str, name: str
                 ) -> tuple[dict[str, np.ndarray], dict]:
    """Read and fully validate ONE snapshot record (npz + json). Raises
    on any damage: unreadable metadata, an ``npz_crc32`` mismatch (v3
    stamp), or an npz numpy cannot decode (the only integrity signal a
    pre-v3 record offers). Arrays are materialized here — np.load is
    lazy, and a torn zip often only fails when a member is read."""
    npz_path = os.path.join(directory, name)
    with open(os.path.join(directory,
                           name.replace(".npz", ".json"))) as f:
        meta = json.load(f)
    want = meta.get("npz_crc32")
    if want is not None:
        crc = 0
        with open(npz_path, "rb") as f:
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                crc = zlib.crc32(chunk, crc)
        if crc != int(want):
            raise ValueError(
                f"npz checksum mismatch (torn or corrupt write): "
                f"crc {crc:#010x} != recorded {int(want):#010x}")
    data = np.load(npz_path)
    params = {k: np.array(data[k], np.float32) for k in data.files}
    return params, meta


def load_store_record(directory: str, step: int | None = None
                      ) -> tuple[dict[str, np.ndarray], dict]:
    """Read the newest (or given-step) snapshot -> (params, meta dict).
    v1 records (no ``format_version``) load with an empty journal and no
    aggregation block.

    Newest-pick mode walks newest -> oldest past torn or corrupt
    records (CRC-verified for v3, decode-verified for older), logging
    one ``CHECKPOINT_FALLBACK`` line per skip — a crash mid-snapshot
    must cost one checkpoint interval of progress, not the restore. An
    EXPLICIT ``step`` is load-bearing: damage there is an error, never
    a silent substitution of some other step."""
    snaps = sorted(f for f in os.listdir(directory)
                   if f.startswith("store_") and f.endswith(".npz"))
    if not snaps:
        raise FileNotFoundError(f"no store snapshots in {directory}")
    if step is not None:
        name = f"store_{step:08d}.npz"
        if name not in snaps:
            raise FileNotFoundError(name)
        return _read_record(directory, name)
    errors = []
    for name in reversed(snaps):
        try:
            return _read_record(directory, name)
        except Exception as e:  # noqa: BLE001 — any damage means fall back
            errors.append(f"{name}: {e}")
            print(f"CHECKPOINT_FALLBACK {name} unreadable ({e}); "
                  f"trying previous snapshot", flush=True)
    raise FileNotFoundError(
        f"no valid store snapshot in {directory}: " + "; ".join(errors))


def restore_store(store, directory: str,
                  step: int | None = None) -> int:
    """Load the newest (or given-step) snapshot into the store. Returns the
    restored global step (also published as the ``dps_store_restore_step``
    gauge, so telemetry streams show where a restarted server resumed)."""
    params, meta = load_store_record(directory, step)
    check_shard_identity(store, meta)
    check_job_identity(store, meta)
    store.load_snapshot(params, int(meta["global_step"]))
    from ..telemetry import get_registry
    get_registry().gauge(
        "dps_store_restore_step",
        backend=getattr(store, "store_backend", "python"),
    ).set(store.global_step)
    return store.global_step


def check_shard_identity(store, meta: dict) -> None:
    """Refuse restoring a snapshot into the wrong shard slot or into a
    differently-partitioned topology (docs/SHARDING.md): each shard's
    checkpoint holds only its own key subset, so a mismatched restore
    would silently serve another shard's tensors — or a partial model as
    the whole one. Pre-sharding records carry no block and count as
    shard 0 of 1."""
    rec = meta.get("shard") or {}
    rec_idx = int(rec.get("shard_index", 0))
    rec_cnt = int(rec.get("shard_count", 1))
    cfg = store.config
    cur_idx = int(getattr(cfg, "shard_index", 0))
    cur_cnt = int(getattr(cfg, "shard_count", 1))
    if (rec_idx, rec_cnt) != (cur_idx, cur_cnt):
        raise ValueError(
            f"snapshot belongs to shard {rec_idx}/{rec_cnt} but this "
            f"server is shard {cur_idx}/{cur_cnt} — refusing a "
            f"cross-shard restore")


def check_job_identity(store, meta: dict) -> None:
    """Refuse restoring a snapshot into a different job's namespace
    (docs/TENANCY.md): each job owns its own parameters, step, and push
    journal, so a cross-job restore would silently replace one tenant's
    model with another's — the tenancy analogue of the cross-shard
    refusal above. Pre-v4 records carry no ``job`` and count as the
    ``default`` job."""
    rec_job = str(meta.get("job") or "default")
    cur_job = str(getattr(store.config, "job_id", "default"))
    if rec_job != cur_job:
        raise ValueError(
            f"snapshot belongs to job {rec_job!r} but this store is job "
            f"{cur_job!r} — refusing a cross-job restore")


def restore_server_state(store, service, directory: str,
                         step: int | None = None,
                         record: tuple | None = None) -> tuple[int, int]:
    """Full server-side restore: params + step into the store, push-token
    journal into the service's dedupe table. Returns (restored_step,
    journal_entries_loaded). The one-call recovery path ``cli serve
    --restore`` uses. ``record`` accepts an already-loaded
    ``(params, meta)`` pair so a caller that inspected the snapshot first
    (config adoption) restores the SAME record it read — re-listing the
    directory could pick up a newer snapshot published in between."""
    params, meta = record if record is not None \
        else load_store_record(directory, step)
    check_shard_identity(store, meta)
    check_job_identity(store, meta)
    store.load_snapshot(params, int(meta["global_step"]))
    from ..telemetry import get_registry
    get_registry().gauge(
        "dps_store_restore_step",
        backend=getattr(store, "store_backend", "python"),
    ).set(store.global_step)
    loaded = 0
    if service is not None:
        loaded = service.load_journal(meta.get("push_journal", []))
        # Re-install any in-flight migration ledger record (v3): a
        # donor that died mid-export comes back FROZEN under its
        # original lease deadline, so the coordinator's --resume (or
        # lease expiry) decides the outcome, not the crash.
        mig_load = getattr(service, "load_migration", None)
        if mig_load is not None:
            mig_load(meta.get("migration"))
    return store.global_step, loaded


class PeriodicStoreCheckpointer(threading.Thread):
    """Background thread snapshotting the store every ``interval`` seconds.

    A failed periodic snapshot (disk full, permissions) is logged and
    retried at the next tick rather than silently killing the thread — one
    transient failure must not permanently disable the <30 s recovery path.
    The most recent failure (cleared by any later success) is kept in
    ``last_error`` and returned by ``stop()``.
    """

    def __init__(self, store, directory: str,
                 interval: float = 30.0, journal_fn=None,
                 migration_fn=None):
        super().__init__(daemon=True)
        self.store = store
        self.directory = directory
        self.interval = interval
        #: Optional push-token journal source (typically
        #: ``ParameterService.journal_snapshot``), persisted into every
        #: snapshot so a restart keeps deduping pre-crash push retries.
        self.journal_fn = journal_fn
        #: Optional migration-ledger source (typically
        #: ``ParameterService.migration_snapshot``) — persisted so a
        #: primary that crashes mid-reshard restores its crash point.
        self.migration_fn = migration_fn
        self.last_error: Exception | None = None
        # NB: must not be named _stop — that would shadow
        # threading.Thread._stop(), which join() calls internally.
        self._stop_event = threading.Event()

    def run(self):
        while not self._stop_event.wait(self.interval):
            try:
                save_store(self.store, self.directory,
                           journal_fn=self.journal_fn,
                           migration_fn=self.migration_fn)
                self.last_error = None
            except Exception as e:  # noqa: BLE001 — keep snapshotting
                self.last_error = e
                print(f"periodic store snapshot failed (will retry in "
                      f"{self.interval:.0f}s): {e!r}")

    def flush_now(self) -> None:
        """One immediate snapshot, independent of the tick — registered as
        a telemetry shutdown flush (``add_shutdown_flush``) so SIGTERM
        drains the store's end state through the same path that dumps the
        flight recorder. Exceptions propagate to the shutdown runner,
        which swallows them (a failed final snapshot must not mask the
        shutdown itself); the periodic ``last_error`` is left for the
        next tick's bookkeeping."""
        save_store(self.store, self.directory, journal_fn=self.journal_fn,
                   migration_fn=self.migration_fn)

    def stop(self, final_snapshot: bool = True) -> Exception | None:
        """Stop the thread; returns the last unrecovered periodic failure
        (None if the latest snapshot attempt succeeded)."""
        self._stop_event.set()
        if self.is_alive():
            self.join()  # let an in-flight periodic snapshot finish first
        if final_snapshot:
            # The final snapshot still raises on failure: unlike a periodic
            # tick there is no later retry, and the caller must know the
            # run's end state was not persisted.
            save_store(self.store, self.directory,
                       journal_fn=self.journal_fn,
                       migration_fn=self.migration_fn)
            self.last_error = None
        return self.last_error
