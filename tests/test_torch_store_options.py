"""The port's store options against the JAX store's: one scripted
sequence of calls drives a JAX ``ParameterStore`` and the port's, each
built from the same NumPy params, with ``time.time`` replaced by a clock
the script sets. Every return value — registrations, pushes, expiries,
``round_status()``, fetch payloads (dtype, shape and bytes), snapshots —
must be equal, bit for bit; each ``StoreConfig`` error must carry the
JAX message.

The configurations: elastic registration, expiry and slot reuse; expiry
without elastic; a quorum by count and by fraction; a deadline-completed
round and a stale deadline timer that is fenced; late pushes within and
beyond the staleness bound (fp32 and int8); ``exclude_worker`` and
``include_worker``; the bf16 and fp16 fetch codecs; and ``load_snapshot``,
``param_names``, ``export_params``, ``adopt_params`` and
``drop_params``."""

import time

import numpy as np
import pytest

from distributed_parameter_server_for_ml_training_tpu.ops.compression \
    import compress_push as jax_compress_push
from distributed_parameter_server_for_ml_training_tpu.ps.store import (
    ParameterStore as JaxStore, StoreConfig as JaxConfig)
from distributed_parameter_server_for_ml_training_tpu_torch.ps.store import (
    ParameterStore, StoreConfig)

SHAPES = {"conv/kernel": (3, 3, 3, 8), "conv/bias": (8,),
          "dense/kernel": (8, 10), "dense/bias": (10,)}

#: How long a scripted wait for a deadline-completed round may take.
DEADLINE_WAIT_S = 10.0


def _params(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(seed: int, codec: str = "none") -> dict:
    rng = np.random.default_rng(100 + seed)
    g = {k: (rng.standard_normal(s) * 1e-2).astype(np.float32)
         for k, s in SHAPES.items()}
    if codec == "int8":
        return jax_compress_push(g, {k: "int8" for k in g})
    return g


class Clock:
    """The script's wall clock, installed as ``time.time``."""

    def __init__(self):
        self.now = 1_000.0

    def __call__(self):
        return self.now


def _norm(v):
    """A comparable form of a store's return value: arrays by dtype,
    shape and bytes; containers element by element, in order."""
    if isinstance(v, np.ndarray) or np.isscalar(v) and hasattr(v, "dtype"):
        a = np.asarray(v)
        return ("array", a.dtype.str, a.shape, a.tobytes())
    if isinstance(v, dict):
        return ("dict", [(k, _norm(x)) for k, x in v.items()])
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, [_norm(x) for x in v])
    return v


def _wait_step(store, step: int) -> int:
    """Block until a deadline timer has completed the round."""
    t_end = time.monotonic() + DEADLINE_WAIT_S
    while store.global_step < step and time.monotonic() < t_end:
        time.sleep(0.005)
    return store.global_step


# Each op: (name, callable(store, clock) -> value). The clock ops return
# None; every other value is recorded and compared.

def at(t):
    def set_clock(s, clock):
        clock.now = 1_000.0 + t
    return ("at", set_clock)


def reg(name):
    return ("register", lambda s, c: s.register_worker(name))


def push(wid, seed, step=0, codec="none"):
    return (f"push {wid}", lambda s, c: s.push(wid, _grads(seed, codec),
                                               step))


def fetch(wid=None, have=None):
    return ("fetch", lambda s, c: s.fetch(wid, have_step=have))


STATUS = ("round_status", lambda s, c: s.round_status())
MEMBERS = ("members", lambda s, c: s.membership_snapshot())
EXPIRE = ("expire", lambda s, c: s.expire_stale_workers())
STEP = ("step", lambda s, c: s.global_step)
SNAP = ("snapshot", lambda s, c: s.snapshot())
FINISHED = ("finished", lambda s, c: s.wait_all_finished(0))


def finish(wid):
    return ("job_finished", lambda s, c: s.job_finished(wid))


def exclude(wid):
    return ("exclude", lambda s, c: s.exclude_worker(wid))


def include(wid):
    return ("include", lambda s, c: s.include_worker(wid))


def fire_stale(serial):
    """A deadline timer of round ``serial`` firing after that round
    completed: it must change nothing."""
    return ("stale_timer", lambda s, c: s._round_deadline_fired(serial))


def wait_round(step):
    return ("deadline_round", lambda s, c: _wait_step(s, step))


SCRIPTS = {
    # Elastic: ids take the lowest free slot, expiry purges the dead
    # workers' pending gradients and completes the round the survivors
    # cover, a replacement reuses a dead worker's slot, and a clean
    # departure shrinks the round target.
    "elastic_expiry_slot_reuse": (
        dict(mode="sync", total_workers=3, elastic=True, worker_timeout=10,
             push_codec="none"),
        [at(0), reg("a"), reg("b"), reg("c"), MEMBERS,
         push(0, 1), push(1, 2), STATUS,
         at(5), fetch(0), at(12), EXPIRE, MEMBERS, STATUS, STEP,
         reg("d"), reg("e"), MEMBERS, reg("f"), MEMBERS,
         push(1, 3, step=1), push(0, 4, step=1), STATUS,
         finish(3), STATUS, push(2, 5, step=1), STATUS, STEP,
         at(100), EXPIRE, FINISHED, SNAP]),
    # Expiry without elastic: ids stay sequential, the dead worker leaves
    # the live set but the round target stays the fixed total.
    "expiry_fixed_membership": (
        dict(mode="sync", total_workers=2, worker_timeout=5,
             push_codec="none"),
        [at(0), reg("a"), reg("b"), push(0, 1), at(3), fetch(1),
         at(7), EXPIRE, MEMBERS, STATUS, reg("c"), MEMBERS,
         push(1, 2), STATUS, STEP, SNAP]),
    # A quorum by count: 2 of 4 complete a round; the stragglers' late
    # pushes apply through the staleness path, fp32 and int8, within the
    # bound and beyond it.
    "quorum_count_late_pushes": (
        dict(mode="sync", total_workers=4, sync_quorum=2,
             staleness_bound=1, push_codec="int8"),
        [reg("a"), reg("b"), reg("c"), reg("d"),
         push(0, 1, codec="int8"), STATUS, push(1, 2, codec="int8"),
         STATUS, STEP,
         push(2, 3, step=0, codec="int8"), STEP,      # late, staleness 1
         push(0, 4, step=2, codec="int8"), push(1, 5, step=2, codec="int8"),
         STEP, push(3, 6, step=0, codec="int8"), STEP,  # beyond the bound
         push(0, 7, step=3, codec="int8"), push(0, 8, step=3,
                                                codec="int8"),
         STATUS,                       # a double push counts once
         fetch(0), SNAP]),
    # A quorum by fraction: ceil(0.6 x 4) = 3; with one worker excluded
    # the target is 3 and the quorum ceil(1.8) = 2.
    "quorum_fraction_exclusion": (
        dict(mode="sync", total_workers=4, sync_quorum=0.6,
             push_codec="none"),
        [reg("a"), reg("b"), reg("c"), reg("d"), STATUS,
         push(0, 1), push(1, 2), STATUS, push(2, 3), STATUS, STEP,
         exclude(3), STATUS, push(0, 4, step=1), STATUS,
         push(1, 5, step=1), STATUS, STEP, include(3),
         ("excluded", lambda s, c: s.excluded_workers()), STATUS, SNAP]),
    # Exclusion without a quorum: excluding the missing worker shrinks
    # the target under a pending round, which completes at once.
    "exclude_include": (
        dict(mode="sync", total_workers=3, push_codec="none"),
        [reg("a"), reg("b"), reg("c"), push(0, 1), push(1, 2), STATUS,
         exclude(2), STATUS, STEP, include(2), STATUS,
         push(0, 3, step=1), push(1, 4, step=1), push(2, 5, step=1),
         STATUS, STEP, SNAP]),
    # A deadline completes a round with what arrived; a timer of a round
    # that completed by its full target is fenced by the round serial.
    "deadline_and_stale_timer": (
        dict(mode="sync", total_workers=3, round_deadline=0.05,
             push_codec="none"),
        [reg("a"), reg("b"), reg("c"), push(0, 1), wait_round(1), STATUS,
         push(0, 2, step=1), push(1, 3, step=1), push(2, 4, step=1),
         STATUS, STEP, fire_stale(1), STEP, STATUS,
         push(1, 5, step=2), fire_stale(1), STATUS, wait_round(3), STATUS,
         SNAP]),
    # Fetch codecs: full fetches in bf16 / fp16, a not-modified delta.
    "fetch_bf16": (
        dict(mode="async", total_workers=1, fetch_codec="bf16",
             push_codec="none"),
        [reg("a"), fetch(0), push(0, 1), fetch(0, have=0), fetch(0, have=1),
         fetch(), SNAP]),
    "fetch_fp16": (
        dict(mode="async", total_workers=1, fetch_codec="fp16",
             push_codec="fp16"),
        [reg("a"), fetch(0), push(0, 1), fetch(0, have=1), fetch(0, have=0),
         SNAP]),
    # The snapshot and migration surface.
    "snapshot_migration": (
        dict(mode="async", total_workers=1, push_codec="none"),
        [reg("a"), push(0, 1),
         ("load_snapshot", lambda s, c: s.load_snapshot(_params(7), 42)),
         STEP, fetch(0), ("param_names", lambda s, c: s.param_names()),
         ("export", lambda s, c: s.export_params(
             ["dense/kernel", "conv/bias", "missing"])),
         ("drop", lambda s, c: s.drop_params(["dense/kernel", "nope"])),
         ("param_names", lambda s, c: s.param_names()),
         ("adopt", lambda s, c: s.adopt_params(
             {"dense/kernel": np.ones((8, 10)), "extra": np.zeros(3)})),
         ("param_names", lambda s, c: s.param_names()),
         push(0, 2, step=42), SNAP]),
}


def _drive(store, script, clock, norm=_norm) -> list:
    out = []
    for name, op in script:
        v = op(store, clock)
        if name != "at":
            out.append((name, norm(v)))
    return out


@pytest.mark.parametrize("case", list(SCRIPTS))
def test_scripted_store_options_match_jax(case, monkeypatch, capsys):
    kwargs, script = SCRIPTS[case]
    clock = Clock()
    monkeypatch.setattr(time, "time", clock)
    jax_store = JaxStore(_params(), JaxConfig(**kwargs))
    port_store = ParameterStore(_params(), StoreConfig(**kwargs))
    want = _drive(jax_store, script, clock)
    got = _drive(port_store, script, clock)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (case, i, g[0])
    assert port_store.metrics().keys() == jax_store.metrics().keys()


def test_scripts_reach_what_they_script(monkeypatch):
    """The sequences take the branches they are named for (read off the
    port's replies, which equal the JAX store's)."""
    def run(case):
        kwargs, script = SCRIPTS[case]
        clock = Clock()
        monkeypatch.setattr(time, "time", clock)
        out = _drive(ParameterStore(_params(), StoreConfig(**kwargs)),
                     script, clock, norm=lambda v: v)
        return lambda name: [v for n, v in out if n.startswith(name)]

    el = run("elastic_expiry_slot_reuse")
    assert sorted(el("expire")[0]) == [1, 2] and el("members")[1] == [0]
    assert el("register")[3:] == [(1, 3), (2, 3), (3, 3)]  # slots reused
    assert el("round_status")[1]["last_trigger"] == "full"
    assert el("finished") == [True]
    q = run("quorum_count_late_pushes")
    assert q("round_status")[1]["last_trigger"] == "quorum"
    assert q("round_status")[2]["received"] == 1
    pushes = q("push")
    assert pushes[2] is True and pushes[5] is False   # late: in / beyond
    d = run("deadline_and_stale_timer")
    st = d("round_status")
    assert st[0]["last_trigger"] == "deadline"
    assert st[1]["last_trigger"] == "full" and st[3]["deadline_armed"]
    assert st[4]["last_trigger"] == "deadline"
    f = run("fetch_bf16")
    assert str(f("fetch")[0][0]["dense/kernel"].dtype) == "bfloat16"
    assert f("fetch")[2] == ({}, 1)
    fr = run("quorum_fraction_exclusion")("round_status")
    assert (fr[0]["quorum"], fr[3]["quorum"]) == (3, 2)


@pytest.mark.parametrize("kwargs", [
    dict(mode="bogus"), dict(total_workers=0), dict(total_workers=33),
    dict(fetch_codec="int8"), dict(sync_quorum=0), dict(sync_quorum=-1),
    dict(sync_quorum=2.5), dict(round_deadline=0), dict(round_deadline=-3),
    dict(shard_index=2, shard_count=2), dict(shard_count=0),
    dict(shard_index=-1), dict(job_id="bad id"), dict(job_id=""),
    dict(job_id="x" * 65), dict(job_id=7)],
    ids=lambda kw: "-".join(f"{k}={v}"[:24] for k, v in kw.items()))
def test_store_config_errors_match_jax(kwargs):
    with pytest.raises(ValueError) as want:
        JaxConfig(**kwargs)
    with pytest.raises(ValueError) as got:
        StoreConfig(**kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kwargs", [
    dict(sync_quorum=2), dict(sync_quorum=0.5), dict(round_deadline=1.0),
    dict(), dict(strict_rounds=True), dict(shard_index=1, shard_count=3,
                                           job_id="vision-1")])
def test_store_config_fields_match_jax(kwargs):
    """Accepted configurations agree field for field; a quorum or a
    deadline implies strict rounds in both."""
    want, got = vars(JaxConfig(**kwargs)), vars(StoreConfig(**kwargs))
    assert got == want
    if "sync_quorum" in kwargs or "round_deadline" in kwargs:
        assert got["strict_rounds"] is True
