"""The port's worker supervisor (``…_torch/ps/supervisor.py``'s
``WorkerSupervisor``, ``build_worker_argv``) and ``cli supervise``
against the JAX package's.

- Each package's supervisor, driven by the same script of child exits
  through a fake spawn on a fake clock, gives the same log lines (pid
  aside), the same ``status()``, the same respawn counters and the same
  exit code: backoff doubling to its maximum, the crash-loop latch, the
  healthy-uptime reset, ``--no-respawn``, grow and shrink with fresh
  indices, and ``stop()`` during a pending respawn.
- ``build_worker_argv`` is JAX's but for the module it runs;
  ``supervise`` takes JAX's flags and defaults (``--device`` for
  ``--platform``); ``--device cpu`` reaches the children, and no flag
  leaves them on the card.
- ``--autoscale-job`` against a stub ``/cluster`` in JAX's view shape:
  the port's ``WorkerAutoscaler`` grows and shrinks the supervisor in the
  JAX verb's sequence, and a view without jobs (a primary without
  tenancy) reads as an empty job row in both.
- ``slow``: JAX's real-kill respawn and crash-loop tests, over the port's
  supervisor with real child processes.
"""

import argparse
import http.server
import json
import os
import re
import sys
import threading
import time

import pytest

from distributed_parameter_server_for_ml_training_tpu import cli as JCLI
from distributed_parameter_server_for_ml_training_tpu.ps import \
    supervisor as JSUP
from distributed_parameter_server_for_ml_training_tpu.telemetry import \
    get_registry as jax_registry
from distributed_parameter_server_for_ml_training_tpu_torch import cli
from distributed_parameter_server_for_ml_training_tpu_torch.ps import \
    supervisor as SUP
from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
    import get_registry

PKGS = {"jax": (JSUP, jax_registry, JCLI), "port": (SUP, get_registry, cli)}


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self) -> float:
        return self.t


class FakeProc:
    """A child that lives ``life`` seconds of the fake clock, then exits
    ``rc``; ``life=None`` lives until terminated."""

    _next_pid = 1000

    def __init__(self, clock, life, rc):
        FakeProc._next_pid += 1
        self.pid = FakeProc._next_pid
        self.clock, self.born = clock, clock()
        self.life, self.rc = life, rc
        self.killed = None

    def poll(self):
        if self.killed is not None:
            return self.killed
        if self.life is not None and self.clock() - self.born >= self.life:
            return self.rc
        return None

    def terminate(self):
        if self.poll() is None:
            self.killed = -15

    def kill(self):
        if self.poll() is None:
            self.killed = -9

    def wait(self, timeout=None):
        return self.poll()


def _drive(pkg: str, script: dict, n: int, cfg: dict, actions=(),
           ticks: int = 80, dt: float = 0.25) -> dict:
    """One supervisor of ``pkg`` over ``n`` slots; ``script[(slot,
    attempt)] = (life, rc)`` for each spawn (default: lives 1 s, exits
    0). ``actions[tick]`` is a method name called before that tick's
    pass. Returns its log lines (pid aside), status, exit code and
    counter deltas."""
    mod, registry, _ = PKGS[pkg]
    clock = FakeClock()
    logs = []
    spawned = []

    def argv_for(slot, attempt):
        return [f"child-{slot}-{attempt}"], None

    def spawn(argv, env):
        _, slot, attempt = argv[0].split("-")
        life, rc = script.get((int(slot), int(attempt)), (1.0, 0))
        proc = FakeProc(clock, life, rc)
        spawned.append((argv[0], proc))
        return proc

    def log(msg, **kw):
        logs.append(re.sub(r"pid=\d+", "pid=?", msg))

    reg = registry()
    counters = [("respawn", "ok"), ("respawn", "crash_loop")]
    before = [reg.counter("dps_remediation_actions_total", action=a,
                          outcome=o).value for a, o in counters]
    sup = mod.WorkerSupervisor(argv_for, n, mod.SupervisorConfig(**cfg),
                               clock=clock, spawn=spawn, log=log)
    sup.start()
    actions = dict(actions)
    for tick in range(ticks):
        if tick in actions:
            ret = getattr(sup, actions[tick])()
            logs.append(f"ACTION {actions[tick]} -> {ret}")
        clock.t += dt
        sup.poll_once()
        if all(s.done for s in sup.slots):
            break
    status = sup.status()
    for row in status["slots"]:
        row["pid"] = row["pid"] is not None
    rc = sup.run() if all(s.done for s in sup.slots) else None
    if rc is None:
        sup.stop()
        logs.append("STOPPED")
    after = [reg.counter("dps_remediation_actions_total", action=a,
                         outcome=o).value for a, o in counters]
    return {"logs": logs, "status": status, "rc": rc,
            "after_stop": [p.poll() for _, p in spawned],
            "spawned": [a for a, _ in spawned],
            "counters": [a - b for a, b in zip(after, before)],
            "children_gauge": reg.gauge("dps_supervisor_children").value}


FAST = dict(backoff_initial=1.0, backoff_max=4.0, healthy_after=5.0,
            poll_interval=0.0, graceful_timeout=0.01)

#: name -> (script, slots, config, actions, ticks)
CASES = {
    "backoff_doubles_to_max": (
        {(0, a): (0.5, 3) for a in range(6)}, 1,
        dict(FAST, crash_loop_after=10), {}, 120),
    "crash_loop_latch": (
        {(0, a): (0.25, 7) for a in range(5)}, 2,
        dict(FAST, crash_loop_after=3), {}, 80),
    "healthy_uptime_resets": (
        {(0, 0): (0.25, 1), (0, 1): (6.0, 1), (0, 2): (0.25, 1),
         (0, 3): (6.0, 1), (0, 4): (0.25, 1), (0, 5): (1.0, 0)}, 1,
        dict(FAST, crash_loop_after=2), {}, 200),
    "no_respawn": (
        {(0, 0): (0.5, 3)}, 2, dict(FAST, respawn=False), {}, 40),
    "grow_and_shrink_fresh_indices": (
        {(s, 0): (None, 0) for s in range(6)}, 2, dict(FAST),
        {1: "grow", 2: "grow", 3: "shrink", 4: "grow", 5: "shrink",
         6: "shrink", 7: "shrink", 8: "shrink"}, 20),
    "stop_during_pending_respawn": (
        {(0, 0): (0.5, 9), (1, 0): (None, 0)},
        2, dict(FAST, backoff_initial=30.0), {}, 10),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_supervisor_script_equal_to_jax(name):
    script, n, cfg, actions, ticks = CASES[name]
    got = _drive("port", script, n, cfg, actions, ticks)
    want = _drive("jax", script, n, cfg, actions, ticks)
    assert got == want
    logs = got["logs"]
    if name == "backoff_doubles_to_max":
        delays = re.findall(r"respawn_in=([\d.]+)s", "\n".join(logs))
        assert delays[:4] == ["1.0", "2.0", "4.0", "4.0"]
        assert got["rc"] == 0
    elif name == "crash_loop_latch":
        assert got["rc"] == 1 and got["status"]["slots"][0]["latched"]
        assert got["status"]["slots"][0]["attempt"] == 3
        assert got["counters"] == [2, 1]
    elif name == "healthy_uptime_resets":
        assert got["rc"] == 0 and not got["status"]["slots"][0]["latched"]
    elif name == "no_respawn":
        assert got["rc"] == 1
        assert any("respawn disabled" in ln for ln in logs)
    elif name == "grow_and_shrink_fresh_indices":
        grown = [ln for ln in logs if ln.startswith("SUPERVISOR_GROW")]
        assert grown == ["SUPERVISOR_GROW slot=2", "SUPERVISOR_GROW slot=3",
                         "SUPERVISOR_GROW slot=4"]
        shrunk = [ln.split("=")[1] for ln in logs
                  if ln.startswith("SUPERVISOR_SHRINK")]
        assert shrunk == ["3", "4", "2", "1", "0"] and got["rc"] == 0
    else:
        assert logs[-1] == "STOPPED" and got["rc"] is None
        assert got["status"]["slots"][0]["running"] is False
        assert got["after_stop"] == [9, -15]
        assert got["children_gauge"] == 0


def test_stopped_supervisor_grows_nothing():
    """A worker-autoscaler grow that lands after the supervisor stopped
    (its thread still ticking while ``cli supervise`` exits) spawns no
    child: the grow is refused, so no worker outlives its supervisor."""
    spawned = []

    def spawn(argv, env):
        spawned.append(FakeProc(clock, None, 0))
        return spawned[-1]

    clock = FakeClock()
    sup = SUP.WorkerSupervisor(lambda s, a: [f"child-{s}-{a}"], 1,
                               SUP.SupervisorConfig(**FAST), clock=clock,
                               spawn=spawn, log=lambda msg, **kw: None)
    sup.start()
    assert sup.grow() == 1 and len(spawned) == 2
    sup.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        sup.grow()
    assert len(spawned) == 2 and sup.count() == 0
    assert [p.poll() for p in spawned] == [-15, -15]


def test_supervisor_refuses_no_slots():
    for mod, _, _ in PKGS.values():
        with pytest.raises(ValueError, match="n_workers"):
            mod.WorkerSupervisor(lambda s, a: ["x"], 0)


@pytest.mark.parametrize("attempt", [0, 1])
def test_build_worker_argv_is_jax_but_for_the_module(attempt):
    kw = dict(first_spawn_faults={0: "seed=7;push.kill@n=2"},
              first_spawn_env={0: {"DPS_NAN_STEP": "4"}}, attempt=attempt,
              python="py")
    for base, slot in ((["--server", "h:1"], 0),
                       (["--server", "h:1", "--worker-name", "x"], 1)):
        argv, env = SUP.build_worker_argv(base, slot, **kw)
        jargv, jenv = JSUP.build_worker_argv(base, slot, **kw)
        assert env == jenv
        assert argv[2] == \
            "distributed_parameter_server_for_ml_training_tpu_torch.cli"
        assert argv[:2] + argv[3:] == jargv[:2] + jargv[3:]
    assert ("--faults" in argv) == (attempt == 0 and slot == 0)


def _verb_flags(parser, verb) -> dict:
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    parser = sub.choices[verb]
    return {a.dest: (tuple(a.option_strings), a.default, a.choices,
                     a.nargs, getattr(a.type, "__name__", a.type), a.const)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("verb", ["supervise", "reshard"])
def test_verb_flags_and_defaults_equal_jax(verb, monkeypatch):
    for name in list(os.environ):
        if name.startswith("DPS_"):
            monkeypatch.delenv(name)
    j = _verb_flags(JCLI.build_parser(), verb)
    p = _verb_flags(cli.build_parser(), verb)
    assert j.pop("platform", None) is not None or verb == "reshard"
    dev = p.pop("device", None)
    if verb == "supervise":
        assert dev[0] == ("--device",) and dev[1] == "cuda"
    assert p == j


class FakeSupervisor:
    """Stands in for the supervisor class in ``_cmd_supervise``: records
    what it was built with and runs nothing."""

    made = []

    def __init__(self, argv_for, n, config):
        self.argv_for, self.n, self.config = argv_for, n, config
        FakeSupervisor.made.append(self)

    def start(self):
        pass

    def run(self):
        return 0


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("device", [None, "cpu"], ids=["card", "cpu"])
def test_supervise_builds_the_children_jax_builds(pkg, device,
                                                  monkeypatch):
    """The argv and env each slot's first and later spawns get; with
    ``--device cpu`` (JAX: ``--platform cpu``) the children are pinned to
    the CPU, with no flag they run on the device the worker defaults to
    (the card for the port)."""
    mod, _, cmod = PKGS[pkg]
    monkeypatch.setattr(mod, "WorkerSupervisor", FakeSupervisor)
    monkeypatch.setattr(mod, "install_signal_stop", lambda s: None)
    FakeSupervisor.made.clear()
    argv = ["supervise", "--workers", "2", "--respawn-backoff", "0.5",
            "--slot-faults", "0:seed=7;push.kill@n=2",
            "--slot-env", "1:DPS_NAN_STEP=4", "--no-respawn"]
    if device:
        argv += ["--device" if pkg == "port" else "--platform", device]
    assert cmod.main(argv + ["--", "--server", "h:1", "--epochs",
                             "1"]) == 0
    sup = FakeSupervisor.made[-1]
    assert sup.n == 2 and sup.config.respawn is False
    assert sup.config.backoff_initial == 0.5
    spawns = [sup.argv_for(s, a) for s in (0, 1) for a in (0, 1)]
    flag = "--device" if pkg == "port" else "--platform"
    for child, env in spawns:
        assert (flag in child) == (device == "cpu")
        if device == "cpu":
            assert child[child.index(flag) + 1] == "cpu"
    assert "--faults" in spawns[0][0] and "--faults" not in spawns[1][0]
    assert spawns[2][1] == {"DPS_NAN_STEP": "4"} and spawns[3][1] is None
    # The port's children and JAX's differ only in the module and pin.
    if pkg == "port":
        monkeypatch.setattr(JSUP, "WorkerSupervisor", FakeSupervisor)
        monkeypatch.setattr(JSUP, "install_signal_stop", lambda s: None)
        jargv = [("--platform" if a == "--device" else a) for a in argv]
        JCLI.main(jargv + ["--", "--server", "h:1", "--epochs", "1"])
        jsup = FakeSupervisor.made[-1]
        for s in (0, 1):
            for a in (0, 1):
                c, e = sup.argv_for(s, a)
                jc, je = jsup.argv_for(s, a)
                assert e == je
                assert [x.replace("_torch", "").replace("--device",
                                                        "--platform")
                        for x in c] == jc


@pytest.mark.parametrize("device", ["cpu", "cuda:1"])
def test_supervise_passes_its_device_to_the_children(device, monkeypatch):
    """Any ``--device`` other than the default reaches every spawn of
    every slot as the children's ``--device``; a ``--device`` among the
    worker args wins over it."""
    monkeypatch.setattr(SUP, "WorkerSupervisor", FakeSupervisor)
    monkeypatch.setattr(SUP, "install_signal_stop", lambda s: None)
    for extra, want in (([], device), (["--device", "cuda:2"], "cuda:2")):
        FakeSupervisor.made.clear()
        assert cli.main(["supervise", "--workers", "2", "--device", device,
                         "--", "--server", "h:1", *extra]) == 0
        sup = FakeSupervisor.made[-1]
        for child, _ in (sup.argv_for(s, a) for s in (0, 1)
                         for a in (0, 1)):
            assert child.count("--device") == 1
            assert child[child.index("--device") + 1] == want


def test_supervise_needs_worker_args():
    for _, _, cmod in PKGS.values():
        with pytest.raises(SystemExit, match="child worker args"):
            cmod.main(["supervise", "--workers", "1"])
        with pytest.raises(SystemExit, match="SLOT:SPEC"):
            cmod.main(["supervise", "--slot-faults", "x", "--", "a"])
        with pytest.raises(SystemExit, match="autoscale-url"):
            cmod.main(["supervise", "--autoscale-job", "j", "--", "a"])


class _ClusterStub:
    """``GET /cluster``: the i-th request gets ``views[i]``, then the
    last one for ever."""

    def __init__(self, views):
        self.views, self.hits = views, 0
        stub = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                view = stub.views[min(stub.hits, len(stub.views) - 1)]
                stub.hits += 1
                body = json.dumps(view).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def _job_view(depth, workers=(0, 1), stragglers=()):
    return {"jobs": {"vision": {"waiting": depth,
                                "workers": list(workers)}},
            "alerts": [{"rule": "straggler_lag", "worker": w}
                       for w in stragglers]}


#: High pressure (grow twice), a straggler (grow), then a view without
#: jobs (an untenanted primary: an empty row, so cold) until the floor.
VIEWS = ([_job_view(9)] * 4 + [_job_view(2, stragglers=(1,))] * 2
         + [{"alerts": []}] * 8 + [_job_view(2)])


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_autoscale_job_grows_and_shrinks_in_jax_sequence(pkg, monkeypatch,
                                                         capsys):
    """``supervise --autoscale-job`` polls the stub's ``/cluster``; the
    supervisor's slot count follows the pressure in the JAX verb's
    sequence (checked against the sequence the JAX verb produced)."""
    mod, _, cmod = PKGS[pkg]
    stub = _ClusterStub(VIEWS)
    done = threading.Event()

    class Proc:
        _pid = 5000

        def __init__(self):
            Proc._pid += 1
            self.pid, self.killed = Proc._pid, None

        def poll(self):
            if self.killed is not None:
                return self.killed
            return 0 if done.is_set() else None

        def terminate(self):
            self.killed = -15

        kill = terminate

        def wait(self, timeout=None):
            return self.poll()

    base = mod.WorkerSupervisor

    class Sup(base):
        def __init__(self, argv_for, n, config):
            config.poll_interval = 0.01
            super().__init__(argv_for, n, config,
                             spawn=lambda argv, env: Proc())

    monkeypatch.setattr(mod, "WorkerSupervisor", Sup)
    monkeypatch.setattr(mod, "install_signal_stop", lambda s: None)
    platform = ["--device", "cpu"] if pkg == "port" else [
        "--platform", "cpu"]
    result = {}

    def run():
        result["rc"] = cmod.main(
            ["supervise", "--workers", "2", "--autoscale-job", "vision",
             "--autoscale-url", stub.url, "--autoscale-min", "1",
             "--autoscale-max", "4", "--autoscale-sustain", "2",
             "--autoscale-cooldown", "0", "--autoscale-poll", "0.01",
             *platform, "--", "--server", "h:1"])

    t = threading.Thread(target=run)
    t.start()
    try:
        t0 = time.monotonic()
        while stub.hits < len(VIEWS) + 3 and time.monotonic() - t0 < 30:
            time.sleep(0.01)
        # In band from here on: the sequence is complete. (Once the
        # children exit, the floor makes the autoscaler grow again.)
        out = capsys.readouterr().out
    finally:
        done.set()
        t.join(30)
        stub.close()
    assert result["rc"] == 0
    seq = [re.sub(r"pid=\d+", "pid=?", ln) for ln in out.splitlines()
           if ln.startswith(("WORKER_AUTOSCALE", "SUPERVISOR_GROW",
                             "SUPERVISOR_SHRINK"))]
    assert seq == [
        "SUPERVISOR_GROW slot=2",
        "WORKER_AUTOSCALE job=vision action=worker_grow outcome=ok "
        "depth=9.0 live=3",
        "SUPERVISOR_GROW slot=3",
        "WORKER_AUTOSCALE job=vision action=worker_grow outcome=ok "
        "depth=9.0 live=4",
        "SUPERVISOR_SHRINK slot=3",
        "WORKER_AUTOSCALE job=vision action=worker_shrink outcome=ok "
        "depth=0.0 live=3",
        "SUPERVISOR_SHRINK slot=2",
        "WORKER_AUTOSCALE job=vision action=worker_shrink outcome=ok "
        "depth=0.0 live=2",
        "SUPERVISOR_SHRINK slot=1",
        "WORKER_AUTOSCALE job=vision action=worker_shrink outcome=ok "
        "depth=0.0 live=1",
    ], seq


# -- real child processes (slow) ----------------------------------------------

def _config(**kw):
    defaults = dict(backoff_initial=0.05, backoff_max=0.2,
                    healthy_after=0.01, poll_interval=0.02)
    defaults.update(kw)
    return SUP.SupervisorConfig(**defaults)


@pytest.mark.slow
def test_respawn_through_real_kill(tmp_path):
    """A child that dies by SIGKILL is respawned and the replacement
    finishes: rc 0, one respawn recorded, the respawn counter up one."""
    sentinel = tmp_path / "came_up_once"
    script = (f"import os, sys\n"
              f"p = {str(sentinel)!r}\n"
              f"if os.path.exists(p):\n"
              f"    sys.exit(0)\n"
              f"open(p, 'w').close()\n"
              f"os.kill(os.getpid(), 9)\n")
    reg = get_registry()
    ok = reg.counter("dps_remediation_actions_total", action="respawn",
                     outcome="ok")
    before = ok.value
    sup = SUP.WorkerSupervisor(
        lambda slot, attempt: ([sys.executable, "-c", script], None), 1,
        _config())
    sup.start()
    rc = sup.run()
    slot = sup.status()["slots"][0]
    assert rc == 0
    assert slot["respawns"] == 1 and slot["last_rc"] == 0
    assert not slot["latched"]
    assert ok.value == before + 1


@pytest.mark.slow
def test_crash_loop_latches_with_real_children():
    sup = SUP.WorkerSupervisor(
        lambda slot, attempt: ([sys.executable, "-c",
                                "import sys; sys.exit(3)"], None), 1,
        _config(healthy_after=5.0, crash_loop_after=2))
    sup.start()
    rc = sup.run()
    slot = sup.status()["slots"][0]
    assert rc == 1 and slot["latched"]
    assert slot["attempt"] == 2


@pytest.mark.slow
def test_cli_supervise_respawns_a_killed_cpu_worker(tmp_path):
    """``cli supervise --device cpu`` against a port ``cli serve``: slot
    0's first worker is killed at its second push, respawned, and both
    slots finish; the supervisor exits 0. (The dead session stays in the
    server's membership for its 30 s timeout, so the server outlives the
    replacement's start.)"""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    pkg = "distributed_parameter_server_for_ml_training_tpu_torch.cli"
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    server = subprocess.Popen(
        [sys.executable, "-m", pkg, "serve", "--mode", "async",
         "--workers", "2", "--push-codec", "int8", "--elastic",
         "--worker-timeout", "30", "--port", str(port), "--device", "cpu",
         "--no-health-monitor"], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        sup = subprocess.run(
            [sys.executable, "-m", pkg, "supervise", "--workers", "2",
             "--respawn-backoff", "0.5", "--device", "cpu",
             "--slot-faults", "0:seed=7;push.kill@n=2", "--",
             "--server", f"127.0.0.1:{port}", "--synthetic",
             "--num-train", "128", "--num-test", "32", "--batch-size",
             "32", "--epochs", "1", "--heartbeat", "0.5"], env=env,
            capture_output=True, text=True, timeout=300)
    finally:
        server.terminate()
        server.wait(30)
    assert sup.returncode == 0, sup.stdout + sup.stderr
    assert "SUPERVISOR_CHILD_DIED slot=0" in sup.stdout
    assert "SUPERVISOR_RESPAWN slot=0 attempt=2" in sup.stdout
    assert sup.stdout.count("SUPERVISOR_DONE") == 2
