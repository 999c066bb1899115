"""The new flags of ``cli serve``, ``cli worker`` and ``cli train --mode
async`` reach StoreConfig and WorkerConfig as the JAX CLI passes them
(JAX ``tests/test_ps_workers.py`` checks its own the same way). The model
and the dataset are stood in by small ones: what is checked is the
plumbing, not a run."""

import pytest

from distributed_parameter_server_for_ml_training_tpu_torch import cli, \
    models
from distributed_parameter_server_for_ml_training_tpu_torch.data import \
    synthetic_cifar100


@pytest.fixture(autouse=True)
def small(monkeypatch):
    """A tiny ResNet for ``get_model`` and 64 synthetic images for the
    dataset flags."""
    def get_model(name, num_classes=10, device="cpu", **kw):
        return models.ResNet(stage_sizes=(1, 1), num_filters=8,
                             num_classes=num_classes).to(device)

    monkeypatch.setattr(models, "get_model", get_model)
    monkeypatch.setattr(cli, "_load_dataset",
                        lambda args: synthetic_cifar100(64, 16, 10, seed=0))


def test_serve_flags_reach_store_config(monkeypatch):
    """``serve``'s store options reach StoreConfig as the JAX CLI passes
    them (the store's construction is where the run is cut short)."""
    from distributed_parameter_server_for_ml_training_tpu_torch import ps
    seen = {}

    def capture(backend, flat, config):
        seen["backend"], seen["config"] = backend, config
        raise KeyboardInterrupt

    monkeypatch.setattr(ps, "make_store", capture)
    with pytest.raises(KeyboardInterrupt):
        cli.main(["serve", "--mode", "sync", "--workers", "3",
                  "--fetch-codec", "bf16", "--elastic",
                  "--worker-timeout", "30", "--sync-quorum", "0.5",
                  "--round-deadline", "2.5", "--push-codec", "int8"])
    cfg = seen["config"]
    assert seen["backend"] == "python"
    assert (cfg.mode, cfg.total_workers, cfg.fetch_codec, cfg.elastic,
            cfg.worker_timeout, cfg.sync_quorum, cfg.round_deadline,
            cfg.push_codec, cfg.strict_rounds) == (
        "sync", 3, "bf16", True, 30.0, 0.5, 2.5, "int8", True)
    with pytest.raises(SystemExit, match="apply to --mode sync"):
        cli.main(["serve", "--mode", "async", "--sync-quorum", "2"])


def test_worker_flags_reach_worker_config(monkeypatch):
    """``worker``'s mode flags reach WorkerConfig as the JAX CLI passes
    them (:1772-1775), plus local_sgd's step size."""
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import \
        worker as W
    seen = {}

    class Fake:
        def __init__(self, store, model, dataset, cfg, worker_name=""):
            seen["cfg"], seen["name"] = cfg, worker_name
            self.result = W.WorkerResult()

        def start(self):
            pass

        def join(self):
            pass

    monkeypatch.setattr(W, "PSWorker", Fake)
    rc = cli.main(["worker", "--server", "127.0.0.1:1", "--synthetic",
                   "--num-train", "64", "--num-test", "16", "--device",
                   "cpu", "--worker-name", "w7", "--sync-steps", "4",
                   "--k-step-mode", "local_sgd", "--local-lr", "0.05",
                   "--overlap", "--heartbeat", "1.5",
                   "--reconnect-timeout", "60"])
    cfg = seen["cfg"]
    assert rc == 0 and seen["name"] == "w7"
    assert (cfg.sync_steps, cfg.k_step_mode, cfg.local_lr, cfg.overlap,
            cfg.heartbeat_interval, cfg.reconnect_timeout) == (
        4, "local_sgd", 0.05, True, 1.5, 60.0)


def test_train_async_flags_reach_store_and_worker(monkeypatch):
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        import distributed as D
    seen = {}

    def capture(store, model, dataset, n, wc):
        seen["store"], seen["wc"] = store.config, wc
        return []

    monkeypatch.setattr(D, "run_workers", capture)
    rc = cli.main(["train", "--mode", "async", "--workers", "2",
                   "--epochs", "1", "--synthetic", "--num-train", "64",
                   "--num-test", "16", "--device", "cpu", "--sync-steps",
                   "2", "--k-step-mode", "local_sgd", "--local-lr", "0.02",
                   "--overlap", "--reconnect-timeout", "5", "--elastic",
                   "--worker-timeout", "9", "--no-delta-fetch"])
    assert rc == 0
    sc, wc = seen["store"], seen["wc"]
    assert (sc.elastic, sc.worker_timeout, sc.total_workers) == \
        (True, 9.0, 2)
    assert (wc.sync_steps, wc.k_step_mode, wc.local_lr, wc.overlap,
            wc.reconnect_timeout, wc.delta_fetch) == (
        2, "local_sgd", 0.02, True, 5.0, False)
    # With expiry on and no --heartbeat, workers ping at a third of the
    # timeout, as the JAX trainer does.
    assert wc.heartbeat_interval == 3.0


def test_train_async_device_store_checkpoints_and_resumes(tmp_path,
                                                          capsys):
    """``train --mode async --store-backend device --checkpoint-dir D``
    runs over the device-resident store (on the CPU here) and leaves a
    store snapshot; ``--resume`` continues from its step;
    ``--strict-rounds`` reaches the store's config."""
    from distributed_parameter_server_for_ml_training_tpu_torch \
        .checkpoint import load_store_record
    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        .metrics import parse_metrics_lines
    argv = ["train", "--mode", "async", "--workers", "2", "--epochs", "1",
            "--batch-size", "16", "--synthetic", "--num-train", "64",
            "--num-test", "16", "--device", "cpu", "--store-backend",
            "device", "--strict-rounds", "--checkpoint-dir", str(tmp_path),
            "--emit-metrics"]
    assert cli.main(argv) == 0
    assert load_store_record(str(tmp_path))[1]["global_step"] == 4
    assert cli.main([*argv, "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed store from global step 4" in out
    servers = [r for r in parse_metrics_lines(out) if "store_backend" in r]
    assert [r["store_backend"] for r in servers] == ["device", "device"]
    assert [r["global_steps_completed"] for r in servers] == [4, 8]
    meta = load_store_record(str(tmp_path))[1]
    assert meta["global_step"] == 8 and meta["aggregation"]["strict_rounds"]


def _serve_until_bound(monkeypatch, argv):
    """``cli serve`` cut short where it would bind: returns the service it
    built (its monitor stopped and unregistered again)."""
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        import service as S
    from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
        import get_cluster_monitor, set_cluster_monitor
    seen = {}

    def capture(store, port=8000, service=None, **kw):
        seen["svc"], seen["global"] = service, get_cluster_monitor()
        raise KeyboardInterrupt

    monkeypatch.setattr(S, "serve", capture)
    try:
        with pytest.raises(KeyboardInterrupt):
            cli.main(["serve", "--mode", "async", "--workers", "2", *argv])
    finally:
        svc = seen.get("svc")
        if svc is not None and svc.monitor is not None:
            svc.monitor.stop(final=False)
        set_cluster_monitor(None)
    return seen["svc"], seen["global"]


def test_serve_runs_the_health_monitor_by_default(monkeypatch, capsys):
    """As a default JAX ``cli serve`` does: a started ClusterMonitor with
    the JAX defaults and the SLO evaluator, registered process-wide; the
    register reply advertises ``health_report``; no remediation."""
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .service import pack_msg, unpack_msg
    svc, registered = _serve_until_bound(monkeypatch, [])
    mon = svc.monitor
    assert registered is mon and mon.interval == 5.0
    assert (mon.engine.thresholds.dead_after_s,
            mon.engine.thresholds.straggler_lag_steps) == (30.0, 100)
    slo = mon.slo
    assert [o.name for o in slo.objectives] == [
        "fetch_latency", "fetch_availability", "push_availability"]
    assert slo.objectives[0].threshold_s == 0.1
    assert [(w.window_s, w.burn_threshold) for w in slo.windows] == [
        (60.0, 14.4), (300.0, 6.0)]
    assert mon.remediation is None and svc.reject_nonfinite is False
    reply = svc.register_worker(pack_msg({"worker_name": "w"}), None)
    assert unpack_msg(reply)[0]["health_report"] is True
    assert "slo: evaluator on (fetch p99 100ms" in capsys.readouterr().err


def test_serve_health_flags_reach_the_monitor(monkeypatch, capsys):
    svc, _ = _serve_until_bound(monkeypatch, [
        "--health-interval", "2.5", "--dead-after", "12",
        "--straggler-lag", "7", "--slo-fetch-p99-ms", "250",
        "--slo-availability", "0.95", "--slo-fast-window", "30",
        "--slo-slow-window", "120", "--slo-fast-burn", "10",
        "--slo-slow-burn", "3", "--remediate", "--remediation-cooldown",
        "4", "--quarantine-secs", "9"])
    mon = svc.monitor
    assert mon.interval == 2.5
    assert (mon.engine.thresholds.dead_after_s,
            mon.engine.thresholds.straggler_lag_steps) == (12.0, 7)
    assert mon.slo.objectives[0].threshold_s == 0.25
    assert mon.slo.objectives[1].target == 0.95
    assert [(w.window_s, w.burn_threshold) for w in mon.slo.windows] == [
        (30.0, 10.0), (120.0, 3.0)]
    engine = mon.remediation
    assert engine.service is svc and engine.store is svc.store
    assert (engine.policy.dry_run, engine.policy.cooldown_s,
            engine.policy.quarantine_s) == (False, 4.0, 9.0)
    assert engine.handle_events in mon._listeners
    assert svc.reject_nonfinite is True
    assert "remediation: engine on (dry_run=False)" in capsys.readouterr().err


@pytest.mark.parametrize("argv,monitor,slo,dry_run", [
    (["--no-slo"], True, False, None),
    (["--remediate-dry-run"], True, True, True),
    (["--no-health-monitor"], False, False, None),
], ids=["no_slo", "dry_run", "no_monitor"])
def test_serve_health_switches(monkeypatch, argv, monitor, slo, dry_run):
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .service import pack_msg, unpack_msg
    svc, registered = _serve_until_bound(monkeypatch, argv)
    assert (svc.monitor is not None) == monitor
    assert registered is svc.monitor
    if monitor:
        assert (svc.monitor.slo is not None) == slo
        engine = svc.monitor.remediation
        assert (engine.policy.dry_run if engine else None) == dry_run
    # A dry run rehearses without the synchronous non-finite refusal.
    assert svc.reject_nonfinite is False
    reply = svc.register_worker(pack_msg({"worker_name": "w"}), None)
    assert unpack_msg(reply)[0]["health_report"] is monitor


def test_serve_remediate_needs_the_monitor(monkeypatch):
    with pytest.raises(SystemExit, match="--remediate needs the health "
                                         "monitor"):
        cli.main(["serve", "--remediate", "--no-health-monitor"])


@pytest.mark.parametrize("env,attr,value", [
    ("DPS_REMEDIATE", "remediate", True),
    ("DPS_QUARANTINE_SECS", "quarantine_secs", 12.0),
    ("DPS_HEALTH_INTERVAL", "health_interval", 1.5),
    ("DPS_DEAD_AFTER", "dead_after", 45.0),
    ("DPS_STRAGGLER_LAG", "straggler_lag", 9),
    ("DPS_SLO_FETCH_P99_MS", "slo_fetch_p99_ms", 80.0),
    ("DPS_REMEDIATION_COOLDOWN", "remediation_cooldown", 3.0),
], ids=lambda v: v if isinstance(v, str) else None)
def test_serve_health_flags_read_their_environment(monkeypatch, env, attr,
                                                   value):
    """The serve flags' defaults come from the JAX CLI's ``DPS_*``
    variables."""
    monkeypatch.setenv(env, "1" if value is True else str(value))
    args = cli.build_parser().parse_args(["serve"])
    assert getattr(args, attr) == value


# -- the fleet, forensics and experiment verbs ---------------------------------

_LOAD_DATASET = cli._load_dataset      # before ``small`` stands in for it
#: Each package's own flag: the JAX CLI's backend switch, the port's
#: device.
_OWN_FLAGS = {"jax": {"platform"}, "port": {"device"}}


def _verb_flags(parser, *path) -> dict:
    """``{dest: (option strings, default, choices, nargs, type, const)}``
    of one (sub)verb's parser."""
    import argparse
    for name in path:
        sub = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction))
        parser = sub.choices[name]
    return {a.dest: (tuple(a.option_strings), a.default, a.choices,
                     a.nargs, getattr(a.type, "__name__", a.type), a.const)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("path", [
    ("status",), ("observe",), ("top",), ("incident", "list"),
    ("incident", "show"), ("incident", "report"), ("query",),
    ("goodput",), ("experiments",)], ids=lambda p: "-".join(p))
def test_new_verbs_flags_and_defaults_equal_jax(path, monkeypatch):
    """The seven verbs take the JAX CLI's flags with its defaults (the
    environment's defaults unset), but for each package's own switch."""
    import os

    from distributed_parameter_server_for_ml_training_tpu import cli as jcli
    for name in list(os.environ):
        if name.startswith("DPS_"):
            monkeypatch.delenv(name)
    j = _verb_flags(jcli.build_parser(), *path)
    p = _verb_flags(cli.build_parser(), *path)
    for name in _OWN_FLAGS["jax"]:
        j.pop(name, None)
    for name in _OWN_FLAGS["port"]:
        p.pop(name, None)
    assert p == j


def test_synthetic_dataset_draws_only_what_the_run_keeps(monkeypatch):
    """``--synthetic --num-train/--num-test`` draw the kept images only,
    and those are the same bytes as the whole set sliced."""
    from distributed_parameter_server_for_ml_training_tpu_torch import data
    whole = synthetic_cifar100(2_000, 500)
    kept = synthetic_cifar100(2_000, 500, keep_train=300, keep_test=70)
    for a, b, n in ((kept.x_train, whole.x_train, 300),
                    (kept.y_train, whole.y_train, 300),
                    (kept.x_test, whole.x_test, 70),
                    (kept.y_test, whole.y_test, 70)):
        assert len(a) == n and (a == b[:n]).all()
    calls = []

    def spy(**kw):
        calls.append(kw)
        return kept
    monkeypatch.setattr(data, "synthetic_cifar100", spy)
    for argv, want in ((["--num-train", "300", "--num-test", "70"],
                        {"keep_train": 300, "keep_test": 70}),
                       (["--num-test", "0"],
                        {"keep_train": None, "keep_test": None})):
        args = cli.build_parser().parse_args(["train", "--synthetic",
                                              *argv])
        ds = _LOAD_DATASET(args)
        assert calls[-1] == want
        assert len(ds.x_train) == 300 and len(ds.x_test) == 70


def _both(argv, capsys):
    """(rc, stdout) of the JAX CLI and of the port's on ``argv``."""
    from distributed_parameter_server_for_ml_training_tpu import cli as jcli
    out = []
    for mod in (jcli, cli):
        rc = mod.main(list(argv))
        out.append((rc, capsys.readouterr().out))
    return out


@pytest.fixture
def forensics(tmp_path):
    from torch_forensics import telemetry, write_forensics
    return write_forensics(
        str(tmp_path), telemetry(
            "distributed_parameter_server_for_ml_training_tpu_torch"))


@pytest.mark.parametrize("json_out", [True, False], ids=["json", "text"])
def test_incident_verbs_print_what_jax_prints(forensics, capsys, json_out):
    flags = ["--dir", forensics["incidents"]] + (["--json"] if json_out
                                                 else [])
    bundle = forensics["bundle"].rsplit("/", 1)[1]
    for argv in (["incident", "list", *flags],
                 ["incident", "show", bundle[:12], *flags],
                 ["incident", "report", *flags],
                 ["incident", "report", bundle, "--journal-dir",
                  forensics["journal"], *flags]):
        (jrc, jout), (prc, pout) = _both(argv, capsys)
        assert (prc, pout) == (jrc, jout), argv
        assert prc == 0 and bundle in pout
    (jrc, _), (prc, _) = _both(["incident", "show", "nope", *flags], capsys)
    assert prc == jrc == 1


@pytest.mark.parametrize("extra", [
    ["--percentiles", "--slo", "--goodput"],
    ["--series", "latency", "--last", "60"],
    ["--percentiles", "--since", "1700000030", "--until", "1700000080"],
    ["--goodput", "--incidents", "INCIDENTS"],
], ids=["all", "series", "window", "incident_badput"])
@pytest.mark.parametrize("json_out", [True, False], ids=["json", "text"])
def test_query_prints_what_jax_prints(forensics, capsys, extra, json_out):
    extra = [forensics["incidents"] if a == "INCIDENTS" else a
             for a in extra]
    argv = ["query", "--journal", forensics["journal"], *extra] \
        + (["--json"] if json_out else [])
    (jrc, jout), (prc, pout) = _both(argv, capsys)
    assert (prc, pout) == (jrc, jout)
    assert pout


def test_query_and_top_replay_refuse_a_journal_without_records(tmp_path,
                                                               capsys):
    for argv in (["query", "--journal", str(tmp_path)],
                 ["top", "--replay", str(tmp_path)]):
        (jrc, jout), (prc, pout) = _both(argv, capsys)
        assert (prc, pout) == (jrc, jout) and prc == 1


@pytest.mark.parametrize("json_out", [True, False], ids=["json", "text"])
def test_goodput_prints_what_jax_prints(forensics, capsys, json_out):
    from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
        import start_metrics_server
    server, port = start_metrics_server(forensics["live"], port=0,
                                        addr="127.0.0.1")
    try:
        argv = ["goodput", "--url", f"127.0.0.1:{port}"] \
            + (["--json"] if json_out else [])
        (jrc, jout), (prc, pout) = _both(argv, capsys)
    finally:
        server.shutdown()
        server.server_close()
    assert (prc, pout) == (jrc, jout) and prc == 0
    assert "goodput" in pout.lower()
    (jrc, _), (prc, _) = _both(["goodput", "--url", f"127.0.0.1:{port}"],
                               capsys)
    assert prc == jrc == 1          # the endpoint is gone


def test_status_and_top_unreachable_exit_1(capsys):
    import socket
    with socket.socket() as sock:      # a port nothing listens on
        sock.bind(("127.0.0.1", 0))
        url = f"127.0.0.1:{sock.getsockname()[1]}"
    for argv in (["status", "--url", f"http://{url}"],
                 ["status", "--via-fleet", url], ["top", "--url", url],
                 ["status"], ["top"]):
        (jrc, _), (prc, _) = _both(argv, capsys)
        assert prc == jrc == 1, argv


def test_experiments_runs_the_matrix(tmp_path, monkeypatch, capsys):
    """``experiments`` on the CPU: one record a cell, in the reference
    schema, the server's steps the workers' pushes; ``--no-plots``."""
    import json
    import os

    from distributed_parameter_server_for_ml_training_tpu_torch.analysis \
        import runner
    monkeypatch.setattr(runner, "get_model", models.get_model)
    out = str(tmp_path / "cells")
    rc = cli.main(["experiments", "--modes", "sync,async",
                   "--worker-counts", "2", "--epochs", "1", "--synthetic",
                   "--batch-size", "16", "--no-plots", "--no-augment",
                   "--out-dir", out, "--device", "cpu"])
    assert rc == 0
    assert sorted(os.listdir(out)) == ["async_2workers.json",
                                       "sync_2workers.json"]
    for name in os.listdir(out):
        with open(os.path.join(out, name)) as f:
            rec = json.load(f)
        assert list(rec) == list(runner.RECORD_KEYS)
        assert rec["device"] == "cpu"
        pushes = sum(r["local_steps_completed"]
                     for r in rec["raw_worker_metrics"])
        assert rec["server_metrics"]["gradients_processed"] == pushes == 4
    assert "=== cell: sync x 2 workers ===" in capsys.readouterr().out
