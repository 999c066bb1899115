"""The port's analysis layer against the JAX package's, on the CPU:

- ``analysis.incidents``: a journal and incident bundle written by the
  port's telemetry (and one written by the JAX package's) read the same
  by both packages — the bundle list, a bundle's manifest and records,
  the causal timeline and its rendering;
- ``analysis.parse_logs`` on the same METRICS_JSON lines (worker and
  server exit rows, snapshot and cluster records) and
  ``analysis.fleet_series`` on the same fleet view and flight-recorder
  dumps: equal outputs;
- ``analysis.pod_logs.ingest_pod`` through the same fake command runner
  (no ssh, no terraform): the same record and the same commands;
- ``analysis.runner.run_cell`` on a tiny ResNet and 64 images, both
  packages from the same NumPy parameters (the port's through the params
  adapter): the record's keys equal JAX's and the port's
  ``RECORD_KEYS``, the server's step counts equal; the matrix's summary
  table and plots from both packages' visualizers.
"""

from __future__ import annotations

import copy
import json
import os
import random

import jax
import numpy as np
import pytest
from torch_forensics import telemetry, write_forensics
from torch_threads import one_torch_thread_per_module  # noqa: F401

from distributed_parameter_server_for_ml_training_tpu import analysis as JA
from distributed_parameter_server_for_ml_training_tpu.analysis import (
    incidents as JI, parse_logs as JL, pod_logs as JPL, runner as JRN)
from distributed_parameter_server_for_ml_training_tpu.data.cifar import \
    synthetic_cifar100 as jax_synthetic
from distributed_parameter_server_for_ml_training_tpu.models import \
    ResNet as JaxResNet
from distributed_parameter_server_for_ml_training_tpu.utils.pytree import \
    flatten_params as jax_flatten
from distributed_parameter_server_for_ml_training_tpu_torch import \
    analysis as PA
from distributed_parameter_server_for_ml_training_tpu_torch.analysis import (
    incidents as PI, parse_logs as PL, pod_logs as PPL, runner as PRN,
    visualize as PV)
from distributed_parameter_server_for_ml_training_tpu_torch.data import \
    synthetic_cifar100
from distributed_parameter_server_for_ml_training_tpu_torch.models import \
    ResNet
from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
    import trace as PT
from distributed_parameter_server_for_ml_training_tpu_torch.utils.pytree \
    import params_from_jax

PORT = "distributed_parameter_server_for_ml_training_tpu_torch"
JAX = "distributed_parameter_server_for_ml_training_tpu"


def test_exports_equal_jax_plus_the_ports_own():
    assert set(PA.__all__) - set(JA.__all__) == {
        "CUDA_DEVICE_CATEGORIES", "RECORD_KEYS", "top_device_ops"}
    assert set(JA.__all__) <= set(PA.__all__)
    assert PI.PHASE_ORDER == JI.PHASE_ORDER


# -- incidents -----------------------------------------------------------------

@pytest.mark.parametrize("writer", [PORT, JAX], ids=["port", "jax"])
def test_incident_readers_agree(tmp_path, writer):
    """One bundle and journal, read by both packages: list, show (the
    manifest), report (the window merged with the journal's post-edge
    records, the timeline and its rendering)."""
    out = write_forensics(str(tmp_path), telemetry(writer))
    rows = PI.list_incidents(out["incidents"])
    assert rows == JI.list_incidents(out["incidents"])
    assert len(rows) == 1 and rows[0]["trigger"]["rule"] == "nonfinite_loss"
    for journal_dir in (None, out["journal"]):
        p = PI.load_incident(out["bundle"], journal_dir=journal_dir)
        j = JI.load_incident(out["bundle"], journal_dir=journal_dir)
        assert p == j
        pt, jt = PI.build_timeline(p["records"]), \
            JI.build_timeline(j["records"])
        assert pt == jt
        assert PI.render_timeline(pt, p["manifest"]) \
            == JI.render_timeline(jt, j["manifest"])
    # The edge's breach is re-derived from disk: fault, then the alert,
    # the remediation after the edge and the resolution, in order.
    assert pt["ordered"]
    assert list(pt["phases"]) == ["fault", "alert", "remediation",
                                  "resolution"]
    assert PI.list_incidents(str(tmp_path / "none")) == []
    for rec in p["records"]:
        assert PI.classify_event(rec) == JI.classify_event(rec)
        assert PI.describe_event(rec) == JI.describe_event(rec)


def test_unreadable_bundle_reported_the_same(tmp_path):
    out = write_forensics(str(tmp_path), telemetry(PORT))
    broken = os.path.join(out["incidents"], "inc-broken")
    os.makedirs(broken)
    with open(os.path.join(broken, "manifest.json"), "w") as f:
        f.write("{not json")
    rows = PI.list_incidents(out["incidents"])
    assert rows == JI.list_incidents(out["incidents"])
    assert [r["id"] for r in rows if "error" in r] == ["inc-broken"]


# -- parse_logs and fleet_series ------------------------------------------------

def _log_lines(seed: int = 4) -> str:
    """Two workers' and a server's METRICS_JSON exit rows, the workers'
    snapshot records and the server's cluster records, as the CLI
    verbs print them."""
    rng = random.Random(seed)
    lines = []
    t0 = 1_700_000_000.0
    for w in range(2):
        for k in range(5):
            lines.append({
                "kind": "snapshot", "role": "worker", "pid": 100 + w,
                "ts": t0 + 2.0 * k, "uptime_seconds": 2.0 * k + 1.0,
                "counters": {
                    f"dps_worker_steps_total{{worker={w}}}": 8 * k,
                    "dps_store_fetches_total{backend=remote}": 4 * k,
                    "dps_store_fetch_not_modified_total{backend=remote}":
                        k,
                    f"dps_worker_pushes_total{{worker={w}}}": 4 * k},
                "gauges": {f"dps_worker_pipeline_depth{{worker={w}}}":
                           k % 2,
                           f"dps_worker_staleness{{worker={w}}}":
                           float(rng.randint(0, 3))},
                "histograms": {
                    f"dps_worker_overlap_saved_seconds{{worker={w}}}": {
                        "le": [0.01, 0.1, 1.0], "counts": [k, 1, 0, 0],
                        "sum": 0.02 * k, "count": k + 1}}})
        lines.append({
            "worker_id": w, "worker_name": f"w{w}", "total_workers": 2,
            "total_training_time_seconds": 9.5 + w,
            "average_epoch_time_seconds": 4.75 + w / 2,
            "epoch_times_seconds": [4.5 + w, 5.0],
            "final_test_accuracy": 0.2 + 0.1 * w,
            "all_test_accuracies": [0.1, 0.2 + 0.1 * w],
            "train_loss_per_epoch": [4.1, 3.9 - w / 10],
            "local_steps_completed": 16, "batch_size": 128,
            "learning_rate": 0.1, "num_epochs": 2, "reconnects": 0})
    for k in range(4):
        lines.append({
            "kind": "cluster", "role": "server", "pid": 7, "seq": 3 - k,
            "ts": t0 + 3.0 * (3 - k), "uptime_seconds": 1.0,
            "events": [{"state": "fired", "rule": "straggler",
                        "severity": "warning", "worker": 1,
                        "message": "lag", "since": t0 + k}] if k else [],
            "workers": [{"worker": w, "step": 4 * k + w, "loss": 4.0 - k,
                         "grad_norm": 1.5, "examples_per_s": 300.0,
                         "alive": True} for w in range(2)]})
    lines.append({"mode": "async", "total_workers": 2,
                  "global_steps_completed": 32, "total_parameter_updates":
                      32, "average_staleness": 0.9})
    text = "\n".join(f"noise {i}\nMETRICS_JSON: {json.dumps(m)}"
                     for i, m in enumerate(lines))
    return text + "\nnot a metrics line\n"


def test_parse_logs_equal():
    text = _log_lines()
    assert PL.parse_experiment(text, "e") == JL.parse_experiment(text, "e")
    assert PL.parse_experiment(text.splitlines(), "e") \
        == JL.parse_experiment(text.splitlines(), "e")
    ts = PL.build_telemetry_timeseries(text)
    assert ts == JL.build_telemetry_timeseries(text)
    assert ts["procs"]
    for fn in ("worker_throughput_series", "staleness_series"):
        assert getattr(PL, fn)(copy.deepcopy(ts)) \
            == getattr(JL, fn)(copy.deepcopy(ts))
    for fn in ("parse_snapshot_series", "parse_cluster_series",
               "alert_timeline", "cluster_worker_series"):
        assert getattr(PL, fn)(text) == getattr(JL, fn)(text), fn
    assert PL.alert_timeline(text)
    rows = [json.loads(line.split("METRICS_JSON: ", 1)[1])
            for line in text.splitlines() if "worker_id" in line]
    assert PL.aggregate_worker_metrics(rows) \
        == JL.aggregate_worker_metrics(rows)


def test_parse_log_files_equal(tmp_path):
    text = _log_lines(seed=6)
    paths = []
    for i, part in enumerate((text[:len(text) // 2],
                              text[len(text) // 2:])):
        paths.append(str(tmp_path / f"log{i}.txt"))
        with open(paths[-1], "w") as f:
            f.write(part)
    p = PL.parse_log_files(paths, "x", str(tmp_path / "p" / "x.json"))
    j = JL.parse_log_files(paths, "x", str(tmp_path / "j" / "x.json"))
    assert p == j
    assert (tmp_path / "p" / "x.json").read_text() \
        == (tmp_path / "j" / "x.json").read_text()


def test_fleet_series_equal(tmp_path):
    """Exemplars of a fleet view against the port's flight-recorder
    dumps: the same rows, resolved the same, the same trace trees."""
    was = PT.trace_enabled()
    PT.enable_tracing()
    try:
        for step in range(3):
            with PT.trace_span("worker.step", root=True, worker=4242,
                               step=step):
                with PT.trace_span("worker.fetch_wait"):
                    pass
        spans = PT.get_recorder().dump_payload()["spans"]
    finally:
        if not was:
            PT.disable_tracing()
    ids = sorted({s["trace_id"] for s in spans
                  if s.get("attrs", {}).get("worker") == 4242})
    dump = str(tmp_path / "trace-worker-1-on_demand.json")
    with open(dump, "w") as f:
        json.dump({"spans": [s for s in spans if s["trace_id"] in ids]}, f)
    view = {"rollups": {"histograms": {
        "dps_rpc_server_latency_seconds{method=FetchParameters}": {
            "le": [0.01, 0.1, 1.0], "counts": [1, 2, 3, 0],
            "exemplars": {"1": {"trace_id": ids[0], "value": 0.05,
                                "ts": 1.0},
                          "2": {"trace_id": "gone", "value": 0.5,
                                "ts": 2.0},
                          "x": {"trace_id": "bad", "value": 9.0}}},
        "dps_worker_step_seconds": {
            "le": [1.0], "counts": [1, 0],
            "exemplars": {"0": {"trace_id": ids[1], "value": 0.2}}}}}}
    for kw in ({}, {"min_value_s": 0.1},
               {"series_prefix": "dps_rpc_server_latency"}):
        assert PA.extract_exemplars(view, **kw) \
            == JA.extract_exemplars(view, **kw)
        p = PA.resolve_exemplars(view, dump_dir=str(tmp_path), **kw)
        assert p == JA.resolve_exemplars(view, dump_dir=str(tmp_path), **kw)
    p = PA.resolve_exemplars(view, dump_paths=[dump])
    assert (p["resolved"], p["unresolved"]) == (2, 1)


# -- pod_logs --------------------------------------------------------------------

class FakeRunner:
    """Answers terraform and the ssh cat with canned text; records every
    command."""

    def __init__(self, logs: str):
        self.logs = logs
        self.calls = []

    def __call__(self, cmd: list) -> str:
        self.calls.append(list(cmd))
        if cmd[0] == "terraform":
            return json.dumps({"pod_name": {"value": "pod-a"},
                               "pod_zone": {"value": "zone-b"}})
        return self.logs


@pytest.mark.parametrize("kw", [
    dict(tf_dir="deploy/terraform"),
    dict(name="pod-x", zone="zone-y"),
    dict(name="pod-x", tf_dir="deploy/terraform"),
], ids=["discovered", "explicit", "name_only"])
def test_ingest_pod_equal(tmp_path, kw):
    text = _log_lines(seed=8)
    runs = {}
    for tag, mod in (("port", PPL), ("jax", JPL)):
        runner = FakeRunner(text)
        out = str(tmp_path / tag / "pod.json")
        rec = mod.ingest_pod("pod_run", log_path="~/dps_train.log",
                             out_path=out, runner=runner, **kw)
        with open(out) as f:
            runs[tag] = (rec, runner.calls, f.read())
    assert runs["port"] == runs["jax"]
    assert runs["port"][0]["source"]["pod_name"] \
        == kw.get("name", "pod-a")


def test_ingest_pod_needs_a_pod():
    for mod in (PPL, JPL):
        with pytest.raises(ValueError, match="--tf-dir"):
            mod.ingest_pod("x", runner=FakeRunner(""))

    def no_outputs(cmd):
        return "{}"
    msgs = []
    for mod in (PPL, JPL):
        with pytest.raises(KeyError) as e:
            mod.ingest_pod("x", tf_dir="d", runner=no_outputs)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# -- runner and visualize ---------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jm = JaxResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)
    v = jm.init(jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32),
                train=False)
    return (jm, jax_flatten(v["params"]),
            synthetic_cifar100(64, 16, 10, seed=2),
            jax_synthetic(64, 16, 10, seed=2))


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_run_cell_record_matches_jax(tiny, mode):
    jm, init, ds, jds = tiny
    tm = ResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)
    tm.load_state_dict(params_from_jax(init), strict=False)
    p = PRN.run_cell(ds, mode, 2, epochs=1, batch_size=32, num_classes=10,
                     model=tm, augment=False, device="cpu")
    j = JRN.run_cell(jds, mode, 2, epochs=1, batch_size=32, num_classes=10,
                     model=jm, augment=False)
    assert list(p) == list(j) == list(PRN.RECORD_KEYS)
    assert p["experiment_name"] == j["experiment_name"] == \
        f"{mode}_2workers"
    assert p["dataset"] == j["dataset"]
    assert p["device"] == "cpu"
    for key in ("mode", "total_workers", "global_steps_completed",
                "total_parameter_updates", "gradients_processed"):
        assert p["server_metrics"][key] == j["server_metrics"][key], key
    assert set(p["server_metrics"]) == set(j["server_metrics"])
    assert set(p["worker_metrics_aggregated"]) \
        == set(j["worker_metrics_aggregated"])
    # The port's worker rows add the epochs' mean losses.
    assert [set(r) for r in p["raw_worker_metrics"]] \
        == [set(r) | {"train_loss_per_epoch"}
            for r in j["raw_worker_metrics"]]
    assert sum(r["local_steps_completed"] for r in p["raw_worker_metrics"]) \
        == p["server_metrics"]["gradients_processed"]


def test_matrix_summary_and_plots_equal(tiny, tmp_path, capsys):
    jm, init, ds, _ = tiny
    tm = ResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)
    tm.load_state_dict(params_from_jax(init), strict=False)
    out = str(tmp_path / "m")
    recs = PRN.run_matrix(ds, out, modes=("sync", "async"),
                          worker_counts=(2,), epochs=1, batch_size=32,
                          num_classes=10, model=tm, augment=False,
                          device="cpu")
    assert [r["experiment_name"] for r in recs] == ["sync_2workers",
                                                    "async_2workers"]
    printed = capsys.readouterr().out
    assert PV.ExperimentVisualizer(out).summary_table() \
        == JA.ExperimentVisualizer(out).summary_table()
    assert PV.ExperimentVisualizer(out).summary_table() in printed
    assert {"sync_vs_async.png", "scaling.png"} <= set(os.listdir(out))
    with open(os.path.join(out, "sync_2workers.json")) as f:
        assert list(json.load(f)) == list(PRN.RECORD_KEYS)
