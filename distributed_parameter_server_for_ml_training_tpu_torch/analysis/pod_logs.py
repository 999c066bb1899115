"""Pod log ingestion: METRICS_JSON lines off a pod -> experiment JSON.

The JAX package's ``analysis/pod_logs.py``, carried over whole: ssh and
terraform discovery through an injectable command runner, then the
port's ``parse_experiment``.

The reference closes its L5 loop remotely: parse_cloudwatch_logs.py:34-60
discovers log groups from ``terraform output -json`` and shells out to
``aws logs filter-log-events`` to pull METRICS_JSON lines. The TPU-native
mirror:

- discovery: ``terraform output -json`` on deploy/terraform (pod_name /
  pod_zone outputs), or explicit --name/--zone,
- collection: ``gcloud compute tpus tpu-vm ssh --worker=all`` cat of the
  ``~/dps_train.log`` each host teed during ``tpu-pod.sh train``,
- aggregation: the same parse_experiment ETL used for local logs
  (analysis/parse_logs.py), writing a reference-schema experiment JSON.

One command turns a ``tpu-pod.sh train`` run into an experiment record:

    dps-tpu experiments ingest-pod --tf-dir deploy/terraform \
        --experiment-name pod_sync --out results/pod_sync.json

All shell-outs go through an injectable ``runner`` so the pipeline is
testable without gcloud/terraform on the box (tests/test_analysis.py).
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import Callable

from .parse_logs import parse_experiment

Runner = Callable[[list[str]], str]


def _default_runner(cmd: list[str]) -> str:
    """Run ``cmd`` and return stdout; raises CalledProcessError on failure
    with stderr attached (surfaced to the CLI user)."""
    proc = subprocess.run(cmd, check=True, capture_output=True, text=True)
    return proc.stdout


def discover_pod(tf_dir: str, runner: Runner = _default_runner) -> dict:
    """Pod identity from the IaC state (parse_cloudwatch_logs.py:34-60's
    discovery, against deploy/terraform's pod_name/pod_zone outputs)."""
    out = runner(["terraform", f"-chdir={tf_dir}", "output", "-json"])
    values = json.loads(out)
    try:
        return {"name": values["pod_name"]["value"],
                "zone": values["pod_zone"]["value"]}
    except KeyError as e:
        raise KeyError(
            f"terraform output missing {e} — is deploy/terraform applied "
            f"(outputs pod_name/pod_zone)?") from e


def collect_pod_logs(name: str, zone: str,
                     log_path: str = "~/dps_train.log",
                     runner: Runner = _default_runner) -> str:
    """ssh-cat every host's teed training log (``--worker=all`` streams
    all hosts' output back concatenated — exactly what the METRICS_JSON
    regex parser wants)."""
    return runner([
        "gcloud", "compute", "tpus", "tpu-vm", "ssh", name,
        "--zone", zone, "--worker=all",
        "--command", f"cat {log_path}",
    ])


def ingest_pod(experiment_name: str,
               name: str | None = None, zone: str | None = None,
               tf_dir: str | None = None,
               log_path: str = "~/dps_train.log",
               out_path: str | None = None,
               runner: Runner = _default_runner) -> dict:
    """Discover (unless name+zone given) -> collect -> aggregate -> write.

    Returns the experiment record (reference schema, like
    experiments/results/*.json)."""
    if name is None or zone is None:
        if tf_dir is None:
            raise ValueError("need --name/--zone or --tf-dir to discover")
        pod = discover_pod(tf_dir, runner)
        # Explicit values override discovery INDIVIDUALLY (e.g. --pod-name
        # with the zone discovered from the IaC state).
        name = name if name is not None else pod["name"]
        zone = zone if zone is not None else pod["zone"]
    logs = collect_pod_logs(name, zone, log_path, runner)
    record = parse_experiment(logs, experiment_name)
    record["source"] = {"pod_name": name, "pod_zone": zone,
                        "log_path": log_path}
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(record, f, indent=2)
            f.write("\n")
    return record
