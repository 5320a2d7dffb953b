"""Experiment metrics logging (counterpart of ``mrijax/obs/logger.py``).

The reference logs params/metrics/artifacts to a remote MLflow server
(`slice_cond_2d_ddpm/model.py:292-323`). Here the hub is a local,
append-only JSONL log with the same vocabulary (params / metrics-with-step /
artifacts / tags) so runs are greppable and diffable offline; if the
``mlflow`` package is importable and ``MLFLOW_TRACKING_URI`` is set, every
call is mirrored to MLflow transparently.
"""

import json
import os
import time
import uuid
from pathlib import Path
from typing import Any, Dict, Optional


class MetricsLogger:
    """MLflow-compatible run logger backed by JSONL files.

    Layout: ``<root>/<experiment>/<run_id>/{meta.json, params.json,
    metrics.jsonl, tags.json, artifacts/}``.
    """

    def __init__(
        self,
        experiment: str,
        run_name: Optional[str] = None,
        root: str = "runs",
        use_mlflow: Optional[bool] = None,
    ):
        self.experiment = experiment
        # reference uses SLURM_JOB_ID as the run name when present
        self.run_id = run_name or os.environ.get("SLURM_JOB_ID") or uuid.uuid4().hex[:12]
        self.dir = Path(root) / experiment / str(self.run_id)
        (self.dir / "artifacts").mkdir(parents=True, exist_ok=True)
        self._metrics_f = open(self.dir / "metrics.jsonl", "a", buffering=1)
        self._params: Dict[str, Any] = {}
        self._tags: Dict[str, Any] = {}
        (self.dir / "meta.json").write_text(
            json.dumps({"experiment": experiment, "run_id": self.run_id,
                        "start_time": time.time()})
        )

        self._mlflow = None
        if use_mlflow is None:
            use_mlflow = bool(os.environ.get("MLFLOW_TRACKING_URI"))
        if use_mlflow:
            try:  # pragma: no cover - optional dependency
                import mlflow

                mlflow.set_experiment(experiment)
                mlflow.start_run(run_name=str(self.run_id))
                self._mlflow = mlflow
            except Exception as e:  # noqa: BLE001
                print(f"[MetricsLogger] mlflow unavailable: {e}")

    def log_params(self, params: Dict[str, Any]) -> None:
        self._params.update(params)
        (self.dir / "params.json").write_text(json.dumps(self._params, indent=2))
        if self._mlflow:
            self._mlflow.log_params(params)

    def log_metric(self, key: str, value: float, step: Optional[int] = None) -> None:
        rec = {"key": key, "value": float(value), "step": step, "ts": time.time()}
        self._metrics_f.write(json.dumps(rec) + "\n")
        if self._mlflow:
            self._mlflow.log_metric(key, float(value), step=step)

    def log_metrics(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        for k, v in metrics.items():
            self.log_metric(k, v, step)

    def set_tags(self, tags: Dict[str, Any]) -> None:
        self._tags.update(tags)
        (self.dir / "tags.json").write_text(json.dumps(self._tags, indent=2))
        if self._mlflow:
            self._mlflow.set_tags(tags)

    def artifact_path(self, name: str) -> Path:
        return self.dir / "artifacts" / name

    def log_artifact(self, path) -> None:
        # local artifacts live under the run dir already; mirror to mlflow
        if self._mlflow:
            self._mlflow.log_artifact(str(path))

    def finish(self) -> None:
        self._metrics_f.close()
        if self._mlflow:
            self._mlflow.end_run()

    # -------- convenience for reading back (used by tests/eval harness)
    def read_metrics(self):
        out = []
        with open(self.dir / "metrics.jsonl") as f:
            for line in f:
                out.append(json.loads(line))
        return out


class NullLogger:
    """No-op logger with the MetricsLogger interface, for non-zero ranks in
    multi-process runs (the reference logs to MLflow from rank 0 only via
    torchrun's rank gating); every process still computes the same metrics —
    only the WRITES are host 0's."""

    def log_params(self, params) -> None:
        pass

    def log_metric(self, key, value, step=None) -> None:
        pass

    def log_metrics(self, metrics, step=None) -> None:
        pass

    def set_tags(self, tags) -> None:
        pass

    def artifact_path(self, name: str) -> Path:
        import tempfile

        return Path(tempfile.mkdtemp(prefix="mrijax_torch_null_artifacts_")) / name

    def log_artifact(self, path) -> None:
        pass

    def finish(self) -> None:
        pass
