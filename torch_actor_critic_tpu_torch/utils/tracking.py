"""File-based experiment tracking (copied from the JAX package's
``utils/tracking.py``; it imports the standard library only).

Capability twin of the reference's MLflow usage (params at run start,
per-epoch metrics, artifact storage, run-id resume — ref
``main.py:132-138,161-164``, ``sac/algorithm.py:291-296``) without the
MLflow dependency (not available in this image). Layout:

    <root>/<experiment>/<run_id>/
        params.json        # hyperparameters (typed, not stringly)
        metrics.jsonl      # one {"step": e, **metrics} line per log
        artifacts/         # checkpoints etc.

``Tracker.load`` resumes an existing run by id, the counterpart of
``mlflow.start_run(run_id)`` + ``load_session`` (ref ``main.py:28-51``).
If mlflow IS importable, :class:`Tracker` can mirror logs to it
(``mirror_mlflow=True``) for drop-in dashboard compatibility.
"""

from __future__ import annotations

import json
import logging
import math
import time
import typing as t
import uuid
from pathlib import Path

logger = logging.getLogger(__name__)


class Tracker:
    def __init__(
        self,
        experiment: str = "Default",
        run_id: str | None = None,
        root: str | Path = "runs",
        enabled: bool = True,
        mirror_mlflow: bool = False,
    ):
        self.enabled = enabled
        self.experiment = experiment
        self.run_id = run_id or uuid.uuid4().hex[:16]
        self.run_dir = Path(root) / experiment / self.run_id
        self.artifacts_dir = self.run_dir / "artifacts"
        self._mlflow = None
        if enabled:
            self.artifacts_dir.mkdir(parents=True, exist_ok=True)
            if mirror_mlflow:
                try:
                    import mlflow

                    mlflow.set_experiment(experiment)
                    mlflow.start_run(run_name=self.run_id)
                    self._mlflow = mlflow
                except ImportError:
                    pass

    @classmethod
    def load(cls, run_id: str, experiment: str = "Default", root="runs") -> "Tracker":
        """An existing run; raises ``FileNotFoundError`` when there is
        none (checked before the constructor creates the directory)."""
        run_dir = Path(root) / experiment / run_id
        if not run_dir.is_dir():
            raise FileNotFoundError(f"run {run_id} not found under {run_dir}")
        return cls(experiment=experiment, run_id=run_id, root=root)

    # ------------------------------------------------------------------ api

    def log_params(self, params: t.Mapping[str, t.Any]) -> None:
        if not self.enabled:
            return
        existing = self.params()
        existing.update(params)
        (self.run_dir / "params.json").write_text(json.dumps(existing, indent=2))
        if self._mlflow:
            self._mlflow.log_params(dict(params))

    def params(self) -> dict:
        p = self.run_dir / "params.json"
        return json.loads(p.read_text()) if p.exists() else {}

    @property
    def metrics_path(self) -> Path:
        """The append-only JSONL metrics mirror: one strict-JSON object
        per epoch, flushed per line — external pollers ``tail -f`` this
        instead of parsing MLflow state (docs/OBSERVABILITY.md)."""
        return self.run_dir / "metrics.jsonl"

    def log_metrics(self, metrics: t.Mapping[str, float], step: int) -> None:
        """Append one epoch row to the JSONL mirror (and best-effort to
        the MLflow mirror, when configured).

        The JSONL file is the source of truth: it is written FIRST and
        flushed per line, and a broken MLflow mirror is logged rather
        than allowed to lose the row. Non-finite values are mapped to
        ``null`` — Python's ``json`` would otherwise emit ``NaN``
        literals that strict JSON parsers (jq, serde, browsers) reject,
        breaking exactly the external pollers the mirror exists for."""
        if not self.enabled:
            return
        row: dict = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            v = float(v)
            row[k] = v if math.isfinite(v) else None
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(row) + "\n")
            f.flush()
        if self._mlflow:
            try:
                self._mlflow.log_metrics(
                    {k: float(v) for k, v in metrics.items()}, step
                )
            except Exception as e:  # noqa: BLE001 — mirror, not truth
                logger.warning("mlflow mirror failed at step %d: %r", step, e)

    def metrics(self) -> t.List[dict]:
        p = self.metrics_path
        if not p.exists():
            return []
        return [json.loads(line) for line in p.read_text().splitlines() if line]

    def artifact_path(self, name: str) -> Path:
        return self.artifacts_dir / name
