"""Experiment metric logging (vdn/utils/logging.py, the same records).

Re-design of the reference WandbManager (reference utils/wandb_manager.py:12-255):
buffered metric/image logging behind one interface with pluggable sinks —
console, JSON-lines file, and wandb/TensorBoard when available.  Keeps the
E### run-numbering AND resume-by-run-id (reference wandb_manager.py:141-183)
via a local JSON tracking file that records each run's wandb id.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

__all__ = ["MetricWriter"]


class MetricWriter:
    """``resume=True`` re-attaches to an existing run instead of starting a
    new E### entry: by ``run_name`` if given, else the latest tracked run
    (the reference's ``resume_id='auto'`` lookup, wandb_manager.py:141-157).
    The wandb sink then resumes the same wandb run id with
    ``resume='allow'`` (wandb_manager.py:160-170); the JSONL sink appends.
    """

    def __init__(self, log_dir: str = "./logs", project: str = "vdn",
                 run_name: Optional[str] = None, use_wandb: bool = False,
                 resume: bool = False):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.project = project
        self._pending_metrics: Dict[str, float] = {}
        self._pending_images: Dict[str, List[str]] = {}
        self._tracking_path = os.path.join(log_dir, "runs.json")
        self._resume_id: Optional[str] = None
        if resume:
            entry = self._find_run(run_name)
            if entry is not None:
                self.run_name = entry["name"]
                self._resume_id = entry.get("wandb_id")
                print(f"[MetricWriter] resuming run '{self.run_name}'"
                      + (f" (wandb id {self._resume_id})"
                         if self._resume_id else ""))
            else:
                print(f"[MetricWriter] no tracked run to resume"
                      f"{' named ' + run_name if run_name else ''}; "
                      "starting a new one")
                self.run_name = run_name or self._next_run_name()
        else:
            self.run_name = run_name or self._next_run_name()
        self._jsonl = open(os.path.join(
            log_dir, f"{self.run_name}.metrics.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb.init(
                    project=project, name=self.run_name,
                    id=self._resume_id, resume="allow")
                if self._wandb is not None:
                    self._record_wandb_id(self._wandb.id)
            except Exception as exc:  # wandb genuinely optional
                print(f"[MetricWriter] wandb unavailable: {exc}")

    def _load_runs(self) -> List[dict]:
        if os.path.exists(self._tracking_path):
            with open(self._tracking_path) as f:
                return json.load(f)
        return []

    def _save_runs(self, runs: List[dict]):
        with open(self._tracking_path, "w") as f:
            json.dump(runs, f)

    def _find_run(self, run_name: Optional[str]) -> Optional[dict]:
        """Tracked entry by name, or the latest one if run_name is None."""
        runs = self._load_runs()
        if run_name is not None:
            for r in runs:
                if r.get("name") == run_name:
                    return r
            return None
        return max(runs, key=lambda r: r.get("num", 0), default=None)

    def _next_run_name(self) -> str:
        """E### numbering (reference wandb_manager.py:96-139)."""
        runs = self._load_runs()
        num = 1 + max([r.get("num", 0) for r in runs], default=0)
        name = f"E{num:03d}"
        runs.append({"num": num, "name": name, "time": time.time()})
        self._save_runs(runs)
        return name

    def _record_wandb_id(self, wandb_id: str):
        """Persist the wandb id so a later resume can re-attach
        (reference wandb_manager.py:172-180)."""
        runs = self._load_runs()
        for r in runs:
            if r.get("name") == self.run_name:
                r["wandb_id"] = wandb_id
                break
        else:
            runs.append({"num": 0, "name": self.run_name,
                         "time": time.time(), "wandb_id": wandb_id})
        self._save_runs(runs)

    def add_metrics(self, metrics: Dict[str, float]):
        self._pending_metrics.update(
            {k: float(v) for k, v in metrics.items()})

    def add_images(self, images: Dict[str, List[str]]):
        for k, paths in images.items():
            self._pending_images.setdefault(k, []).extend(paths or [])

    def send_log(self, step: int):
        record = {"step": step, **self._pending_metrics}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        printable = {k: round(v, 5) for k, v in
                     self._pending_metrics.items()}
        print(f"[{self.run_name} step {step}] {printable}")
        if self._wandb is not None:
            payload = dict(self._pending_metrics)
            try:
                import wandb
                for key, paths in self._pending_images.items():
                    payload[key] = [wandb.Image(p) for p in paths]
            except Exception:
                pass
            self._wandb.log(payload, step=step)
        self._pending_metrics.clear()
        self._pending_images.clear()

    def finish(self):
        self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
