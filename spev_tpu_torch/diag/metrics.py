"""Structured metrics logging: one JSON line per epoch in
``<log_dir>/metrics.jsonl`` (own copy of ``spev_tpu.diag.metrics``)."""

from __future__ import annotations

import json
import os
import time
from typing import List


def log_metrics(log_dir: str, step: int, metrics: dict) -> None:
    os.makedirs(log_dir, exist_ok=True)
    rec = {"step": int(step), "time": time.time()}
    rec.update({k: float(v) for k, v in metrics.items()})
    with open(os.path.join(log_dir, "metrics.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")


def read_metrics(log_dir: str) -> List[dict]:
    """The records of ``<log_dir>/metrics.jsonl`` in order ([] when there is
    none)."""
    path = os.path.join(log_dir, "metrics.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
