"""Structured metrics logging: one JSON line per epoch in
``<log_dir>/metrics.jsonl`` (own copy of ``spev_tpu.diag.metrics``)."""

from __future__ import annotations

import json
import os
import time


def log_metrics(log_dir: str, step: int, metrics: dict) -> None:
    os.makedirs(log_dir, exist_ok=True)
    rec = {"step": int(step), "time": time.time()}
    rec.update({k: float(v) for k, v in metrics.items()})
    with open(os.path.join(log_dir, "metrics.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")
