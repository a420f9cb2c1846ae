"""Structured metric sink: one JSON line per ``log`` call
(``frankenstein_tpu/utils/metrics.py``, its JSONL part; the optional wandb
upload is not ported: the port writes nothing outside its run directory)."""

from __future__ import annotations

import json
import time
from pathlib import Path


class MetricLogger:
    """``jsonl_path`` None logs nothing (a rank other than the first)."""

    def __init__(self, jsonl_path):
        self.path = None if jsonl_path is None else Path(jsonl_path)
        self._fh = None
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a", buffering=1)

    def log(self, step: int, metrics: dict):
        if self._fh is None:
            return
        rec = {"step": int(step), "time": time.time(), **metrics}
        self._fh.write(json.dumps(rec) + "\n")

    def close(self):
        if self._fh is not None:
            self._fh.close()
