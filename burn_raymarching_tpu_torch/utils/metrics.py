"""Structured training metrics.

The original logs via println! only. This keeps that console
surface (the Trainer prints the same "Step | Loss | k" lines) and adds an
optional JSONL sink for machine-readable run records.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsLogger:
    """Append-only JSONL metrics writer.

    Usage:
        m = MetricsLogger("runs/metrics.jsonl")
        m.log(stage=0, step=100, loss=0.12, smooth_k=8.9, rays_per_s=8.8e6)
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._t0 = time.time()
        if path:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            # truncate previous run
            open(path, "w").close()

    def log(self, **fields):
        if not self.path:
            return
        fields.setdefault("wall_s", round(time.time() - self._t0, 3))
        with open(self.path, "a") as f:
            f.write(json.dumps(fields) + "\n")

    def read(self) -> list[dict]:
        if not self.path or not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]
