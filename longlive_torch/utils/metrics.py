"""Training metrics: one JSON line per step in ``<logdir>/metrics.jsonl``
(always), and wandb when a real project is named and the package is
installed."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, logdir: str = "logs", wandb_config: Optional[dict] = None,
                 is_main_process: bool = True):
        self.is_main = is_main_process
        self.path = os.path.join(logdir, "metrics.jsonl")
        self._wandb = None
        if self.is_main:
            os.makedirs(logdir, exist_ok=True)
            if wandb_config:
                try:
                    import wandb
                except ImportError:
                    print("[longlive_torch] WARNING: wandb is not installed; metrics go to "
                          f"{self.path} only", file=sys.stderr)
                else:
                    wandb.init(**wandb_config)
                    self._wandb = wandb

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        if not self.is_main:
            return
        row = dict(metrics)
        row["ts"] = time.time()
        if step is not None:
            row["step"] = step
        with open(self.path, "a") as f:
            f.write(json.dumps(row, default=float) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
