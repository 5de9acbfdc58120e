"""Training metrics log (counterpart of the JAX package's
``utils/logging.py``): one JSON record a line in
``<log_dir>/<name>_metrics.jsonl`` and a console line on stderr, with the
JAX package's record layout. There is no TensorBoard writer."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None, *, name: str = "train",
                 console_every: int = 1):
        self.console_every = console_every
        self._file = None
        self._n = 0
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, f"{name}_metrics.jsonl"), "a",
                              buffering=1)

    def log(self, step: int, metrics: Dict[str, Any], *, prefix: str = "") -> None:
        record = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                record[prefix + k] = float(v)
            except (TypeError, ValueError):
                record[prefix + k] = v
        if self._file:
            self._file.write(json.dumps(record) + "\n")
        self._n += 1
        if self._n % self.console_every == 0:
            msg = " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in record.items() if k != "time")
            print(f"[{prefix or 'train'}] {msg}", file=sys.stderr)

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
