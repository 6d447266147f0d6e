"""Logging: console + optional file (reference utils/logging.py:4-19),
plus a structured jsonl metric stream (counterpart of
lr2ppo_tpu/utils/logging.py); under a mesh rank 0 writes both."""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional


def init_logger(log_path: Optional[str] = None,
                name: str = "lr2ppo_torch",
                main: bool = True) -> logging.Logger:
    """Under a mesh only rank 0 (`main`) logs below WARNING and writes the
    log file."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO if main else logging.WARNING)
    if not main:
        log_path = None
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s",
                            "%Y-%m-%d %H:%M:%S")
    handlers = [logging.StreamHandler(sys.stdout)]
    if log_path:
        os.makedirs(os.path.dirname(os.path.abspath(log_path)) or ".",
                    exist_ok=True)
        handlers.append(logging.FileHandler(log_path))
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    logger.propagate = False
    return logger


class MetricLogger:
    """Appends one JSON object per report to <path>; no-op without path."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                        exist_ok=True)

    def log(self, step: int, **metrics) -> None:
        if not self.path:
            return
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
