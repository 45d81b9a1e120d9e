"""Metrics logging and step timing.

Port of ``givepose_tpu/core/logging_utils.py``.  Reference observability
is a file+stream logger plus TensorBoard scalars per step
(engine/train.py:34,146-154; tools/eval_utils.py:13-24).  Here: a JSONL
metrics stream (machine-readable), mirrored to a text logger, plus
TensorBoard via torch's SummaryWriter when it imports, a wall-clock step
timer, and ``profile_trace``, a torch.profiler trace of a region.
"""

from __future__ import annotations

import json
import logging
import os
import time
from contextlib import contextmanager

import torch


def setup_logger(name: str, log_file: str | None = None) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    # named loggers are process-global: a second run in the same process
    # with a different log path must not keep writing into the first
    # run's file — replace the handlers instead of caching them
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricLogger:
    def __init__(self, out_dir: str, use_tensorboard: bool = True):
        os.makedirs(out_dir, exist_ok=True)
        self.jsonl = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb = SummaryWriter(os.path.join(out_dir, "tb"))
            except Exception:
                self.tb = None

    def log(self, step: int, metrics: dict):
        row = {"step": int(step)}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                continue
        self.jsonl.write(json.dumps(row) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in row.items():
                if k != "step":
                    self.tb.add_scalar(k, v, step)

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


class StepTimer:
    """Rolling step-time / throughput tracker."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._last = None

    def tick(self) -> float | None:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.times.append(dt)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0


@contextmanager
def profile_trace(out_dir: str | None):
    """torch.profiler trace (CPU, and CUDA where present) of the region,
    written to ``out_dir`` as a Chrome trace; nothing when ``out_dir`` is
    empty."""
    if not out_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
