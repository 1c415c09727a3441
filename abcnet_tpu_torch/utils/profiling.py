"""Tracing and throughput helpers, counterpart of
abcnet_tpu/utils/profiling.py:

  * `trace(dir)`: a context manager around torch.profiler that writes a
    chrome trace (the device timeline of CPU ops and CUDA kernels) to
    `dir/trace.json` and returns the profiler for `key_averages()`;
  * `StepTimer`: rolling images/s and step latency, read at log points.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """with trace('/tmp/trace') as prof: ...steps... -> log_dir/trace.json
    (chrome://tracing or Perfetto). CUDA activity is traced when a GPU is
    present."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling throughput meter.

    mark() after each step; read images_per_sec()/ms_per_step() at log
    points. Uses a window so LR drops and warm-up stalls age out. A step
    that ends in asynchronous device work is only timed right once the
    caller has waited for it (the trainer's log points fetch a value)."""

    def __init__(self, batch_size: int, window: int = 100):
        self.batch_size = batch_size
        self._times: deque = deque(maxlen=window + 1)

    def mark(self) -> None:
        self._times.append(time.perf_counter())

    def ms_per_step(self) -> Optional[float]:
        if len(self._times) < 2:
            return None
        span = self._times[-1] - self._times[0]
        return 1000.0 * span / (len(self._times) - 1)

    def images_per_sec(self) -> Optional[float]:
        ms = self.ms_per_step()
        return None if ms is None else 1000.0 * self.batch_size / ms
