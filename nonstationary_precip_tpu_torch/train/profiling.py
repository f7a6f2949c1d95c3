"""Profiling hooks: ``torch.profiler`` traces and steps/s timing.

Counterpart of ``nonstationary_precip_tpu/train/profiling.py``: ``trace``
profiles a code region into a Chrome trace (viewable in Perfetto or
chrome://tracing), ``StepTimer`` measures steady-state steps/s fenced on the
device, and ``annotate`` names a sub-step in the trace.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(logdir: str = "torch-trace"):
    """Profile a region: ``with trace(dir): run_steps()`` writes
    ``dir/trace.json``; the card's kernels are traced where CUDA is
    available, the host's operations always."""
    from torch.profiler import ProfilerActivity, profile

    path = Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path / "trace.json"))


def _fence(out):
    """Wait for the device work behind ``out``: a CUDA synchronise when
    ``out`` holds a CUDA tensor, nothing on the CPU, whose ops return
    finished."""
    tensors = out if isinstance(out, (tuple, list)) else (out,)
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors):
        torch.cuda.synchronize()


class StepTimer:
    """Steady-state steps/s with warm-up and device fencing.

    >>> timer = StepTimer(warmup=3)
    >>> for _ in range(50):
    ...     out = step(...)
    ...     timer.tick(out)
    >>> timer.stop(out)
    >>> timer.steps_per_sec()
    """

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self._count = 0
        self._t0 = None
        self._elapsed = None

    def tick(self, out=None):
        self._count += 1
        if self._count == self.warmup:
            if out is not None:
                _fence(out)
            self._t0 = time.perf_counter()

    def stop(self, out=None):
        if out is not None:
            _fence(out)
        if self._t0 is not None:
            self._elapsed = time.perf_counter() - self._t0

    def steps_per_sec(self) -> float:
        if self._elapsed is None or self._count <= self.warmup:
            return float("nan")
        return (self._count - self.warmup) / self._elapsed


def annotate(name: str):
    """Named profiler range for a sub-step (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
