"""Training loop: Adam over the parameters that require grad.

Counterpart of ``nonstationary_precip_tpu/train/optim.py::fit``.  The JAX
package compiles fixed-length chunks of steps as one ``lax.scan``; here the
chunk is a Python loop whose per-step losses stay on the device until the
chunk ends, so the host reads them (and applies the NaN guard and the
|Δloss| stop) once per chunk, as the JAX loop does.  Trainability is
``requires_grad`` (the reference's freezing), in place of a mask pytree.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class TrainResult(NamedTuple):
    model: torch.nn.Module
    losses: np.ndarray  # (steps,) or (steps, K) per-step trace
    steps: int
    #: wall time of every step after the first (the warm-up), measured with
    #: CUDA events on the card and the host clock on the CPU
    seconds: float


class _Clock:
    """Elapsed seconds between ``start`` and ``stop`` on ``device``'s own
    timeline: CUDA events on the card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.t0 = self.t1 = None

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self):
        self.t0 = self._mark()

    def stop(self):
        self.t1 = self._mark()

    def seconds(self) -> float:
        if self.t0 is None or self.t1 is None:
            return 0.0
        if self.cuda:
            self.t1.synchronize()
            return self.t0.elapsed_time(self.t1) / 1e3
        return self.t1 - self.t0


def fit(
    model: torch.nn.Module,
    loss_fn: Callable,
    *args,
    lr: float = 0.01,
    num_steps: int = 1000,
    threshold: Optional[float] = None,
    chunk: int = 0,
    has_aux: bool = False,
) -> TrainResult:
    """Adam-optimise ``model`` (in place) under ``loss_fn(model, *args)``.

    Adam has optax's defaults (b1 0.9, b2 0.999, eps 1e-8) and updates only
    parameters with ``requires_grad``.
    threshold: stop when |loss[t] − loss[t−1]| < threshold for any step t
    (for a per-split trace, every split at the same step); checked at chunk
    boundaries, so the model is the one at the end of that chunk.  chunk=0
    runs the whole budget as one chunk, unless ``threshold`` is set, when it
    defaults to min(num_steps, 500).
    The NaN guard stops at the end of a chunk whose trace holds a non-finite
    loss.
    has_aux: loss_fn returns (scalar, trace); the trace (e.g. the per-split
    loss vector) is recorded instead of the scalar.
    """
    params = [p for p in model.parameters() if p.requires_grad]
    if not params:
        raise ValueError("fit: the model has no parameter that requires grad")
    optimizer = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if not chunk:
        chunk = min(num_steps, 500) if threshold is not None else num_steps
    clock = _Clock(params[0].device)
    losses_all = []
    steps_done = 0
    prev_last = None
    while steps_done < num_steps:
        n = min(chunk, num_steps - steps_done)
        trace = []
        for _ in range(n):
            optimizer.zero_grad(set_to_none=True)
            out = loss_fn(model, *args)
            loss, rec = out if has_aux else (out, out)
            loss.backward()
            optimizer.step()
            trace.append(rec.detach())
            if clock.t0 is None:
                clock.start()
        clock.stop()
        losses = torch.stack(trace).cpu().numpy()
        losses_all.append(losses)
        steps_done += n
        if not np.all(np.isfinite(losses)):
            print(f"fit: non-finite loss at step {steps_done}; stopping")
            break
        if threshold is not None:
            seq = losses if prev_last is None else np.concatenate([prev_last[None], losses], axis=0)
            if seq.shape[0] >= 2:
                d = np.abs(np.diff(seq, axis=0)).reshape(seq.shape[0] - 1, -1).max(axis=1)
                if np.any(d < threshold):
                    break
        prev_last = losses[-1]
    losses = np.concatenate(losses_all) if losses_all else np.zeros((0,))
    return TrainResult(model=model, losses=losses, steps=steps_done, seconds=clock.seconds())
