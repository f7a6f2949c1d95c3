"""Training loops: Adam over the parameters that require grad.

Counterpart of ``nonstationary_precip_tpu/train/optim.py``: ``fit``, the
host-driven ``fit_chunked`` over a ``ChunkedMAPLoss`` and the
epoch-shuffled minibatch fits of the DSVI models (``fit_minibatched``,
``fit_minibatched_splits``).  The JAX package compiles fixed-length chunks
of steps as one ``lax.scan``; here the chunk is a Python loop whose
per-step losses stay on the device until the chunk ends, so the host reads
them (and applies the NaN guard and the |Δloss| stop) once per chunk, as
the JAX loop does.  Trainability is ``requires_grad`` (the reference's
freezing), in place of a mask pytree.  Adam has optax's defaults (b1 0.9,
b2 0.999, eps 1e-8).
"""

from __future__ import annotations

import copy
import time
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch


class TrainResult(NamedTuple):
    model: torch.nn.Module
    losses: np.ndarray  # (steps,) or (steps, K) per-step trace
    steps: int
    #: wall time of every step after the first (the warm-up), measured with
    #: CUDA events on the card and the host clock on the CPU
    seconds: float
    #: chunks retried at a halved lr (``fit``'s ``lr_backoff``)
    backoffs: int = 0
    #: steps run in those chunks before each was thrown away; ``seconds``
    #: covers them too
    retried_steps: int = 0
    #: each step's worst solve relres and MLL mBCG iterations
    #: (``fit_chunked``'s evidence), else None
    relres: Optional[np.ndarray] = None
    iters: Optional[np.ndarray] = None


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
    lr_backoff: int = 0,
    log_every: int = 0,
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
    lr_backoff: divergence recovery, the JAX package's.  When a chunk's
    trace holds a non-finite loss and backoffs remain, the parameters and
    the Adam state go back to the chunk-start snapshot, the lr to half the
    snapshot's, and the chunk runs again, at most ``lr_backoff`` times in
    all.  The snapshot keeps its own lr, so a second failure in the same
    chunk retries at the same halved lr, as the JAX loop does.  chunk=0
    then defaults to min(num_steps, 500).  Off (0) the loop is the plain one.
    log_every: print the loss at the first chunk boundary past each multiple
    of ``log_every`` steps, and at the end (0: silent).
    """
    params = [p for p in model.parameters() if p.requires_grad]
    if not params:
        raise ValueError("fit: the model has no parameter that requires grad")
    optimizer = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if not chunk:
        chunk = min(num_steps, 500) if (threshold is not None or lr_backoff) else num_steps
    clock = _Clock(params[0].device)
    losses_all = []
    steps_done = 0
    prev_last = None
    backoffs_left = lr_backoff
    retried_steps = 0
    snapshot = _snapshot(params, optimizer) if lr_backoff else None
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
        # any step: a mid-chunk inf that recovers already contaminated Adam
        if not np.all(np.isfinite(losses)) and backoffs_left > 0:
            backoffs_left -= 1
            retried_steps += n
            new_lr = _restore(params, optimizer, snapshot) * 0.5
            for group in optimizer.param_groups:
                group["lr"] = new_lr
            prev_last = None
            print(f"fit: non-finite loss in steps {steps_done}..{steps_done + n}; restored step-{steps_done} "
                  f"state, lr -> {new_lr:g} ({backoffs_left} backoffs left)")
            continue
        losses_all.append(losses)
        steps_done += n
        if not np.all(np.isfinite(losses)):
            print(f"fit: non-finite loss at step {steps_done}; stopping")
            break
        if lr_backoff:
            snapshot = _snapshot(params, optimizer)
        every = max(log_every, 1)
        if log_every and (steps_done // every > (steps_done - n) // every or steps_done == num_steps):
            print(f"step {steps_done}/{num_steps}  loss {float(np.sum(losses[-1])):.4f}")
        if threshold is not None:
            seq = losses if prev_last is None else np.concatenate([prev_last[None], losses], axis=0)
            if seq.shape[0] >= 2:
                d = np.abs(np.diff(seq, axis=0)).reshape(seq.shape[0] - 1, -1).max(axis=1)
                if np.any(d < threshold):
                    break
        prev_last = losses[-1]
    losses = np.concatenate(losses_all) if losses_all else np.zeros((0,))
    return TrainResult(model=model, losses=losses, steps=steps_done, seconds=clock.seconds(),
                       backoffs=lr_backoff - backoffs_left, retried_steps=retried_steps)


#: the JAX package's name for ``fit_chunked``'s result
ChunkedTrainResult = TrainResult


def fit_chunked(model: torch.nn.Module, loss, x, y, prior_pre=None, *, probe_noise, num_steps: int,
                lr: float = 0.01, threshold: Optional[float] = None, nan_guard: bool = True, log_every: int = 0,
                callback: Optional[Callable] = None) -> TrainResult:
    """Adam (``torch.optim.Adam``, optax's defaults) over a host-chunked MAP
    loss (``models.gibbs_gp.ChunkedMAPLoss``), the JAX package's
    ``fit_chunked`` (:200-306): every step reads its loss and relres on the
    host.  The parameters that require grad train (the JAX mask: pass
    ``model.trainable(...)`` first); ``threshold`` stops at the first
    |Δloss| below it; ``nan_guard`` stops at a non-finite loss and puts back
    the last parameters whose loss was finite; ``callback(step, model,
    losses)`` runs after every step (pair it with
    ``train.checkpoint.BestCheckpointer``).  ``probe_noise``: the same draws
    every step (common random numbers, the JAX default).  ``relres`` is
    each step's worst solve residual: gate on it; ``iters`` each step's MLL
    mBCG iterations; ``seconds`` as :func:`fit`'s, from the end of the
    first step.

    A loop of its own, as in the JAX package: a step's loss is read before
    its update, so a non-finite one rolls the model back a step, where
    :func:`fit` checks a chunk's losses after its updates.  There is no lr
    back-off, as in JAX's ``fit_chunked``."""
    params = [(name, p) for name, p in model.named_parameters() if p.requires_grad]
    if not params:
        raise ValueError("fit_chunked: the model has no parameter that requires grad")
    optimizer = torch.optim.Adam([p for _, p in params], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    clock = _Clock(params[0][1].device)
    losses, relres_hist, iters = [], [], []
    prev, finite = None, None
    for i in range(num_steps):
        val, grads, info = loss.value_and_grad(model, x, y, prior_pre, probe_noise)
        f, rr = float(val), float(info["relres_max"])
        if nan_guard and not np.isfinite(f):
            if finite is not None:
                with torch.no_grad():
                    for (_, p), v in zip(params, finite):
                        p.copy_(v)
            print(f"fit_chunked: non-finite loss at step {i}; stopping (returning the last finite-loss model)")
            break
        finite = [p.detach().clone() for _, p in params]
        for name, p in params:
            p.grad = grads[name]
        optimizer.step()
        losses.append(f)
        relres_hist.append(rr)
        iters.append(int(info["iters"]))
        if clock.t0 is None:
            clock.start()
        clock.stop()
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i + 1}/{num_steps}  loss {f:.6f}  relres {rr:.2e}", flush=True)
        if callback is not None:
            callback(i + 1, model, np.asarray(losses))
        if threshold is not None and prev is not None and abs(f - prev) < threshold:
            break
        prev = f
    return TrainResult(model=model, losses=np.asarray(losses), steps=len(losses), seconds=clock.seconds(),
                       relres=np.asarray(relres_hist), iters=np.asarray(iters, dtype=np.int64))


def _snapshot(params, optimizer) -> tuple:
    """Copies of the parameters and of the Adam state (its lr included)."""
    state = copy.deepcopy(optimizer.state_dict())
    return [p.detach().clone() for p in params], state


def _restore(params, optimizer, snapshot) -> float:
    """Put the parameters and the Adam state back to ``snapshot``; returns
    the snapshot's lr."""
    values, state = snapshot
    with torch.no_grad():
        for p, v in zip(params, values):
            p.copy_(v)
    optimizer.load_state_dict(copy.deepcopy(state))
    return optimizer.param_groups[0]["lr"]


def _epoch_schedule(seed: int, n: int, num_epochs: int, batch_size: int) -> np.ndarray:
    """Epoch-shuffled batch-index schedule, (T, B): per-epoch permutations,
    wrap-around padded so every step has a full batch (DataLoader(shuffle=
    True) in the reference's DSVI loop).  Bit-identical to the JAX
    package's: the same ``np.random.default_rng(seed)`` draws."""
    batch_size = min(batch_size, n)  # a batch never exceeds the dataset
    steps_per_epoch = n // batch_size if n % batch_size == 0 else n // batch_size + 1
    rng = np.random.default_rng(seed)
    sched = []
    for _ in range(num_epochs):
        perm = rng.permutation(n)
        pad = (-len(perm)) % (steps_per_epoch * batch_size)
        if pad:
            perm = np.concatenate([perm, perm[:pad]])
        sched.append(perm.reshape(steps_per_epoch, batch_size))
    return np.concatenate(sched, axis=0)


def num_minibatch_steps(n: int, num_epochs: int, batch_size: int) -> int:
    """Steps of ``_epoch_schedule(·, n, num_epochs, batch_size)``."""
    batch_size = min(batch_size, n)
    return num_epochs * -(-n // batch_size)


def _minibatch_loop(model, loss_fn, x, y, batch_idx, eps, lr, gather) -> tuple:
    """Adam over ``batch_idx``'s T steps: step t feeds ``loss_fn(model,
    eps_t, x_b, y_b)`` the t-th slice of every ε tensor and the gathered
    batch, and sums what it returns.  Returns (losses (T, ...) numpy,
    seconds after the first step)."""
    params = [p for p in model.parameters() if p.requires_grad]
    optimizer = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    clock = _Clock(params[0].device)
    trace = []
    for t in range(batch_idx.shape[0]):
        idx = batch_idx[t]
        optimizer.zero_grad(set_to_none=True)
        per = loss_fn(model, tuple(e[t] for e in eps), gather(x, idx), gather(y, idx))
        torch.sum(per).backward()
        optimizer.step()
        trace.append(per.detach())
        if t == 0:
            clock.start()
    clock.stop()
    return torch.stack(trace).cpu().numpy(), clock.seconds()


def _check_eps(eps, total_steps: int):
    if any(e.shape[0] < total_steps for e in eps):
        raise ValueError(f"ε covers {min(e.shape[0] for e in eps)} steps; the schedule has {total_steps}")


def fit_minibatched(model, loss_fn: Callable, x, y, eps, *, num_epochs: int, batch_size: int,
                    lr: float = 0.01, seed: int = 0) -> TrainResult:
    """Epoch-shuffled minibatch Adam (the reference's DSVI loop), trained in
    place.  ``eps`` is a sequence of per-step noise tensors (T, ...), one
    per hidden layer; ``loss_fn(model, eps_t, x_b, y_b)`` returns the loss."""
    n = x.shape[0]
    batch_idx = torch.as_tensor(_epoch_schedule(seed, n, num_epochs, batch_size), device=x.device)
    _check_eps(eps, batch_idx.shape[0])
    losses, seconds = _minibatch_loop(model, loss_fn, x, y, batch_idx, eps, lr, lambda a, i: a[i])
    # the whole schedule runs without a host read, so this is post hoc: a
    # non-finite ELBO trace is reported loudly, and stops nothing
    if not np.isfinite(losses).all():
        first_bad = int(np.argmax(~np.isfinite(losses)))
        print(f"fit_minibatched: NON-FINITE loss from step {first_bad}/{len(losses)} "
              f"— model state is unreliable; reduce lr or batch size", flush=True)
    return TrainResult(model=model, losses=losses, steps=len(losses), seconds=seconds)


def fit_minibatched_splits(models: Sequence[torch.nn.Module], loss_fn: Callable, xs, ys, eps, *,
                           num_epochs: int, batch_size: int, lr: float = 0.01,
                           seeds: Optional[Sequence[int]] = None) -> TrainResult:
    """K ``fit_minibatched`` runs in lockstep on one stacked model: the same
    per-split schedules, so the same trajectories (the gradient of the
    summed loss is each split's own, and Adam is elementwise).

    ``xs``/``ys``: K per-split tensors (identical shapes); ``eps``: K
    per-split sequences of per-step noise tensors (T, ...), stacked here to
    (T, K, ...); ``seeds``: K schedule seeds (default range(K));
    ``loss_fn(stacked_model, eps_t, x_b, y_b)`` returns the (K,) losses.
    Returns the stacked model and the (T, K) loss trace."""
    from nonstationary_precip_tpu_torch.train.vmapped import stack_modules

    k = len(models)
    seeds = list(range(k)) if seeds is None else list(seeds)
    x_stk, y_stk = torch.stack(list(xs)), torch.stack(list(ys))
    n = x_stk.shape[1]
    batch_idx = torch.as_tensor(
        np.stack([_epoch_schedule(s, n, num_epochs, batch_size) for s in seeds], axis=1),
        device=x_stk.device)  # (T, K, B)
    eps_stk = tuple(torch.stack(list(per_layer), dim=1) for per_layer in zip(*eps))
    _check_eps(eps_stk, batch_idx.shape[0])
    rows = torch.arange(k, device=x_stk.device)[:, None]
    stacked = stack_modules(models)
    losses, seconds = _minibatch_loop(stacked, loss_fn, x_stk, y_stk, batch_idx, eps_stk, lr,
                                      lambda a, i: a[rows, i])
    if not np.isfinite(losses).all():  # any step: a mid-trace inf already
        # contaminated that split's Adam moments
        bad = np.where(~np.isfinite(losses).all(axis=0))[0]
        print(f"fit_minibatched_splits: NON-FINITE loss in splits {bad.tolist()} "
              f"— those models are unreliable; reduce lr or batch size", flush=True)
    return TrainResult(model=stacked, losses=losses, steps=len(losses), seconds=seconds)
