#!/usr/bin/env python3
"""The flagship nonstationary model at large N, matrix-free, on one card.

Counterpart of ``examples/quickstart_gibbs_largen.py``: ``GibbsExactGP``
(the Gibbs kernel with a per-point lengthscale field under a frozen
log-normal process prior) trained by ``loss_matrixfree``, with no N×N
matrix, data Gram or prior Gram, ever in memory:
  * the hoists, once per fit: ``prior_pre_matrixfree`` (per-dim
    preconditioner factors and the prior's constant SLQ logdet) and
    ``precond_factor`` (the data Gram's factor, refreshed every
    ``--refresh`` steps: the estimator is unbiased for any fixed SPD P);
  * Adam on the field, the outputscale and the noise, the data term's
    mBCG through K2 and its backward through K3 on the card, the prior's
    quadratic by float64 CG through K12 (plain torch panels on the CPU);
  * the matrix-free loss at the trained pose against the dense MAP loss;
  * ``posterior_matrixfree`` at 96 test points;
  * the serving state (``posterior_state_matrixfree``) and its mean-only
    query, against the one-shot posterior mean.

The data and the probe normals (each step's, the prior's SLQ probes) come
from numpy seeds, ``DATA_SEED`` and ``PROBE_SEED``, and are passed in as
tensors (the JAX example draws its probes from keys inside).

Run: python -m nonstationary_precip_tpu_torch.examples.quickstart_gibbs_largen [--device cpu] [--n N]
(on the card by default; ``--device cpu --n 512`` takes some seconds).
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from nonstationary_precip_tpu_torch.models.gibbs_gp import GibbsExactGP
from nonstationary_precip_tpu_torch.ops import matvec
from nonstationary_precip_tpu_torch.ops.lazy_cg import lazy_cg_diagnostics
from nonstationary_precip_tpu_torch.kernels.gibbs import packed_gibbs_cross
from nonstationary_precip_tpu_torch.priors.lognormal_process import LogNormalProcess
from nonstationary_precip_tpu_torch.utils.config import device

DATA_SEED = 11  # the JAX example's default_rng(11)
PROBE_SEED = 0
N_TEST = 96
NUM_PROBES = 8
SLQ_PROBES = 16  # gram_pre_lazy's default num_probes
ITERS, PRIOR_ITERS = 48, 96  # the data term's and the prior's mBCG budgets


def truth(x: np.ndarray) -> np.ndarray:
    """The noiseless function: amplitude varies across space, so a
    nonstationary lengthscale pays off."""
    return np.sin(2.0 * x[:, 0] * (1.0 + 0.4 * np.tanh(x[:, 1])))


def problem(n: int, seed: int = DATA_SEED):
    """(x (n, 2), y (n,), x_test (96, 2)), float32, x ~ U(−3, 3)²."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, 3, size=(n, 2)).astype(np.float32)
    eps = rng.normal(size=n).astype(np.float32)
    xs = rng.uniform(-3, 3, size=(N_TEST, 2)).astype(np.float32)
    return x, (truth(x) + 0.1 * eps).astype(np.float32), xs


def probe_draws(rng: np.random.Generator, rank: int, n: int, num: int):
    """The standard normal draws (u1 (rank, num), u2 (n, num)) of ``num``
    N(0, P) probes, float32."""
    return (rng.standard_normal((rank, num)).astype(np.float32),
            rng.standard_normal((n, num)).astype(np.float32))


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _t(a, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)


def build_model(x: torch.Tensor) -> GibbsExactGP:
    """The example's prior and model: log-lengthscale mean log 0.5,
    outputscale 1 and lengthscale 1.5 on the prior; noise 0.05, outputscale
    1; the field, the outputscale and the noise train."""
    prior = LogNormalProcess.create(2, mean=float(np.log(0.5)), outputscale=1.0, lengthscale=1.5,
                                    device=x.device)
    model = GibbsExactGP.create(x, prior, noise=0.05, outputscale=1.0, device=x.device)
    return model.trainable(train_noise=True, train_scale=True)


def fit(model, x, y, prior_pre, step_noise, *, refresh: int, rank: int, block: int, lr: float = 1e-2):
    """Adam on ``loss_matrixfree``, one step per entry of ``step_noise``
    (that step's (u1, u2)), the data factor rebuilt every ``refresh`` steps.
    Returns (losses, seconds)."""
    dev = x.device
    opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=lr)
    vals = []
    _sync(dev)
    t0 = time.perf_counter()
    for i, noise in enumerate(step_noise):
        if i % refresh == 0:
            lpc = model.precond_factor(x, rank=rank)
        opt.zero_grad(set_to_none=True)
        val = model.loss_matrixfree(x, y, noise, prior_pre, block=block, max_iters=ITERS, tol=1e-6,
                                    precond_lpc=lpc, prior_max_iters=PRIOR_ITERS)
        val.backward()
        opt.step()
        vals.append(val.detach())
    losses = torch.stack(vals).cpu().numpy()
    return losses, time.perf_counter() - t0


def value_and_grads(loss_fn, model) -> tuple:
    """(value, gradient) of ``loss_fn(model)``, the gradient in the trained
    parameters (the field first), flattened into one float64 vector."""
    params = [model.log_ell] + [p for p in model.parameters() if p.requires_grad and p is not model.log_ell]
    val = loss_fn(model)
    grads = torch.autograd.grad(val, params)
    return float(val.detach()), torch.cat([g.double().reshape(-1) for g in grads])


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(a @ b / (a.norm() * b.norm()))


def run(n: int = 512, steps: int = 12, refresh: int = 4, block: int = 128, rank=None, prior_rank=None,
        dev="cuda", timings: bool = False) -> dict:
    """The whole example at ``n`` points, its probes drawn from
    ``PROBE_SEED``.  Data rank ``rank`` (default min(64, n/4)) and prior
    rank ``prior_rank`` (default min(32, n/4)), as the JAX example.  Returns
    the losses, the checks' numbers (with the matrix-free gradient, the
    field first) and, with ``timings``, the per-part seconds and ms."""
    dev = device(dev) if isinstance(dev, str) else dev
    if dev.type == "cuda":
        matvec.build()  # compile K2/K3 before the timed parts
    rank = rank or min(64, n // 4)
    prior_rank = prior_rank or min(32, n // 4)
    x, y, xs = (_t(a, dev) for a in problem(n))
    rng = np.random.default_rng(PROBE_SEED)
    prior_noise = [tuple(_t(u, dev) for u in probe_draws(rng, prior_rank, n, SLQ_PROBES)) for _ in range(2)]
    step_noise = [tuple(_t(u, dev) for u in probe_draws(rng, rank, n, NUM_PROBES)) for _ in range(steps)]
    model = build_model(x)
    out = {"n": n, "steps": steps, "rank": rank, "prior_rank": prior_rank, "block": block}

    # -- hoists: once per fit, both O(N·rank) --------------------------------
    _sync(dev)
    t0 = time.perf_counter()
    prior_pre = model.prior_pre_matrixfree(x, prior_noise, rank=prior_rank, block=block, max_iters=PRIOR_ITERS,
                                           tol=1e-8)
    _sync(dev)
    out["hoist_seconds"] = time.perf_counter() - t0
    out["prior_logdet"] = prior_pre[1].cpu().numpy()

    # -- stale-preconditioner training ---------------------------------------
    losses, train_s = fit(model, x, y, prior_pre, step_noise, refresh=refresh, rank=rank, block=block)
    out.update(losses=losses, train_seconds=train_s, ms_per_step=1e3 * train_s / len(step_noise))
    print(f"trained {len(losses)} steps matrix-free at N={n} (factor refreshed every {refresh}): "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)

    # -- the matrix-free loss against the dense MAP loss, prior included -----
    lpc = model.precond_factor(x, rank=rank)

    def mf_loss(m):
        return m.loss_matrixfree(x, y, step_noise[0], prior_pre, block=block, max_iters=ITERS, tol=1e-6,
                                 precond_lpc=lpc, prior_max_iters=PRIOR_ITERS)

    mf, g_mf = value_and_grads(mf_loss, model)
    dense, g_dense = value_and_grads(lambda m: m.loss(x, y, prior_chols=None), model)
    field = model.log_ell.numel()
    out.update(loss_mf=mf, loss_dense=dense, loss_rel_diff=abs(mf - dense) / abs(dense), grad_mf=g_mf,
               grad_cosine=_cosine(g_mf, g_dense), field_grad_cosine=_cosine(g_mf[:field], g_dense[:field]))
    with torch.no_grad():
        aug = torch.cat([x, model.log_ell], dim=1)
        out["diag"] = lazy_cg_diagnostics(model.raw_outputscale, aug, y, step_noise[0], model.likelihood.noise,
                                          block=block, max_iters=ITERS, tol=1e-6, precond_lpc=lpc,
                                          cross_fn=packed_gibbs_cross(2),
                                          matvec_builder=matvec.scaled_packed_gibbs_matvec_builder(2))
    print(f"dense MAP loss {dense:.4f} vs matrix-free estimate {mf:.4f}; gradient cosine {out['grad_cosine']:.5f} "
          f"(the field's alone {out['field_grad_cosine']:.3f}); trained-pose relres "
          f"{out['diag']['relres_solve']:.2e}", flush=True)

    # -- predict matrix-free --------------------------------------------------
    _sync(dev)
    t0 = time.perf_counter()
    post = model.posterior_matrixfree(x, y, xs, prior_pre, block=block, max_iters=PRIOR_ITERS, tol=1e-8,
                                      precond_rank=rank)
    _sync(dev)
    out["posterior_seconds"] = time.perf_counter() - t0
    mean, var = post.mean, torch.diagonal(post.cov)
    out["rmse"] = float(torch.sqrt(torch.mean((mean.double() - torch.as_tensor(truth(xs.cpu().numpy()),
                                                                               device=dev)) ** 2)))
    out.update(mean=mean.cpu().numpy(), var=var.cpu().numpy())
    print(f"posterior over {xs.shape[0]} test points: rmse {out['rmse']:.3f}, mean var {float(var.mean()):.4f}",
          flush=True)

    # -- amortized serving: the state once, cheap queries --------------------
    _sync(dev)
    t0 = time.perf_counter()
    state = model.posterior_state_matrixfree(x, y, prior_pre, block=block, max_iters=PRIOR_ITERS, tol=1e-8,
                                             precond_rank=rank)
    _sync(dev)
    out["state_seconds"] = time.perf_counter() - t0
    out["state_alpha_relres"] = float(state[0].alpha_relres)
    mean_fast = model.posterior_matrixfree_from_state(state, xs, mean_only=True, block=block)
    out["drift"] = float(torch.max(torch.abs(mean_fast - mean)))
    print(f"amortized mean-only serving: max |drift| vs one-shot {out['drift']:.2e}", flush=True)
    if timings:
        out.update(_timings(model, x, y, xs, prior_pre, state, step_noise[0], lpc, block))
    out.update(model=model, x=x, y=y, prior_pre=prior_pre, check_noise=step_noise[0], lpc=lpc, state=state)
    return out


def _timings(model, x, y, xs, prior_pre, state, noise, lpc, block, reps: int = 3) -> dict:
    """ms of a whole step against its prior term alone (forward and
    backward), and of a 96-point query batch from the state, mean-only and
    with variance: host clocks around synchronised work, after a warm-up."""
    dev = x.device

    def clock(fn):
        fn()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync(dev)
        return 1e3 * (time.perf_counter() - t0) / reps

    def step():
        model.loss_matrixfree(x, y, noise, prior_pre, block=block, max_iters=ITERS, tol=1e-6, precond_lpc=lpc,
                              prior_max_iters=PRIOR_ITERS).backward()

    def prior_only():
        model.prior.log_prob_matrixfree(x, model.log_ell, prior_pre, block=block, max_iters=PRIOR_ITERS,
                                        tol=1e-6).backward()

    out = {"step_ms": clock(step), "prior_ms": clock(prior_only),
           "query_mean_ms": clock(lambda: model.posterior_matrixfree_from_state(state, xs, mean_only=True,
                                                                                block=block)),
           "query_var_ms": clock(lambda: model.posterior_matrixfree_from_state(state, xs, block=block))}
    model.zero_grad(set_to_none=True)
    out["prior_share"] = out["prior_ms"] / out["step_ms"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--refresh", type=int, default=4)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.n, args.steps, args.refresh, args.block, dev=args.device)
    assert np.all(np.isfinite(out["losses"])), out["losses"]
    assert abs(out["loss_mf"] - out["loss_dense"]) < 0.05 * max(1.0, abs(out["loss_dense"])), out
    assert math.isfinite(out["rmse"])
    assert out["drift"] < 1e-3, out["drift"]
    print("ok")
    return out["rmse"]


if __name__ == "__main__":
    main()
