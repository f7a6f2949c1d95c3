#!/usr/bin/env python3
"""Quickstart 5: large-N exact GP with the iterative BBMM/CG solver.

Counterpart of ``examples/quickstart_cg_largen.py``: modified batched
conjugate gradients and stochastic Lanczos quadrature for the logdet (the
regime the reference trains under ``gpytorch.settings.max_cg_iterations``)
on the dense Gram, end to end on synthetic data:

  1. value parity: ``mll(solver='cg')`` against the exact Cholesky MLL,
  2. training: Adam on the CG objective (the gradient is the trace
     identity from the forward's solves, ``ops/bbmm.cg_mll``: no
     differentiation through the CG iterations),
  3. prediction after the fit, on the CG path too.

The probe draws are made once from a numpy seed and reused every step
(common random numbers: the SLQ noise is frozen into the objective, so the
optimiser sees a smooth surface).  ``precond_rank`` turns on the
pivoted-Cholesky / Woodbury preconditioner, with N(0, P) probes.

Run: python -m nonstationary_precip_tpu_torch.examples.quickstart_cg_largen [--n N] [--num_steps S] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from nonstationary_precip_tpu_torch.kernels.base import Scale
from nonstationary_precip_tpu_torch.kernels.stationary import RBF
from nonstationary_precip_tpu_torch.models.exact_gp import ExactGP
from nonstationary_precip_tpu_torch.train.metrics import rmse_rescaled
from nonstationary_precip_tpu_torch.train.optim import fit
from nonstationary_precip_tpu_torch.utils.config import device

DATA_SEED, PROBE_SEED, RANK = 7, 0, 15


def problem(n: int):
    """(x_tr, y_tr, x_te, y_te) in float64: noisy 2-D bumps, a random 80/20
    split, the JAX example's ``default_rng(7)`` draws."""
    rng = np.random.default_rng(DATA_SEED)
    x = rng.uniform(-3.0, 3.0, size=(n, 2))
    f = np.sin(2.0 * x[:, 0]) * np.cos(x[:, 1]) + 0.5 * x[:, 1]
    y = f + 0.15 * rng.normal(size=n)
    perm = rng.permutation(n)
    tr, te = perm[: int(0.8 * n)], perm[int(0.8 * n):]
    return x[tr], y[tr], x[te], y[te]


def probe_noise(n: int, num: int, dev, rng: np.random.Generator):
    """The standard normal draws (u1 (rank, num), u2 (n, num)) of ``num``
    N(0, P) probes."""
    return tuple(torch.tensor(rng.standard_normal(s), dtype=torch.float32, device=dev) for s in ((RANK, num), (n, num)))


def main(n=2000, num_steps=60, dev="cuda"):
    dev = device(dev)
    x_tr, y_tr, x_te, y_te = (torch.tensor(a, dtype=torch.float32, device=dev) for a in problem(n))
    model = ExactGP.create(Scale.create(RBF.create(2, device=dev), device=dev), noise=0.1, device=dev)
    rng = np.random.default_rng(PROBE_SEED)
    value_probes, train_probes = probe_noise(len(y_tr), 16, dev, rng), probe_noise(len(y_tr), 8, dev, rng)

    # --- 1. the stochastic CG objective sits on top of the exact one -------
    with torch.no_grad():
        mll_cg = float(model.mll(x_tr, y_tr, solver="cg", probe_noise=value_probes, max_iters=200, precond_rank=RANK))
        mll_chol = float(model.mll(x_tr, y_tr))
    print(f"MLL  cholesky {mll_chol:+.4f}   cg/SLQ {mll_cg:+.4f}   "
          f"|Δ| {abs(mll_cg - mll_chol):.4f}  (SLQ probe noise)")

    # --- 2. train on the CG objective (the same fit() as every other model) -
    def loss_cg(m, xx, yy):
        return m.loss(xx, yy, solver="cg", probe_noise=train_probes, max_iters=150, precond_rank=RANK)

    result = fit(model, loss_cg, x_tr, y_tr, lr=0.05, num_steps=num_steps)
    model = result.model
    print(f"trained {num_steps} steps on the CG objective: "
          f"loss {float(result.losses[0]):.4f} -> {float(result.losses[-1]):.4f}")

    # --- 3. predict on the CG path too (deterministic: no probes, one mBCG
    #        over [resid, K_x*] with every right-hand side at once) ----------
    with torch.no_grad():
        pred = model.predictive(x_tr, y_tr, x_te, solver="cg", max_iters=300, precond_rank=RANK)
        pred_chol = model.predictive(x_tr, y_tr, x_te)
        dmean = float(torch.max(torch.abs(pred.mean - pred_chol.mean)))
        rmse = float(rmse_rescaled(pred.mean, y_te, torch.std(y_te, correction=0)))
    print(f"test RMSE {rmse:.3f} (σ units)   CG vs Cholesky predict max|Δmean| {dmean:.1e}")
    assert np.isfinite(rmse)
    assert dmean < 1e-2
    if num_steps >= 60:
        assert rmse < 0.6, "quickstart sanity bound"
    print("ok")
    return rmse


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--num_steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.n, args.num_steps, args.device)
