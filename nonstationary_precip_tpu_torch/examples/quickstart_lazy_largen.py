#!/usr/bin/env python3
"""Quickstart 7: matrix-free exact GP, the Gram never in memory.

Counterpart of ``examples/quickstart_lazy_largen.py``: ``ops/lazy_cg.py``'s
mBCG matvec never builds the N × N Gram, and its backward rebuilds (block,
N) row panels to pull the rank-(1 + R) cotangent through them: memory
O(block·N) where the dense path's is O(N²) (GPyTorch's
LazyTensor/LinearOperator regime).

  1. train: Adam on the matrix-free stochastic MLL,
     ``ExactGP.mll(solver='cg', block=...)``,
  2. parity: the matrix-free objective against the dense CG path on the same
     probes (the same estimator, merely partitioned),
  3. predict: the matrix-free posterior against the dense Cholesky one.

The matvec is ``ops/matvec.stationary_matvec_builder``: on the card K6, the
fused RBF Gram·V, so not even a row panel is built in the forward, as
``experiments/exact_largen.lazy`` runs it; the JAX example keeps XLA's
panels for RBF on the TPU.  The probes (Rademacher, fixed across steps:
common random numbers) come from a numpy seed.

Run: python -m nonstationary_precip_tpu_torch.examples.quickstart_lazy_largen [--n N] [--num_steps S]
       [--block B] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from nonstationary_precip_tpu_torch.kernels.base import Scale
from nonstationary_precip_tpu_torch.kernels.stationary import RBF
from nonstationary_precip_tpu_torch.models.exact_gp import ExactGP
from nonstationary_precip_tpu_torch.ops.bbmm import cg_mll
from nonstationary_precip_tpu_torch.ops.matvec import stationary_matvec_builder
from nonstationary_precip_tpu_torch.train.optim import fit
from nonstationary_precip_tpu_torch.utils.config import device

DATA_SEED, PROBE_SEED, NUM_PROBES, ITERS = 3, 0, 8, 100


def problem(n: int, dev):
    """(x (n, 2), y (n,), xs (64, 2)) in float32, the JAX example's
    ``default_rng(3)`` draws."""
    rng = np.random.default_rng(DATA_SEED)
    f32 = dict(dtype=torch.float32, device=dev)
    x = torch.tensor(rng.uniform(-3, 3, size=(n, 2)), **f32)
    y = torch.sin(2 * x[:, 0]) * torch.cos(x[:, 1]) + 0.15 * torch.tensor(rng.normal(size=n), **f32)
    return x, y, torch.tensor(rng.uniform(-3, 3, size=(64, 2)), **f32)


def main(n=2048, num_steps=25, block=512, dev="cuda"):
    dev = device(dev)
    n -= n % block if n > block else 0
    x, y, xs = problem(n, dev)
    model = ExactGP.create(Scale.create(RBF.create(2, device=dev), device=dev), noise=0.05, mean_type="zero",
                           device=dev)
    probes = torch.tensor(np.random.default_rng(PROBE_SEED).choice([-1.0, 1.0], size=(n, NUM_PROBES)),
                          dtype=torch.float32, device=dev)

    # --- 1. train on the matrix-free objective -----------------------------
    def loss(m):
        return -m.mll(x, y, solver="cg", probe_noise=probes, block=block, max_iters=ITERS,
                      matvec_builder=stationary_matvec_builder)

    res = fit(model, loss, lr=0.05, num_steps=num_steps)
    model, vals = res.model, res.losses
    print(f"trained {num_steps} steps matrix-free (N={n}, {block}-row panels, Gram never built): "
          f"loss {float(vals[0]):.4f} -> {float(vals[-1]):.4f}")

    with torch.no_grad():
        # --- 2. matrix-free == dense CG (the same probes) ------------------
        s2 = model.likelihood.noise
        k_dense = model.kernel(x) + s2 * torch.eye(n, dtype=torch.float32, device=dev)
        dense = float(cg_mll(k_dense, y, probes, s2, max_iters=ITERS, tol=1e-6) / n)
        lazy = float(-loss(model))
        dmll = abs(lazy - dense)
        print(f"lazy loss matches dense CG MLL |Δ| = {dmll:.2e}")
        assert dmll < 1e-2 * max(1.0, abs(dense)), dmll  # f32 end-to-end parity

        # --- 3. matrix-free posterior against the dense Cholesky one -------
        post = model.posterior(x, y, xs, solver="cg", block=block, tol=1e-8, matvec_builder=stationary_matvec_builder)
        chol = torch.linalg.cholesky(k_dense)
        mean_ref = model.kernel(xs, x) @ torch.cholesky_solve(y[:, None], chol)[:, 0]
        dmean = float(torch.max(torch.abs(post.mean - mean_ref)))
    print(f"lazy posterior vs Cholesky max|Δmean| = {dmean:.2e}")
    assert np.isfinite(float(vals[-1])) and float(vals[-1]) < float(vals[0])
    assert dmean < 1e-2
    print("ok")
    return dmean


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--num_steps", type=int, default=25)
    ap.add_argument("--block", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.n, args.num_steps, args.block, args.device)
