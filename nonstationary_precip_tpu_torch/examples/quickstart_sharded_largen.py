#!/usr/bin/env python3
"""Quickstart: the distributed exact GP, its train Gram split over ranks.

Counterpart of ``examples/quickstart_sharded_largen.py``.
``parallel/sharded_cg.py`` splits the train Gram by rows: each rank builds
only its (N/P, N) block, the CG matvec all-gathers the partial products,
and the backward keeps the gradients O(N²/P) a rank too.

  1. train: Adam on the sharded stochastic MLL with the rank-32
     pivoted-Cholesky preconditioner (the factor is replicated math built
     from the whole x on every rank),
  2. parity: the sharded objective against the one-process dense CG MLL
     (``ops/bbmm.cg_mll``) on the same probe draws and preconditioner rank,
  3. predict: the sharded posterior against the dense Cholesky one.

The stationary default trains an RBF kernel.  ``--gibbs`` takes the option
the JAX docstring names for hardware: the packed Gibbs payload
x_aug = [x, log ℓ] with ``local_matvec_builder=packed_gibbs_local_matvec(2)``,
so each CG product is K2 on the rank's rectangular (N/P, N) block (on the
card; its plain version on the CPU) and the row block never exists in the
forward; the lengthscale field trains through the x gradient.  The probe
draws come from a numpy seed and stay fixed (common random numbers).

By default it runs on every card (one NCCL rank each); ``--device cpu
--world P`` spawns P gloo processes.  Called from a process that already
belongs to a group, it runs on that group (``chip_smoke.py --world 4`` runs
it so on four cards over NCCL, in both forms).

Run: python -m nonstationary_precip_tpu_torch.examples.quickstart_sharded_largen [--gibbs] [--device cpu --world 4]
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from nonstationary_precip_tpu_torch.kernels.base import Scale
from nonstationary_precip_tpu_torch.kernels.gibbs import gibbs_gram_reference, packed_gibbs_cross
from nonstationary_precip_tpu_torch.kernels.stationary import RBF
from nonstationary_precip_tpu_torch.ops.bbmm import cg_mll
from nonstationary_precip_tpu_torch.parallel.launch import run_ranks
from nonstationary_precip_tpu_torch.parallel.mesh import make_mesh
from nonstationary_precip_tpu_torch.parallel.sharded_cg import (
    packed_gibbs_local_matvec,
    sharded_cg_mll,
    sharded_cg_posterior,
)

RANK, PROBES, ITERS, POST_ITERS, N_TEST, S2 = 32, 8, 32, 60, 64, 0.05


def problem(n: int):
    """(x (n, 2), y (n,), x* (64, 2)): the JAX example's noisy bumps."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-3, 3, size=(n, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.15 * rng.normal(size=n)
    return x, y, rng.uniform(-3, 3, size=(N_TEST, 2))


def rank_main(n: int = 2048, num_steps: int = 25, gibbs: bool = False) -> dict:
    """One rank's run, on the group this process belongs to."""
    mesh = make_mesh()
    dev, p = mesh.device, mesh.size
    n -= n % p  # train rows must divide the mesh
    lead = mesh.rank == 0
    f32 = dict(dtype=torch.float32, device=dev)
    x, y, xs = (torch.tensor(a, **f32) for a in problem(n))
    rng = np.random.default_rng(0)
    noise = tuple(torch.tensor(rng.standard_normal(s), **f32) for s in ((RANK, PROBES), (n, PROBES)))
    s2 = torch.tensor(S2, **f32)
    kw = dict(max_iters=ITERS, tol=1e-6, precond_rank=RANK)
    if gibbs:
        cross, builder, kernel = packed_gibbs_cross(2), packed_gibbs_local_matvec(2), None
        log_ell = torch.tensor(np.log(0.8) + 0.1 * rng.standard_normal((n, 2)), requires_grad=True, **f32)
        params = [log_ell]

        def payload():
            return torch.cat([x, log_ell], dim=1)
    else:
        cross, builder = None, None
        kernel = Scale.create(RBF.create(2, **f32), **f32)
        params = list(kernel.parameters())

        def payload():
            return x

    def loss():
        return -sharded_cg_mll(kernel, payload(), y, noise, s2, mesh, cross_fn=cross, local_matvec_builder=builder,
                               **kw)

    # --- 1. train on the sharded objective -----------------------------------
    opt = torch.optim.Adam(params, lr=0.05, betas=(0.9, 0.999), eps=1e-8)
    vals = []
    for _ in range(num_steps):
        opt.zero_grad(set_to_none=True)
        val = loss()
        val.backward()
        opt.step()
        vals.append(float(val.detach()))
    if lead:
        print(f"trained {num_steps} steps on the sharded CG objective ({p} ranks, Gram {n}² row-split"
              f"{', Gibbs payload, K2 local matvec' if gibbs else ''}): loss {vals[0]:.4f} -> {vals[-1]:.4f}")

    # --- 2. sharded against the dense CG MLL (same draws and rank) -----------
    with torch.no_grad():
        aug = payload()
        if gibbs:
            ell = torch.exp(log_ell)
            k_dense = gibbs_gram_reference(x, ell, x, ell)
        else:
            k_dense = kernel(x)
        k_dense = k_dense + s2 * torch.eye(n, **f32)
        dense = float(cg_mll(k_dense, y, noise, s2, **kw))
        sharded = -float(loss())
    dmll = abs(sharded - dense)
    if lead:
        print(f"sharded vs dense CG MLL |Δ| = {dmll:.2e}")
    assert dmll < 1e-2 * max(1.0, abs(dense)), dmll

    # --- 3. sharded posterior against the dense Cholesky one -----------------
    with torch.no_grad():
        if gibbs:  # the test points take the field's mean lengthscale
            xs_aug = torch.cat([xs, log_ell.mean(0).expand(N_TEST, 2)], dim=1)
            ell_s = torch.exp(xs_aug[:, 2:])
            k_sx = gibbs_gram_reference(xs, ell_s, x, torch.exp(log_ell))
        else:
            xs_aug = xs
            k_sx = kernel(xs, x)
        mean, _ = sharded_cg_posterior(kernel, aug, y, xs_aug, s2, mesh, max_iters=POST_ITERS, tol=1e-8,
                                       precond_rank=RANK, cross_fn=cross, local_matvec_builder=builder)
        mean_ref = k_sx @ torch.cholesky_solve(y[:, None], torch.linalg.cholesky(k_dense))[:, 0]
        dmean = float(torch.max(torch.abs(mean - mean_ref)))
    if lead:
        print(f"sharded posterior vs Cholesky max|Δmean| = {dmean:.2e}")
    assert math.isfinite(vals[-1]) and vals[-1] < vals[0]
    assert dmean < 1e-2
    if lead:
        print("ok")
    return {"vals": vals, "dmll": dmll, "dmean": dmean, "world": p, "n": n, "gibbs": gibbs}


def main(world=None, dev="cuda", n: int = 2048, num_steps: int = 25, gibbs: bool = False) -> dict:
    """Rank 0's result: on the caller's group, or on ``world`` spawned ranks
    (default: every card)."""
    return run_ranks("nonstationary_precip_tpu_torch.examples.quickstart_sharded_largen:rank_main", world, dev,
                     (n, num_steps, gibbs))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=None, help="ranks to spawn (default: every card; 1 on the CPU)")
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--num_steps", type=int, default=25)
    ap.add_argument("--gibbs", action="store_true", help="the packed Gibbs payload with K2's local matvec")
    args = ap.parse_args()
    main(args.world, args.device, args.n, args.num_steps, args.gibbs)
