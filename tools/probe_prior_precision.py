#!/usr/bin/env python3
"""Probe the precision the matrix-free prior's solves need (ROADMAP §3, F6).

Trains the port's matrix-free Gibbs quickstart at N = 16384 on the card (20
steps, data rank 150, prior rank 50, block 2048), then solves each prior
dim's conditioning system (K_d + 1e-4 I) α = log ℓ − μ by the preconditioned
mBCG of ``conditional_pre_matrixfree`` in float32 (the JAX package's
precision, with Woodbury shifts 1, 10, 100 and 1000) and in float64 (the
port's ``SOLVE_DTYPE``), at 64, 96 and 256 iterations, and compares each
with the float64 dense solution: the final relative residuals, the largest
error of the log-lengthscales at the 96 test points, and the quadratic
(log ℓ − μ)ᵀα against the dense one.  One JSON line per case, after the
card's name and power limit.

Run: python tools/probe_prior_precision.py  (one H100, ~3 minutes)
"""

import json
import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from nonstationary_precip_tpu_torch.examples import quickstart_gibbs_largen as quickstart  # noqa: E402
from nonstationary_precip_tpu_torch.ops.bbmm import mbcg, woodbury_precond  # noqa: E402
from nonstationary_precip_tpu_torch.ops.lazy_cg import _lazy_matvec, lazy_pivoted_cholesky  # noqa: E402
from nonstationary_precip_tpu_torch.priors.lognormal_process import _COND_JITTER, _dim_cross  # noqa: E402

N, BLOCK, PRIOR_RANK = 16384, 2048, 50


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_prior_precision: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    out = quickstart.run(n=N, steps=20, refresh=4, block=BLOCK, rank=150, prior_rank=PRIOR_RANK, dev="cuda")
    model = out["model"]
    x, _, xs = (torch.tensor(a, device=dev) for a in quickstart.problem(N))
    ell = torch.exp(model.log_ell.detach()).double()
    x64, xs64 = x.double(), xs.double()
    prior = model.prior.double()
    with torch.no_grad():
        ell2_dense = prior.conditional_mean(xs64, (x64, ell))
        resid = torch.log(ell).mT - prior.mean(x64).mT  # (D, N)
        eye = torch.eye(N, dtype=torch.float64, device=dev)
        alpha_dense = []
        for d, gram in enumerate(prior._gram(x64)):  # one dim at a time: 2 GB each
            chol = torch.linalg.cholesky(gram + _COND_JITTER * eye)
            alpha_dense.append(torch.cholesky_solve(resid[d][:, None], chol)[:, 0])
            del chol
        quad_dense = torch.sum(resid * torch.stack(alpha_dense), dim=-1)
    print(json.dumps({"case": "dense_f64", "quad": quad_dense.tolist(), "ell2_range": [float(ell2_dense.min()),
                                                                                      float(ell2_dense.max())]}),
          flush=True)
    for dtype, shifts in ((torch.float32, (1.0, 10.0, 100.0, 1000.0)), (torch.float64, (1.0,))):
        params = prior._dim_params(dtype)
        xd = x.to(dtype)
        lpcs = [lazy_pivoted_cholesky(p, xd, PRIOR_RANK, cross_fn=_dim_cross) for p in params]
        jitter = torch.tensor(_COND_JITTER, dtype=dtype, device=dev)
        for shift in shifts:
            for iters in (64, 96, 256):
                alphas, relres = [], []
                with torch.no_grad():
                    for d, p in enumerate(params):
                        res = mbcg(_lazy_matvec(p, xd, jitter, BLOCK, _dim_cross), resid[d].to(dtype)[:, None],
                                   max_iters=iters, tol=1e-8, precond=woodbury_precond(lpcs[d], shift * jitter))
                        alphas.append(res.x[:, 0].double())
                        relres.append(float(res.residnorm[0]))
                    ell2 = prior.conditional_mean_from_pre(xs64, (x64, None), torch.stack(alphas), block=BLOCK)
                err = (torch.log(ell2) - torch.log(ell2_dense)).abs().max()
                quad = torch.sum(resid * torch.stack(alphas), dim=-1)
                print(json.dumps({"dtype": str(dtype).split(".")[-1], "shift": shift, "iters": iters,
                                  "relres": relres, "log_ell2_err": float(err),
                                  "quad_rel_err": ((quad - quad_dense).abs() / quad_dense.abs()).tolist()}),
                      flush=True)


if __name__ == "__main__":
    main()
