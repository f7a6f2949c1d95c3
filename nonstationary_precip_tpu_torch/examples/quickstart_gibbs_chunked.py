#!/usr/bin/env python3
"""Training through the host-chunked phases: the large-N product surface.

Counterpart of ``examples/quickstart_gibbs_chunked.py``.  The JAX package
splits a training step into host-driven device programs so that none
outlives its TPU's execution wall; the port keeps the same surface as thin
entries over its eager loop, where the chunks buy an early stop:
  * ``models.gibbs_gp.make_chunked_map_loss``: the MAP estimand of
    ``GibbsExactGP.loss_matrixfree`` (the matrix-free MLL and the frozen
    prior's term) as phases: the preconditioner factor, mBCG chunks of
    ``chunk_iters`` iterations (K2 on the card), the backward sweep (K3),
    the prior's per-dim solves;
  * ``train.optim.fit_chunked``: Adam on the host over that loss, with each
    step's relres kept as evidence;
  * ``posterior_state_matrixfree(chunk_iters=...)``: the serving state by a
    chunked α solve; a mean-only query then needs no solve.

The same configuration through the CLI, with the JAX package's flagship
preconditioner (Nyström rank 1024, shift 10):

    python -m nonstationary_precip_tpu_torch serve --model gibbs_exact --matrixfree true --chunked true \\
        --precond_rank 1024 --precond nystrom --precond_shift 10 --train_csv big.csv

The data and every probe normal come from numpy seeds and are passed in.

Run: python -m nonstationary_precip_tpu_torch.examples.quickstart_gibbs_chunked [--device cpu] [--n N]
(on the card by default; ``--device cpu`` at its N = 384 takes some seconds).
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from nonstationary_precip_tpu_torch.examples.quickstart_gibbs_largen import truth
from nonstationary_precip_tpu_torch.models.gibbs_gp import GibbsExactGP, make_chunked_map_loss
from nonstationary_precip_tpu_torch.priors.lognormal_process import LogNormalProcess
from nonstationary_precip_tpu_torch.train.optim import fit_chunked
from nonstationary_precip_tpu_torch.utils.config import device

DATA_SEED, PROBE_SEED = 11, 0
N_TEST, NUM_PROBES, SLQ_PROBES = 64, 8, 16


def problem(n: int):
    """(x (n, 2), y (n,), x_test (64, 2)) in float64, the JAX example's
    ``default_rng(11)`` draws: x ~ U(−3, 3)², y the truth plus 0.1·ε."""
    rng = np.random.default_rng(DATA_SEED)
    x = rng.uniform(-3, 3, size=(n, 2))
    y = truth(x) + 0.1 * rng.normal(size=n)
    return x, y, rng.uniform(-3, 3, size=(N_TEST, 2))


def build_model(x: torch.Tensor) -> GibbsExactGP:
    """The example's prior and model at x's dtype and device, the field,
    the outputscale and the noise trainable."""
    prior = LogNormalProcess.create(2, mean=math.log(0.5), outputscale=1.0, lengthscale=1.5, dtype=x.dtype,
                                    device=x.device)
    model = GibbsExactGP.create(x, prior, noise=0.05, outputscale=1.0, dtype=x.dtype, device=x.device)
    return model.trainable(train_noise=True, train_scale=True)


def run(n: int = 384, steps: int = 10, block: int = 128, dev="cuda") -> dict:
    """The JAX example's flow: the prior's hoist, ``steps`` chunked Adam
    steps, the chunked serving state and a mean-only query.  Returns the
    losses, the relres evidence and the query's RMSE against the truth."""
    dev = device(dev)
    x, y, xs = problem(n)
    x_t, y_t, xs_t = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (x, y, xs))
    model = build_model(x_t)
    draws = np.random.default_rng(PROBE_SEED)
    prior_rank, rank = min(32, n // 4), min(64, n // 4)

    def normal(*shape):
        return torch.tensor(draws.standard_normal(shape), dtype=torch.float32, device=dev)

    # the frozen prior's hoist, once per fit (O(N·rank))
    prior_pre = model.prior_pre_matrixfree(x_t, [(normal(prior_rank, SLQ_PROBES), normal(n, SLQ_PROBES))
                                                 for _ in range(2)], rank=prior_rank, block=block, max_iters=96,
                                           tol=1e-8)
    loss = make_chunked_map_loss(2, block=block, chunk_iters=8, n_chunks=4, tol=1e-6, precond_rank=rank,
                                 precond="pivchol", precond_shift=1.0, prior_chunk_iters=16, prior_n_chunks=8)
    res = fit_chunked(model, loss, x_t, y_t, prior_pre, probe_noise=(normal(rank, NUM_PROBES), normal(n, NUM_PROBES)),
                      num_steps=steps, lr=2e-2, log_every=5)
    print(f"chunked fit at N={n}: loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f} over {res.steps} steps, "
          f"worst relres {res.relres.max():.2e}")
    # the serving state by a chunked α solve; mean-only queries need no solve
    state = model.posterior_state_matrixfree(x_t, y_t, prior_pre, block=block, tol=1e-8, precond_rank=rank,
                                             chunk_iters=8, n_chunks=16)
    mean, info = model.posterior_matrixfree_from_state(state, xs_t, mean_only=True, block=block, chunk_iters=8,
                                                       n_chunks=16, return_info=True)
    rmse = float(np.sqrt(np.mean((mean.double().cpu().numpy() - truth(xs)) ** 2)))
    print(f"state alpha solve relres {float(state[0].alpha_relres):.2e}; mean-only serving over {N_TEST} points: "
          f"rmse {rmse:.3f} (relres evidence {float(info['relres_max']):.2e})")
    return {"losses": res.losses, "relres": res.relres, "alpha_relres": float(state[0].alpha_relres), "rmse": rmse}


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=384)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.n, args.steps, args.block, args.device)
    assert np.all(np.isfinite(out["losses"])) and out["losses"][-1] < out["losses"][0]
    assert out["relres"].max() < 1e-2  # every step's solves converged
    assert np.isfinite(out["rmse"]) and out["rmse"] < 1.0
    print("ok")
    return out["rmse"]


if __name__ == "__main__":
    main()
