#!/usr/bin/env python3
"""Matrix-normal prior sampling demo, Kronecker-free.

Counterpart of ``examples/matrix_normal_demo.py`` (the reference's
``__main__`` of its latent priors): the matrix-normal prior on the (N, 2)
latent matrix H of a 30 × 30 grid of [−2, 2]², row covariance the frozen
RBF of lengthscale (0.5, 0.5), column covariance I; one exact draw
H = L_U Z L_Vᵀ and its log-density.  The draw Z comes from the caller, by
default ``np.random.default_rng(173)`` (the JAX demo draws it from a key).
matplotlib is imported only to draw ``matrix_normal_demo.png``; where it
is missing the demo prints its numbers, says that no figure is drawn, and
ends as usual.

Run: python -m nonstationary_precip_tpu_torch.examples.matrix_normal_demo [outdir] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from nonstationary_precip_tpu_torch.examples.mv_gibbs_demo import NUM_GRID, SEED, grid
from nonstationary_precip_tpu_torch.priors.matrix_normal import MatrixNormalPrior, latent_rbf_row_cov
from nonstationary_precip_tpu_torch.utils.config import device
from nonstationary_precip_tpu_torch.utils.plotting import pyplot


def run(dev="cuda", dtype=torch.float32, z=None) -> dict:
    """The draw H (N, 2) and its log-density."""
    dev = device(dev) if isinstance(dev, str) else dev
    gx, gy, xg = grid(-2.0, 2.0)
    if z is None:
        z = np.random.default_rng(SEED).standard_normal((len(xg), 2))
    x = torch.tensor(xg, dtype=dtype, device=dev)
    prior = MatrixNormalPrior(torch.zeros((len(xg), 2), dtype=dtype, device=dev), latent_rbf_row_cov(x, [0.5, 0.5]),
                              torch.eye(2, dtype=dtype, device=dev))
    with torch.no_grad():
        h = prior.sample(torch.as_tensor(z, dtype=dtype, device=dev))
        log_prob = prior.log_prob(h)
    return {"h": h, "log_prob": log_prob, "gx": gx, "gy": gy}


def main(outdir=".", dev="cuda"):
    out = run(dev)
    h = out["h"]
    print("H sample:", tuple(h.shape), "log_prob:", float(out["log_prob"]))
    plt = pyplot("the demo's figure")
    if plt is not None:
        fig, axes = plt.subplots(1, 2, figsize=(9, 4))
        for d in range(2):
            axes[d].contourf(out["gx"], out["gy"], h[:, d].cpu().numpy().reshape(NUM_GRID, NUM_GRID))
            axes[d].set_title(f"H column {d} (smooth latent field)")
        path = Path(outdir) / "matrix_normal_demo.png"
        fig.savefig(path, dpi=130, bbox_inches="tight")
        plt.close(fig)
        print(f"wrote {path}")
    print("ok")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("outdir", nargs="?", default=".")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.outdir, args.device)
