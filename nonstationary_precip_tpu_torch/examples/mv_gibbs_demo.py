#!/usr/bin/env python3
"""Multivariate-Gibbs kernel demo: the Gram on a 2-D grid and a GP sample.

Counterpart of ``examples/mv_gibbs_demo.py`` (the reference's executable
``__main__`` smoke demo of its multivariate Gibbs kernel, without pymc3):
a ``MultivariateGibbsGP`` on a 30 × 30 grid of [2, 3]², its Gram, and a
draw f = chol(K + 1e-4 I) z.  The randomness comes from the caller: the
draws behind H₀ and D₀ (``MultivariateGibbsGP.create``) and the sample's
normals, by default from ``np.random.default_rng(173)`` (the JAX demo draws
them from keys).  matplotlib is imported only to draw
``mv_gibbs_demo.png``; where it is missing (the card's machine) the demo
prints its numbers, says that no figure is drawn, and ends as usual.

Run: python -m nonstationary_precip_tpu_torch.examples.mv_gibbs_demo [outdir] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from nonstationary_precip_tpu_torch.models.multivariate_gibbs_gp import MultivariateGibbsGP
from nonstationary_precip_tpu_torch.ops.linalg import safe_cholesky
from nonstationary_precip_tpu_torch.utils.config import device
from nonstationary_precip_tpu_torch.utils.plotting import pyplot

NUM_GRID, SEED = 30, 173


def grid(lo: float, hi: float, num: int = NUM_GRID):
    """(gx, gy, x): the meshgrid of ``num`` points a side and its (num², 2)
    rows, as the JAX demos lay them out."""
    g = np.linspace(lo, hi, num)
    gx, gy = np.meshgrid(g, g)
    return gx, gy, np.stack([gx.ravel(), gy.ravel()], axis=1)


def default_draws(n: int):
    """(Z (n, 2), d (2,), normals (n,)): H₀'s and D₀'s standard-normal
    draws and the sample's."""
    rng = np.random.default_rng(SEED)
    return rng.standard_normal((n, 2)), rng.standard_normal(2), rng.standard_normal(n)


def run(dev="cuda", dtype=torch.float32, draws=None) -> dict:
    """The demo's numbers: the Gram (N, N) and the sample (N,)."""
    dev = device(dev) if isinstance(dev, str) else dev
    gx, gy, xg = grid(2.0, 3.0)
    z, d, normals = default_draws(len(xg)) if draws is None else draws
    x = torch.tensor(xg, dtype=dtype, device=dev)
    model = MultivariateGibbsGP.create((z, d), x, noise=0.01, dtype=dtype, device=dev)
    with torch.no_grad():
        k = model.gram(x, model.h)
        chol = safe_cholesky(k + 1e-4 * torch.eye(k.shape[0], dtype=dtype, device=dev))
        f = chol @ torch.as_tensor(normals, dtype=dtype, device=dev)
    return {"gram": k, "f": f, "gx": gx, "gy": gy}


def main(outdir=".", dev="cuda"):
    out = run(dev)
    k, f = out["gram"], out["f"]
    print("Gram:", tuple(k.shape), "diag mean:", float(torch.diagonal(k).mean()))
    print(f"GP sample: mean {float(f.mean()):.4f}  std {float(f.std()):.4f}")
    plt = pyplot("the demo's figure")
    if plt is not None:
        fig, axes = plt.subplots(1, 2, figsize=(9, 4))
        axes[0].matshow(k.cpu().numpy())
        axes[0].set_title("Multivariate Gibbs Gram")
        axes[1].contourf(out["gx"], out["gy"], f.cpu().numpy().reshape(NUM_GRID, NUM_GRID), cmap="jet", alpha=0.7)
        axes[1].set_title("GP sample")
        path = Path(outdir) / "mv_gibbs_demo.png"
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
