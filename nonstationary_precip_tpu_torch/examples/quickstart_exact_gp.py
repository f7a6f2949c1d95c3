#!/usr/bin/env python3
"""Quickstart 1/4: exact GP regression in ~20 lines.

Counterpart of ``examples/quickstart_exact_gp.py``: synthetic 1-D data →
``ExactGP`` with a Scale(RBF) kernel → Adam on the MLL → posterior
predictions (the reference's ``ExactGPModel`` workflow).

Run: python -m nonstationary_precip_tpu_torch.examples.quickstart_exact_gp [num_steps] [--device cpu]
(on the card by default; on the CPU a few seconds).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from nonstationary_precip_tpu_torch.kernels.base import Scale
from nonstationary_precip_tpu_torch.kernels.stationary import RBF
from nonstationary_precip_tpu_torch.models.exact_gp import ExactGP
from nonstationary_precip_tpu_torch.train.metrics import nlpd_joint, rmse_rescaled
from nonstationary_precip_tpu_torch.train.optim import fit
from nonstationary_precip_tpu_torch.utils.config import device


def main(num_steps=300, dev="cuda"):
    dev = device(dev)
    f32 = dict(dtype=torch.float32, device=dev)

    # --- data: noisy sine, last 20% held out -------------------------------
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 6.0, 200)[:, None]
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(200)
    xtr, ytr = torch.tensor(x[:160], **f32), torch.tensor(y[:160], **f32)
    xte, yte = torch.tensor(x[160:], **f32), torch.tensor(y[160:], **f32)

    # --- model: an nn.Module; its parameters are what Adam trains ----------
    model = ExactGP.create(Scale.create(RBF.create(1, **f32), **f32), mean_type="constant", **f32)

    # --- train -----------------------------------------------------------------
    res = fit(model, lambda m, xx, yy: m.loss(xx, yy), xtr, ytr, lr=0.05, num_steps=num_steps)
    print(f"final -MLL/N: {float(res.losses[-1]):.4f}  ({res.steps} steps)")

    # --- predict ---------------------------------------------------------------
    with torch.no_grad():
        post = res.model.predictive(xtr, ytr, xte)
        r, nl = float(rmse_rescaled(post.mean, yte, 1.0)), float(nlpd_joint(post, yte, 1.0))
    print(f"extrapolation RMSE: {r:.4f}   NLPD: {nl:.4f}")
    if num_steps >= 300:
        assert r < 0.5, "quickstart sanity bound"
    print("ok")
    return {"rmse": r, "nlpd": nl, "losses": res.losses}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("num_steps", type=int, nargs="?", default=300)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.num_steps, args.device)
