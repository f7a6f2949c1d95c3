#!/usr/bin/env python3
"""Quickstart 2/4: nonstationary Gibbs GP with a latent lengthscale field.

Counterpart of ``examples/quickstart_gibbs_spatial.py``: one 80/20 split of
the bundled UIB spatial dataset → ``GibbsExactGP`` (MAP over the MLL and a
LogNormal-process prior on the log-lengthscale field, the reference's
DiagonalExactGP workflow) → posterior metrics and the learned per-point
lengthscale field.  On the card the loss's Gram at N = 315 is K9's.

Run: python -m nonstationary_precip_tpu_torch.examples.quickstart_gibbs_spatial [max_iters] [--device cpu]
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from nonstationary_precip_tpu_torch.data.dataprep import load_csv, train_test_split
from nonstationary_precip_tpu_torch.models.gibbs_gp import GibbsExactGP
from nonstationary_precip_tpu_torch.priors.lognormal_process import LogNormalProcess
from nonstationary_precip_tpu_torch.train.metrics import nlpd_joint, rmse_rescaled
from nonstationary_precip_tpu_torch.train.optim import fit
from nonstationary_precip_tpu_torch.utils.config import BASE_SEED, DATASET_DIR, device


def main(max_iters=300, dev="cuda"):
    dev = device(dev)
    f32 = dict(dtype=torch.float32, device=dev)
    data = load_csv(DATASET_DIR / "uib_spatial.csv")  # lon, lat, tp (394 sites)
    x, y = data[:, :2], data[:, 2]
    x_norm = (x - x.mean(0)) / x.std(0)
    y_norm = (y - y.mean()) / y.std()

    rng = np.random.default_rng(BASE_SEED)
    idx = rng.permutation(len(y_norm))
    train_x, train_y, test_x, test_y = (torch.tensor(a, **f32)
                                        for a in train_test_split(x_norm[idx], y_norm[idx], 0.8))

    # frozen prior over the log-lengthscale field (spatial_exp.py defaults)
    prior = LogNormalProcess.create(input_dim=2, mean=math.log(0.3), outputscale=1.0, lengthscale=1.3, **f32)
    # noise and outputscale frozen at the reference's CLI defaults; only the
    # latent log-ℓ field trains
    model = GibbsExactGP.create(train_x, prior, noise=0.011, outputscale=0.644, **f32).trainable()

    res = fit(model, lambda m, xx, yy: m.loss(xx, yy), train_x, train_y, lr=0.01, num_steps=max_iters, log_every=100)

    with torch.no_grad():
        pred = res.model.predictive(train_x, train_y, test_x)
        r, nl = float(rmse_rescaled(pred.mean, test_y, 1.0)), float(nlpd_joint(pred, test_y, 1.0))
        # the learned nonstationary lengthscale field at the training points
        ell = res.model.lengthscale_field(train_x)
    print(f"split RMSE(σ): {r:.4f}   NLPD: {nl:.4f}")
    print("lengthscale field: shape", tuple(ell.shape), " range [%.3f, %.3f]" % (float(ell.min()), float(ell.max())))
    print("ok")
    return {"rmse": r, "nlpd": nl, "losses": res.losses, "n_train": train_x.shape[0]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("max_iters", type=int, nargs="?", default=300)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.max_iters, args.device)
