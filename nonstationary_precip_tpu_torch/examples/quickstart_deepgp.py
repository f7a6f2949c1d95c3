#!/usr/bin/env python3
"""Quickstart 3/4: deep GP trained with DSVI.

Counterpart of ``examples/quickstart_deepgp.py``: one split of the UIB
spatial data → 2-layer whitened-SVGP ``DeepGP`` (M = 64) → epoch-shuffled
minibatch Adam on the doubly-stochastic ELBO (the reference's
deepgp_spatial_bench.py workflow).  The DSVI noise comes from numpy seeds
and is passed in, where the JAX example draws it from keys.  On the card
every step takes K4 (the layers' precompute) and K7 (the fused data term,
forward and backward), and the prediction K4 once more.

Run: python -m nonstationary_precip_tpu_torch.examples.quickstart_deepgp [num_epochs] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from nonstationary_precip_tpu_torch.data.dataprep import (
    load_csv,
    sklearn_style_shuffle,
    train_test_split,
    whitening_transform,
)
from nonstationary_precip_tpu_torch.experiments.deepgp_spatial import draw_eps
from nonstationary_precip_tpu_torch.models.deep_gp import DeepGP
from nonstationary_precip_tpu_torch.train.metrics import nlpd_marginal, rmse_raw
from nonstationary_precip_tpu_torch.train.optim import fit_minibatched, num_minibatch_steps
from nonstationary_precip_tpu_torch.utils.config import DATASET_DIR, device

SEED, BATCH, SAMPLES, PRED_SAMPLES = 173, 158, 3, 10


def main(num_epochs=40, dev="cuda"):
    dev = device(dev)
    f32 = dict(dtype=torch.float32, device=dev)
    data = load_csv(DATASET_DIR / "uib_spatial.csv")
    w = whitening_transform(sklearn_style_shuffle(data, 0))
    train_x, train_y, test_x, test_y = (torch.tensor(a, **f32) for a in train_test_split(w.x, w.y, 0.8))
    n = train_x.shape[0]

    model = DeepGP.create(torch.Generator().manual_seed(SEED), input_dims=2, num_layers=2, num_inducing=64, **f32)
    rng = np.random.default_rng(SEED)
    steps = num_minibatch_steps(n, num_epochs, BATCH)
    eps_train = tuple(torch.tensor(e, device=dev) for e in draw_eps(rng, (steps, SAMPLES), 2, min(BATCH, n)))
    eps_pred = tuple(torch.tensor(e, device=dev) for e in draw_eps(rng, (PRED_SAMPLES,), 2, test_x.shape[0]))

    res = fit_minibatched(model, lambda m, eps, xb, yb: m.loss(xb, yb, num_data=n, eps=eps), train_x, train_y,
                          eps_train, num_epochs=num_epochs, batch_size=BATCH, lr=0.01)
    print(f"final ELBO loss: {float(res.losses[-1]):.4f}")

    with torch.no_grad():
        mix = res.model.predict(test_x, eps_pred)[0]
        r, nl = float(rmse_raw(mix.mean, test_y)), float(nlpd_marginal(test_y, mix.mean, mix.var))
    print(f"RMSE(σ): {r:.4f}   NLPD: {nl:.4f}")
    print("ok")
    return {"rmse": r, "nlpd": nl, "losses": res.losses, "steps": res.steps}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("num_epochs", type=int, nargs="?", default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.num_epochs, args.device)
