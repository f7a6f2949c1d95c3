#!/usr/bin/env python3
"""1-D temporal extrapolation at a single Khyber grid point.

Counterpart of ``nonstationary_precip_tpu/experiments/temporal.py`` (RESULTS
row ``temporal``): khyber_time_series.csv (342 monthly values) →
standardised time, Box-Cox y → contiguous split, the last 20 % held out
(extrapolation, no shuffle) → ExactGP(Scale(RBF·Periodic, outputscale > 7,
init 7.6931), constant mean) → Adam lr 0.01 × 2000 → RMSE and joint NLPD in
Box-Cox space, and the RMSE in mm/day through the inverse Box-Cox.

At N = 273 the dense Cholesky is ``torch.linalg.cholesky_ex``: no
hand-written kernel runs on this path.

Run: python -m nonstationary_precip_tpu_torch.experiments.temporal [--device cuda|cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nonstationary_precip_tpu_torch.data.dataprep import train_test_split
from nonstationary_precip_tpu_torch.data.datasets import load_khyber_time_series
from nonstationary_precip_tpu_torch.kernels.base import Scale
from nonstationary_precip_tpu_torch.kernels.stationary import RBF, Periodic
from nonstationary_precip_tpu_torch.models.exact_gp import ExactGP
from nonstationary_precip_tpu_torch.train.config import ExperimentConfig
from nonstationary_precip_tpu_torch.train.metrics import nlpd_joint, rmse_rescaled
from nonstationary_precip_tpu_torch.train.optim import fit
from nonstationary_precip_tpu_torch.utils.config import device


def default_config() -> ExperimentConfig:
    """The experiment's configuration: the JAX ``main``'s."""
    return ExperimentConfig(lr=0.01, max_iters=2000)


def make_temporal_kernel(dtype=torch.float32, dev=None) -> Scale:
    """Scale(RBF(t)·Periodic(t)), outputscale > 7, init 7.6931."""
    return Scale.create(RBF.create(1, dtype=dtype, device=dev) * Periodic.create(1, dtype=dtype, device=dev),
                        outputscale=7.6931, lower_bound=7.0, dtype=dtype, device=dev)


def prep_data():
    """(train_x, train_y, test_x, test_y, lmbda), float64 numpy: time
    standardised (ddof 1), y Box-Cox transformed, the first 80 % train."""
    import scipy.stats

    t, tp = load_khyber_time_series()
    x_norm = ((t - t.mean()) / t.std(ddof=1))[:, None]
    y_tr, lmbda = scipy.stats.boxcox(tp)
    return (*train_test_split(x_norm, y_tr, 0.8), float(lmbda))


def _loss(m, x, y):
    return m.loss(x, y)


def run(cfg: ExperimentConfig) -> dict:
    """The whole experiment; returns the metrics, the loss trace, the
    predictive mean and the timings."""
    from scipy.special import inv_boxcox

    dev = device(cfg.device)
    dtype = torch.float32
    train_x, train_y, test_x, test_y, lmbda = prep_data()
    xtr, ytr, xte, yte = (torch.as_tensor(a, dtype=dtype, device=dev) for a in (train_x, train_y, test_x, test_y))
    model = ExactGP.create(make_temporal_kernel(dtype, dev), mean_type="constant", dtype=dtype, device=dev)

    t_wall = time.perf_counter()
    res = fit(model, _loss, xtr, ytr, lr=cfg.lr, num_steps=cfg.max_iters, chunk=500)
    with torch.no_grad():
        pred = res.model.predictive(xtr, ytr, xte)
        r, nl = float(rmse_rescaled(pred.mean, yte, 1.0)), float(nlpd_joint(pred, yte, 1.0))
        mean = pred.mean.cpu().numpy().astype(np.float64)
    wall_s = time.perf_counter() - t_wall
    raw_rmse = float(np.sqrt(np.mean((inv_boxcox(mean, lmbda) - inv_boxcox(test_y, lmbda)) ** 2)))
    print(f"RMSE test (box-cox space) = {r:.4f}")
    print(f"NLPD test = {nl:.4f}")
    print(f"RMSE test (raw mm/day)    = {raw_rmse:.4f}")
    steps_per_s = (res.steps - 1) / res.seconds if res.seconds > 0 else float("nan")
    print(f"train: {res.steps} steps, {steps_per_s:.2f} steps/s after the first step; wall {wall_s:.2f} s on {dev}")
    return {"rmse": r, "nlpd": nl, "raw_rmse": raw_rmse, "losses": res.losses, "steps": res.steps,
            "pred_mean": mean, "train_seconds": res.seconds, "steps_per_s": steps_per_s, "wall_seconds": wall_s,
            "model": res.model}


def main(argv=None):
    out = run(default_config().parse_args(argv))
    return out["rmse"], out["nlpd"]


if __name__ == "__main__":
    main()
