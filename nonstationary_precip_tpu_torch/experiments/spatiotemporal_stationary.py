#!/usr/bin/env python3
"""Exact-GP stationary spatio-temporal baseline with Box-Cox outputs.

Counterpart of ``nonstationary_precip_tpu/experiments/spatiotemporal_stationary.py``:
the first 5 months of the 2000-2010 cube (``uib_spatio_temporal.csv``, 43
sites a month: 172 training rows, 43 test rows), kernel Scale(RBF(lon, lat))
+ Scale(RBF(t)·Periodic(t)), constant mean, Box-Cox y (scipy), Adam lr 0.1
× 200, predictions inverse-Box-Cox'd for the raw-space RMSE.  No
hand-written kernel runs on this path (N = 172).

Run: python -m nonstationary_precip_tpu_torch.experiments.spatiotemporal_stationary [--device cuda|cpu]
"""

from __future__ import annotations

import time

import numpy as np
import scipy.stats
import torch
from scipy.special import inv_boxcox

from nonstationary_precip_tpu_torch.data.datasets import load_uib_spatio_temporal
from nonstationary_precip_tpu_torch.kernels.base import Scale
from nonstationary_precip_tpu_torch.kernels.stationary import RBF, Periodic
from nonstationary_precip_tpu_torch.models.exact_gp import ExactGP
from nonstationary_precip_tpu_torch.train.config import ExperimentConfig
from nonstationary_precip_tpu_torch.train.metrics import nlpd_marginal, rmse_raw
from nonstationary_precip_tpu_torch.train.optim import fit
from nonstationary_precip_tpu_torch.utils.config import device


def make_kernel(dtype=torch.float32, dev=None):
    """Scale(RBF(lon, lat)) + Scale(RBF(t)·Periodic(t)) over (t, lon, lat)."""
    spatial = Scale.create(RBF.create(2, active_dims=(1, 2), dtype=dtype, device=dev), dtype=dtype, device=dev)
    temporal = Scale.create(RBF.create(1, active_dims=(0,), dtype=dtype, device=dev)
                            * Periodic.create(1, active_dims=(0,), dtype=dtype, device=dev), dtype=dtype, device=dev)
    return spatial + temporal


def prepare():
    """The first five months, standardised x and Box-Cox y, cut after the
    fourth: (train_x, train_y, test_x, test_y, λ), numpy float64, as the
    JAX experiment prepares them (its pandas array is column-major, so the
    column statistics sum in the same order here)."""
    _, x, y = load_uib_spatio_temporal()
    sites = int(np.unique(x[:, 0], return_counts=True)[1][0])  # rows of the first month
    n5 = sites * 5
    x, y = np.asfortranarray(x[:n5]), y[:n5]
    x_norm = (x - x.mean(0)) / x.std(0, ddof=1)
    y_tr, lmbda = scipy.stats.boxcox(y)
    n_train = sites * 4
    return x_norm[:n_train], y_tr[:n_train], x_norm[n_train:], y_tr[n_train:], lmbda


def run(cfg: ExperimentConfig) -> dict:
    """The whole experiment; returns what ``main`` reports, plus the loss
    trace and timings."""
    dev = device(cfg.device)
    dtype = torch.float32
    train_x, train_y, test_x, test_y, lmbda = prepare()
    t = [torch.as_tensor(a, dtype=dtype, device=dev) for a in (train_x, train_y, test_x, test_y)]
    t_wall = time.perf_counter()
    model = ExactGP.create(make_kernel(dtype, dev), mean_type="constant", dtype=dtype, device=dev)
    res = fit(model, lambda m, xx, yy: m.loss(xx, yy), t[0], t[1], lr=cfg.lr, num_steps=cfg.max_iters)
    with torch.no_grad():
        p = res.model.predictive(t[0], t[1], t[2])
        r_bc, nl = float(rmse_raw(p.mean, t[3])), float(nlpd_marginal(t[3], p.mean, p.var))
        p_mean = p.mean.cpu().numpy()
    raw_pred = inv_boxcox(p_mean, lmbda)
    raw_true = inv_boxcox(test_y, lmbda)
    r_raw = float(np.sqrt(np.mean((raw_pred - raw_true) ** 2)))
    wall_s = time.perf_counter() - t_wall
    print(f"RMSE (raw mm/day) = {r_raw:.4f}")
    print(f"RMSE (box-cox)    = {r_bc:.4f}")
    print(f"NLPD (box-cox)    = {nl:.4f}")
    print(f"train: {res.steps} steps; wall {wall_s:.2f} s on {dev}")
    return {"rmse": r_raw, "nlpd": nl, "rmse_boxcox": r_bc, "losses": res.losses, "steps": res.steps,
            "train_seconds": res.seconds, "wall_seconds": wall_s}


def main(argv=None):
    out = run(ExperimentConfig(lr=0.1, max_iters=200).parse_args(argv))
    return out["rmse"], out["nlpd"]


if __name__ == "__main__":
    main()
