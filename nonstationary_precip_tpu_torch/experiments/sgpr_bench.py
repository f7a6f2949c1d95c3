#!/usr/bin/env python3
"""SGPR benchmark on the full Khyber 2000-2010 cube.

Counterpart of ``nonstationary_precip_tpu/experiments/sgpr_bench.py``: SGPR
(Titsias collapsed bound) with the kernel Scale(RBF(lon, lat)) +
Scale(RBF(t))·Periodic(t) on ``uib_spatio_temporal.csv`` (5676 rows), a
random 80/20 cut (4540 training rows), M = 1900 inducing inputs drawn from
the training rows, Adam lr 0.05, inputs standardised and y left raw.  The
cut and z come from ``np.random.default_rng(BASE_SEED)`` exactly as the JAX
experiment draws them, so z is the JAX run's, bit for bit.  No
hand-written kernel runs in the fit (M = 1900 and N = 4540 fall outside
every gate); the test predictive's joint NLPD factors its 1136 × 1136
covariance through K10a on the card, as the JAX package's dispatch does.

Run: python -m nonstationary_precip_tpu_torch.experiments.sgpr_bench --max_iters 100 [--device cuda|cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nonstationary_precip_tpu_torch.data.datasets import load_uib_spatio_temporal
from nonstationary_precip_tpu_torch.kernels.base import Scale
from nonstationary_precip_tpu_torch.kernels.stationary import RBF, Periodic
from nonstationary_precip_tpu_torch.models.sgpr import SGPR
from nonstationary_precip_tpu_torch.ops import chol_blocked
from nonstationary_precip_tpu_torch.train.config import ExperimentConfig
from nonstationary_precip_tpu_torch.train.metrics import nlpd_joint, rmse_rescaled
from nonstationary_precip_tpu_torch.train.optim import fit
from nonstationary_precip_tpu_torch.utils.config import BASE_SEED, device


def default_config() -> ExperimentConfig:
    """The experiment's configuration: the JAX ``main``'s."""
    return ExperimentConfig(lr=0.05, max_iters=100, num_inducing=1900, train_percent=80.0)


def make_kernel(dtype=torch.float32, dev=None):
    """SE(spatial) + SE(temporal)·Periodic(temporal)."""
    spatial = Scale.create(RBF.create(2, active_dims=(1, 2), dtype=dtype, device=dev), dtype=dtype, device=dev)
    temporal = Scale.create(RBF.create(1, active_dims=(0,), dtype=dtype, device=dev), dtype=dtype, device=dev) \
        * Periodic.create(1, active_dims=(0,), dtype=dtype, device=dev)
    return spatial + temporal


def prepare(cfg: ExperimentConfig, dtype=torch.float32, dev=None):
    """(train_x, train_y, test_x, test_y, z) on ``dev``: standardised x, raw
    y, the JAX experiment's permutation and its z draw (the rows of the
    float32 training inputs)."""
    _, x, y = load_uib_spatio_temporal()
    x = np.asfortranarray(x)  # the JAX loader's pandas array is column-major
    x_norm = (x - x.mean(0)) / x.std(0, ddof=1)
    rng = np.random.default_rng(BASE_SEED)
    idx = rng.permutation(len(y))
    n_train = int(cfg.train_percent / 100 * len(y))
    tr, te = idx[:n_train], idx[n_train:]
    train_x, train_y, test_x, test_y = (torch.as_tensor(a, dtype=dtype, device=dev)
                                        for a in (x_norm[tr], y[tr], x_norm[te], y[te]))
    z = train_x[torch.as_tensor(rng.permutation(n_train)[:cfg.num_inducing], device=dev)]
    return train_x, train_y, test_x, test_y, z


def run(cfg: ExperimentConfig) -> dict:
    """The whole experiment; returns what ``main`` reports, plus the loss
    trace, the timings and the trained model."""
    dev = device(cfg.device)
    dtype = torch.float32
    if dev.type == "cuda":  # compile K10a before the timed loop, not inside it
        chol_blocked.build()
    train_x, train_y, test_x, test_y, z = prepare(cfg, dtype, dev)
    t_wall = time.perf_counter()
    model = SGPR.create(make_kernel(dtype, dev), z, dtype=dtype, device=dev)
    res = fit(model, lambda m, xx, yy: m.loss(xx, yy), train_x, train_y, lr=cfg.lr, num_steps=cfg.max_iters,
              chunk=10)
    with torch.no_grad():
        p = res.model.predictive(train_x, train_y, test_x)
        r, nl = float(rmse_rescaled(p.mean, test_y, 1.0)), float(nlpd_joint(p, test_y, 1.0))
    wall_s = time.perf_counter() - t_wall
    print(f"SGPR test RMSE = {r:.4f}")
    print(f"SGPR test NLPD = {nl:.4f}")
    print(f"train: {res.steps} steps; wall {wall_s:.2f} s on {dev}")
    return {"rmse": r, "nlpd": nl, "losses": res.losses, "steps": res.steps, "train_seconds": res.seconds,
            "wall_seconds": wall_s, "model": res.model}


def main(argv=None):
    out = run(default_config().parse_args(argv))
    return out["rmse"], out["nlpd"]


if __name__ == "__main__":
    main()
