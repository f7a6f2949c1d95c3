#!/usr/bin/env python3
"""Deep GP (DSVI) on the spatio-temporal precipitation cube.

Counterpart of ``nonstationary_precip_tpu/experiments/spatiotemporal_dgp.py``:
(time, lon, lat) inputs of ``uib_spatio_temporal.csv``, year-2000 months 1-4
train (172 rows) and month 5 test (43), a DeepGP with 2 hidden layers
(3 → 2 → 2 → 1, M = 250), 200 epochs of one batch of min(1024, 172) rows,
S = 10 samples, Adam lr 0.01, then the predictive mixture over 10 sample
paths: RMSE of its mean (σ-rescaled) and its per-point NLPD plus log σ_y.

Each step's K_zz factors for all five outputs come from one K4 call (D ≤
3 is inside its gate); the data term stays composed, since K7's gate takes
D = 2 only, as the JAX package's ``_fused_loss`` does.  Randomness comes
from the caller: the init z from ``torch.Generator().manual_seed(BASE_SEED)``,
the ε of every step and of the prediction from
``np.random.default_rng(BASE_SEED)``, drawn up front (``field_regression``'s
``_fit_predict``); the batch schedule is the JAX package's, bit for bit.
The arrays go to ``results_dir()`` as ``results_st_dgp_{mean,var}.npy``.

Run: python -m nonstationary_precip_tpu_torch.experiments.spatiotemporal_dgp [--device cuda|cpu]
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from nonstationary_precip_tpu_torch.data.datasets import spatio_temporal_month_split
from nonstationary_precip_tpu_torch.experiments.field_regression import _fit_predict
from nonstationary_precip_tpu_torch.ops import svgp_precompute
from nonstationary_precip_tpu_torch.train.config import ExperimentConfig
from nonstationary_precip_tpu_torch.train.metrics import nlpd_marginal
from nonstationary_precip_tpu_torch.utils.config import BASE_SEED, device, results_dir


def default_config() -> ExperimentConfig:
    """The experiment's configuration: the JAX ``main``'s."""
    return ExperimentConfig(lr=0.01, num_epochs=200, num_samples=10, num_layers=2, batch_size=1024,
                            num_inducing=250)


def fit_score(cfg: ExperimentConfig, dev, dtype=torch.float32, draw_seed: int = BASE_SEED):
    """Train on months 1-4 and predict month 5: (RMSE, NLPD, predictive
    mixture, TrainResult).  ``draw_seed`` seeds the init and the ε."""
    x_train, y_train, x_test, y_test, _, stdy, _, _ = spatio_temporal_month_split()
    dist, _, _, res = _fit_predict(x_train, y_train, x_test, cfg, cfg.batch_size, BASE_SEED, cfg.num_samples, dev,
                                   dtype, draw_seed)
    with torch.no_grad():
        yte = torch.as_tensor(y_test, dtype=dist.mean.dtype, device=dev)
        r = float(stdy * torch.sqrt(torch.mean((dist.mean - yte) ** 2)))
        nl = float(nlpd_marginal(yte, dist.mean, dist.var)) + math.log(stdy)
    return r, nl, dist, res


def run(cfg: ExperimentConfig) -> dict:
    """The whole experiment; returns what ``main`` reports, plus the loss
    trace, the timings and the trained model."""
    dev = device(cfg.device)
    if dev.type == "cuda":  # compile K4 before the timed loop, not inside it
        svgp_precompute.build()
    t_wall = time.perf_counter()
    r, nl, dist, res = fit_score(cfg, dev)
    wall_s = time.perf_counter() - t_wall
    print(f"RMSE test = {r:.4f}")
    print(f"NLPD test = {nl:.4f}")
    out_dir = results_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    np.save(out_dir / "results_st_dgp_mean.npy", dist.mean.cpu().numpy())
    np.save(out_dir / "results_st_dgp_var.npy", dist.var.cpu().numpy())
    print(f"train: {res.steps} steps; wall {wall_s:.2f} s on {dev}")
    return {"rmse": r, "nlpd": nl, "losses": res.losses, "steps": res.steps, "train_seconds": res.seconds,
            "wall_seconds": wall_s, "model": res.model}


def main(argv=None):
    out = run(default_config().parse_args(argv))
    return out["rmse"], out["nlpd"]


if __name__ == "__main__":
    main()
