#!/usr/bin/env python3
"""SE-ARD exact GP spatial baseline over 10 shuffled splits.

Counterpart of ``nonstationary_precip_tpu/experiments/seard_spatial.py``
(RESULTS row ``seard_spatial_10split``): uib_spatial.csv → per split,
sklearn-style shuffle (random_state = split) → whitening (or Box-Cox with
``--model boxcox``) → contiguous 80/20 cut (315 train, 79 test) →
ExactGP(Scale(RBF-ARD-2), constant mean) → Adam lr 0.01 × 400, all splits in
lockstep as one stacked model → RMSE (σ_y-rescaled) and joint NLPD per
split, mean ± stderr.

At N = 315 the dense Cholesky is ``torch.linalg.cholesky_ex``: no
hand-written kernel runs on this path (the JAX package runs no Pallas
kernel here either; its only Pallas Cholesky that small, ``blocked_cholesky``,
is opt-in for 768 ≤ N ≤ 1280).

Run: python -m nonstationary_precip_tpu_torch.experiments.seard_spatial [--device cuda|cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nonstationary_precip_tpu_torch.data.dataprep import (
    box_cox_transform,
    load_csv,
    sklearn_style_shuffle,
    train_test_split,
    whitening_transform,
)
from nonstationary_precip_tpu_torch.kernels.base import Scale
from nonstationary_precip_tpu_torch.kernels.stationary import RBF
from nonstationary_precip_tpu_torch.models.exact_gp import ExactGP
from nonstationary_precip_tpu_torch.train.config import ExperimentConfig
from nonstationary_precip_tpu_torch.train.metrics import nlpd_joint, rmse_rescaled
from nonstationary_precip_tpu_torch.train.optim import fit
from nonstationary_precip_tpu_torch.train.vmapped import eval_splits, fit_splits
from nonstationary_precip_tpu_torch.utils.config import DATASET_DIR, device


def default_config() -> ExperimentConfig:
    """The experiment's configuration: the JAX ``main``'s."""
    return ExperimentConfig(model="whitening", lr=0.01, max_iters=400)


def make_split(data: np.ndarray, random_state: int, cfg: ExperimentConfig, dtype=torch.float32, dev=None):
    """Per-split model and data: (model, (train_x, train_y), (test_x,
    test_y, stdy)), the shapes identical across splits, on ``dev``
    (default: ``cfg.device``, which raises where it names a card that is
    not there)."""
    dev = device(cfg.device) if dev is None else dev
    shuffled = sklearn_style_shuffle(data, random_state)
    if cfg.model == "boxcox":
        bc = box_cox_transform(shuffled)
        x_tr, y_tr, stdy = bc.x, bc.y, 1.0
    else:
        w = whitening_transform(shuffled)
        x_tr, y_tr, stdy = w.x, w.y, w.stdy
    train_x, train_y, test_x, test_y = (torch.as_tensor(a, dtype=dtype, device=dev)
                                        for a in train_test_split(x_tr, y_tr, cfg.train_percent / 100))
    model = ExactGP.create(Scale.create(RBF.create(2, dtype=dtype, device=dev), dtype=dtype, device=dev),
                           mean_type="constant", dtype=dtype, device=dev)
    return model, (train_x, train_y), (test_x, test_y, torch.as_tensor(stdy, dtype=dtype, device=dev))


def _loss(m, x, y):
    return m.loss(x, y)


def _metrics(m, xtr, ytr, xte, yte, stdy):
    pred = m.predictive(xtr, ytr, xte)
    return rmse_rescaled(pred.mean, yte, stdy), nlpd_joint(pred, yte, stdy)


def run_one_split(data, random_state: int, cfg: ExperimentConfig, dev=None):
    """Sequential single-split fit: the oracle for the lockstep ``run``, on
    ``dev`` (default: ``cfg.device``, which raises where it names a card
    that is not there).  Returns (RMSE, NLPD, TrainResult)."""
    dev = device(cfg.device) if dev is None else dev
    model, (xtr, ytr), (xte, yte, stdy) = make_split(data, random_state, cfg, dev=dev)
    res = fit(model, _loss, xtr, ytr, lr=cfg.lr, num_steps=cfg.max_iters)
    with torch.no_grad():
        r, nl = _metrics(res.model, xtr, ytr, xte, yte, stdy)
    return float(r), float(nl), res


def run(cfg: ExperimentConfig) -> dict:
    """The whole experiment; returns what ``main`` reports, plus the
    per-step per-split losses and the timings."""
    dev = device(cfg.device)
    data = load_csv(DATASET_DIR / "uib_spatial.csv")
    splits = [make_split(data, rs, cfg, torch.float32, dev) for rs in range(cfg.num_splits)]

    t_wall = time.perf_counter()
    res = fit_splits([s[0] for s in splits], _loss, [s[1][0] for s in splits], [s[1][1] for s in splits],
                     lr=cfg.lr, num_steps=cfg.max_iters)
    rmses_t, nlpds_t = eval_splits(res.model, _metrics, *([s[1][i] for s in splits] for i in range(2)),
                                   *([s[2][i] for s in splits] for i in range(3)))
    rmses, nlpds = rmses_t.cpu().numpy(), nlpds_t.cpu().numpy()
    wall_s = time.perf_counter() - t_wall
    for rs in range(cfg.num_splits):
        print(f"split {rs}: RMSE {rmses[rs]:.4f}  NLPD {nlpds[rs]:.4f}")
    k = len(rmses)
    print(f"RMSE: {np.mean(rmses):.4f} ± {np.std(rmses) / np.sqrt(k):.4f}")
    print(f"NLPD: {np.mean(nlpds):.4f} ± {np.std(nlpds) / np.sqrt(k):.4f}")
    steps_per_s = (res.steps - 1) / res.seconds if res.seconds > 0 else float("nan")
    print(f"train: {res.steps} steps, {steps_per_s:.2f} steps/s after the first step; wall {wall_s:.2f} s on {dev}")
    return {"rmse": float(np.mean(rmses)), "nlpd": float(np.mean(nlpds)), "rmses": rmses, "nlpds": nlpds,
            "losses": res.losses, "steps": res.steps, "train_seconds": res.seconds, "steps_per_s": steps_per_s,
            "wall_seconds": wall_s, "model": res.model}


def main(argv=None):
    out = run(default_config().parse_args(argv))
    return out["rmse"], out["nlpd"]


if __name__ == "__main__":
    main()
