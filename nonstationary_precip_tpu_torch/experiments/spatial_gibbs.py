#!/usr/bin/env python3
"""Nonstationary Gibbs spatial GP over 10 random splits (UIB basin).

Counterpart of ``nonstationary_precip_tpu/experiments/spatial_gibbs.py``:
uib_spatial.csv → standardise → per-split 80/20 shuffle (seeded
BASE_SEED + i) → frozen LogNormal lengthscale-process prior (scale 1,
ℓ 1.3, mean log 0.3) → GibbsExactGP, or with ``--inference sparse``
GibbsSparseGP on k-means inducing inputs (noise fixed 0.011, outputscale
fixed 0.644) → Adam on all splits at once → RMSE/NLPD per split, mean ±
stderr → the last split's full-field prediction as a CSV, with the
lengthscale field for the exact model (no plot).

The sparse model's k-means seed row for split i is drawn by
``np.random.default_rng(BASE_SEED + i)`` (``first_centre``), where the JAX
experiment draws it from ``PRNGKey(BASE_SEED + i)``: randomness comes from
the caller.  Its z and latent field train, nothing else (no prior hoist:
the prior's Gram moves with z).

Run: python -m nonstationary_precip_tpu_torch.experiments.spatial_gibbs [--inference exact|sparse] [--device cuda|cpu]
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from nonstationary_precip_tpu_torch.data.dataprep import shuffle_split
from nonstationary_precip_tpu_torch.data.datasets import load_uib_spatial
from nonstationary_precip_tpu_torch.models.gibbs_gp import GibbsExactGP, GibbsSparseGP, gibbs_map_loss_batched
from nonstationary_precip_tpu_torch.ops import chol_inv, gibbs_gram
from nonstationary_precip_tpu_torch.ops.kmeans import kmeans_inducing_points
from nonstationary_precip_tpu_torch.priors.lognormal_process import LogNormalProcess
from nonstationary_precip_tpu_torch.train.config import ExperimentConfig
from nonstationary_precip_tpu_torch.train.metrics import nlpd_joint, rmse_rescaled
from nonstationary_precip_tpu_torch.train.vmapped import Stacked, eval_splits, fit_splits, unstack_module
from nonstationary_precip_tpu_torch.utils.config import BASE_SEED, device, results_dir

FIELD_CSV = "gibbs_spatial_f_mean_sigma.csv"


def build_prior(cfg: ExperimentConfig, dtype, dev) -> LogNormalProcess:
    """Frozen LogNormal process prior with the CLI-settable hypers."""
    return LogNormalProcess.create(
        input_dim=2,
        mean=math.log(cfg.prior_mean),
        outputscale=cfg.prior_scale,
        lengthscale=cfg.prior_ell,
        dtype=dtype,
        device=dev,
    )


def first_centre(split: int, n: int) -> int:
    """The sparse model's k-means seed row of split ``split`` (of its n
    training rows)."""
    return int(np.random.default_rng(BASE_SEED + split).integers(n))


def make_split(x_norm, y_norm, split: int, cfg: ExperimentConfig, dtype, dev):
    """Per-split model and data (identical shapes across splits, so the K
    splits stack into one batched training run)."""
    x_tr, y_tr, x_te, y_te = shuffle_split(x_norm, y_norm, cfg.train_percent / 100, BASE_SEED + split)
    data = tuple(torch.as_tensor(a, dtype=dtype, device=dev) for a in (x_tr, y_tr, x_te, y_te))
    noise = cfg.noise if cfg.noise > 0 else None
    scale = cfg.scale if cfg.scale > 0 else 1.0
    prior = build_prior(cfg, dtype, dev)
    if cfg.inference == "sparse":
        z = kmeans_inducing_points(first_centre(split, len(y_tr)), data[0], cfg.num_inducing)
        model = GibbsSparseGP.create(z, prior, noise=noise, outputscale=scale, dtype=dtype, device=dev)
    elif cfg.inference == "exact":
        model = GibbsExactGP.create(data[0], prior, noise=noise, outputscale=scale, dtype=dtype, device=dev)
    else:
        raise ValueError(f"--inference is exact or sparse, got {cfg.inference!r}")
    model.trainable(train_noise=cfg.noise == 0, train_scale=cfg.scale == 0)
    return model, data


def _eval_one(stdy):
    def eval_fn(m, xtr, ytr, xte, yte):
        pred = m.predictive(xtr, ytr, xte)
        return rmse_rescaled(pred.mean, yte, stdy), nlpd_joint(pred, yte, stdy)

    return eval_fn


def run(cfg: ExperimentConfig) -> dict:
    """The whole experiment; returns what ``main`` reports, plus the
    per-step per-split losses and timings."""
    sparse = cfg.inference == "sparse"
    dev = device(cfg.device)
    dtype = torch.float32
    if dev.type == "cuda":  # compile the kernels before the timed loop, not inside it
        chol_inv.build()
        gibbs_gram.build()

    _, x, y = load_uib_spatial()
    meanx, stdx = x.mean(0), x.std(0, ddof=1)
    x_norm = (x - meanx) / stdx
    meany, stdy = y.mean(), y.std(ddof=1)
    y_norm = (y - meany) / stdy

    splits = [make_split(x_norm, y_norm, s, cfg, dtype, dev) for s in range(cfg.num_splits)]
    models = [s[0] for s in splits]
    x_tr, y_tr, x_te, y_te = (list(col) for col in zip(*[s[1] for s in splits]))

    t_wall = time.perf_counter()
    if sparse:  # z trains, so the prior's Gram moves: nothing to hoist
        res = fit_splits(models, lambda m, xx, yy: m.loss(xx, yy), x_tr, y_tr, lr=cfg.lr,
                         num_steps=cfg.max_iters, chunk=min(500, cfg.max_iters))
    else:
        # the frozen prior's (K⁻¹, logdet) is loop-invariant: hoisted once,
        # for all splits in one batched call (the prior is the same for every
        # split)
        pre = build_prior(cfg, dtype, dev).gram_pre(torch.stack(x_tr))
        res = fit_splits(
            models,
            lambda m, xx, yy, pc: m.loss(xx, yy, pc),
            x_tr, y_tr, Stacked(pre),
            lr=cfg.lr,
            num_steps=cfg.max_iters,
            chunk=min(500, cfg.max_iters),
            batched_loss=gibbs_map_loss_batched,
        )
    rmses_t, nlpds_t = eval_splits(res.model, _eval_one(stdy), x_tr, y_tr, x_te, y_te)
    rmses, nlpds = rmses_t.cpu().numpy(), nlpds_t.cpu().numpy()
    for split in range(cfg.num_splits):
        print(f"split {split}: RMSE {rmses[split]:.4f}  NLPD {nlpds[split]:.4f}")
    k = len(rmses)
    print(f"Final RMSE across splits: {np.mean(rmses):.4f} ± {np.std(rmses)/np.sqrt(k):.4f}")
    print(f"Final NLPD across splits: {np.mean(nlpds):.4f} ± {np.std(nlpds)/np.sqrt(k):.4f}")

    # full-field prediction of the last split, with its lengthscale field
    # for the exact model; CSV schema as the JAX package's
    # (pred/std/lon/lat, then ell0/ell1 for the exact model)
    model = unstack_module(res.model, cfg.num_splits)[-1]
    x_all = torch.as_tensor(x_norm, dtype=dtype, device=dev)
    header = "pred,std,lon,lat"
    with torch.no_grad():
        post = model.posterior(x_tr[-1], y_tr[-1], x_all)
        cols = [post.mean.cpu().numpy(), np.sqrt(post.var.cpu().numpy()), x[:, 0], x[:, 1]]
        if not sparse:
            ell_field = model.lengthscale_field(x_tr[-1], x_all).cpu().numpy()
            cols += [ell_field[:, 0], ell_field[:, 1]]
            header += ",ell0,ell1"
        field = np.column_stack(cols)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t_wall
    out_dir = results_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    csv_path = out_dir / FIELD_CSV
    np.savetxt(csv_path, field, delimiter=",", header=header, comments="", fmt="%.9g")
    steps_per_s = (res.steps - 1) / res.seconds if res.seconds > 0 else float("nan")
    print(f"train: {res.steps} steps, {steps_per_s:.2f} steps/s after the first step; "
          f"wall {wall_s:.2f} s on {dev}")
    return {
        "rmse": float(np.mean(rmses)),
        "nlpd": float(np.mean(nlpds)),
        "rmses": rmses,
        "nlpds": nlpds,
        "losses": res.losses,
        "steps": res.steps,
        "train_seconds": res.seconds,
        "steps_per_s": steps_per_s,
        "wall_seconds": wall_s,
        "csv": csv_path,
    }


def main(argv=None):
    cfg = ExperimentConfig(lr=0.01, max_iters=5000).parse_args(argv)
    out = run(cfg)
    return out["rmse"], out["nlpd"]


if __name__ == "__main__":
    main()
