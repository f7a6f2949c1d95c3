#!/usr/bin/env python3
"""Deep GP (DSVI) spatial benchmark over 10 shuffled splits.

Counterpart of ``nonstationary_precip_tpu/experiments/deepgp_spatial.py``:
uib_spatial.csv → per split, sklearn-style shuffle (random_state = split)
→ whitening (or Box-Cox) → contiguous 80/20 cut → DeepGP (2 distinct
hidden layers 2 → 2 → 2 with linear means, a scalar head with a constant
mean, M = 250; ``--model shared`` ties the hidden layers as the reference
does) → 400 epochs × batch 315 × S = 3 DSVI samples, Adam lr 0.01, all
splits in lockstep on one stacked model → RMSE/NLPD from 10 predictive
samples, mean ± stderr.  The data term of each step is the fused one (K7)
for the distinct-layer model, after one K4 call for every layer's factors.

Randomness comes from the caller, as everywhere in the port: each split's
init z comes from ``torch.Generator().manual_seed(BASE_SEED + split)``, and
its ε for every training step and for the prediction from
``np.random.default_rng(BASE_SEED + split)``, drawn up front and uploaded
once.  The batch schedule is the JAX package's, bit for bit.

Metric semantics as the reference: RMSE over the S-sample-expanded
predictive means, NLPD the mean per-point Gaussian log density of each
sample path plus log σ_y.

Run: python -m nonstationary_precip_tpu_torch.experiments.deepgp_spatial [--device cuda|cpu]
"""

from __future__ import annotations

import math
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
from nonstationary_precip_tpu_torch.models.deep_gp import NUM_OUTPUT_DIMS, DeepGP
from nonstationary_precip_tpu_torch.ops import elbo_fused, svgp_precompute
from nonstationary_precip_tpu_torch.train.config import ExperimentConfig
from nonstationary_precip_tpu_torch.train.optim import fit_minibatched, fit_minibatched_splits, num_minibatch_steps
from nonstationary_precip_tpu_torch.train.vmapped import eval_splits
from nonstationary_precip_tpu_torch.utils.config import BASE_SEED, DATASET_DIR, device

#: Predictive samples for the metrics (the JAX ``_metrics_fn``'s).
NUM_PRED_SAMPLES = 10


def default_config() -> ExperimentConfig:
    """The experiment's configuration: the JAX ``main``'s."""
    return ExperimentConfig(model="whitening", lr=0.01, num_epochs=400, num_samples=3, num_layers=2,
                            batch_size=315, num_inducing=250)


def draw_eps(rng: np.random.Generator, lead: tuple, num_hidden: int, n: int) -> tuple:
    """One float32 standard-normal array (*lead, O, n) per hidden layer, from
    one draw of ``rng``."""
    z = rng.standard_normal((*lead, num_hidden, NUM_OUTPUT_DIMS, n), dtype=np.float32)
    return tuple(np.ascontiguousarray(z[..., i, :, :]) for i in range(num_hidden))


def prep_split(data, random_state: int, cfg: ExperimentConfig, dtype=torch.float32, dev=None):
    """Host-side per-split prep: shuffle, transform and cut (numpy), the model
    init, and the split's ε for every training step and for the prediction,
    on ``dev`` (default: ``cfg.device``, which raises where it names a card
    that is not there).
    Returns (model, (train_x, train_y, test_x, test_y), stdy, eps_train,
    eps_pred); each ε is a tuple of per-hidden-layer tensors, (T, S, O, B)
    and (S_pred, O, N_test)."""
    dev = device(cfg.device) if dev is None else dev
    shuffled = sklearn_style_shuffle(data, random_state)
    if cfg.model == "boxcox":
        bc = box_cox_transform(shuffled)
        x_tr, y_tr, stdy = bc.x, bc.y, 1.0
    else:
        w = whitening_transform(shuffled)
        x_tr, y_tr, stdy = w.x, w.y, w.stdy
    arrays = train_test_split(x_tr, y_tr, cfg.train_percent / 100)
    train_x, train_y, test_x, test_y = (torch.as_tensor(a, dtype=dtype, device=dev) for a in arrays)
    model = DeepGP.create(torch.Generator().manual_seed(int(BASE_SEED + random_state)), input_dims=train_x.shape[-1],
                          num_layers=cfg.num_layers, num_inducing=cfg.num_inducing,
                          share_hidden=cfg.model == "shared", dtype=dtype, device=dev)
    n = train_x.shape[0]
    steps = num_minibatch_steps(n, cfg.num_epochs, cfg.batch_size)
    rng = np.random.default_rng(BASE_SEED + random_state)
    eps_train = draw_eps(rng, (steps, cfg.num_samples), cfg.num_layers, min(cfg.batch_size, n))
    eps_pred = draw_eps(rng, (NUM_PRED_SAMPLES,), cfg.num_layers, test_x.shape[0])

    def up(eps):
        return tuple(torch.as_tensor(e, dtype=dtype, device=dev) for e in eps)

    return model, (train_x, train_y, test_x, test_y), torch.as_tensor(stdy, dtype=dtype, device=dev), \
        up(eps_train), up(eps_pred)


def _metrics_fn(m, eps, xte, yte, sy):
    """RMSE/NLPD with the reference's semantics: RMSE over the (S, N)
    sample-expanded means, NLPD the mean per-point Gaussian log density over
    the S sample paths, plus log σ_y.  Reduces the last two axes, so a
    leading split axis passes through."""
    _, means, variances = m.predict(xte, eps)
    err = means - yte[..., None, :]
    r = sy * torch.sqrt(torch.mean(err**2, dim=(-2, -1)))
    lpd = -0.5 * (err**2 / variances + torch.log(2 * math.pi * variances))
    nl = -torch.mean(lpd, dim=(-2, -1)) + torch.log(sy)
    return r, nl


def _loss_fn(n: int):
    """The DSVI loss with the full training-set N for the KL scaling."""
    def loss_fn(m, eps, xb, yb):
        return m.loss(xb, yb, num_data=n, eps=eps)

    return loss_fn


def run_one_split(data, random_state: int, cfg: ExperimentConfig, dev=None):
    """Sequential single-split fit: the oracle for the lockstep ``run``, on
    ``dev`` (default: ``cfg.device``, which raises where it names a card
    that is not there).  Returns (RMSE, NLPD, TrainResult)."""
    dev = device(cfg.device) if dev is None else dev
    model, (train_x, train_y, test_x, test_y), stdy, eps_train, eps_pred = prep_split(
        data, random_state, cfg, dev=dev)
    res = fit_minibatched(model, _loss_fn(train_x.shape[0]), train_x, train_y, eps_train,
                          num_epochs=cfg.num_epochs, batch_size=cfg.batch_size, lr=cfg.lr, seed=random_state)
    with torch.no_grad():
        r, nl = _metrics_fn(res.model, eps_pred, test_x, test_y, stdy)
    return float(r), float(nl), res


def run(cfg: ExperimentConfig) -> dict:
    """The whole experiment; returns what ``main`` reports, plus the
    per-step per-split losses, the timings and the trained stacked model."""
    dev = device(cfg.device)
    dtype = torch.float32
    if dev.type == "cuda":  # compile K4 and K7 before the timed loop, not inside it
        svgp_precompute.build()
        elbo_fused.build()
    data = load_csv(DATASET_DIR / "uib_spatial.csv")
    preps = [prep_split(data, rs, cfg, dtype, dev) for rs in range(cfg.num_splits)]
    n = preps[0][1][0].shape[0]

    t_wall = time.perf_counter()
    # all K splits train in lockstep as one stacked model and evaluate as one
    # batched call
    res = fit_minibatched_splits(
        [p[0] for p in preps], _loss_fn(n), [p[1][0] for p in preps], [p[1][1] for p in preps],
        [p[3] for p in preps], num_epochs=cfg.num_epochs, batch_size=cfg.batch_size, lr=cfg.lr,
        seeds=list(range(cfg.num_splits)))
    rmses_t, nlpds_t = eval_splits(res.model, _metrics_fn, [p[4] for p in preps], [p[1][2] for p in preps],
                                   [p[1][3] for p in preps], [p[2] for p in preps])
    rmses, nlpds = rmses_t.cpu().numpy(), nlpds_t.cpu().numpy()
    wall_s = time.perf_counter() - t_wall
    last = res.losses[-1]
    for rs in range(cfg.num_splits):
        print(f"split {rs}: final loss {last[rs]:.4f}  RMSE {rmses[rs]:.4f}  NLPD {nlpds[rs]:.4f}")
    k = len(rmses)
    print(f"{np.mean(rmses):.4f} ± {np.std(rmses)/np.sqrt(k):.4f}")
    print(f"{np.mean(nlpds):.4f} ± {np.std(nlpds)/np.sqrt(k):.4f}")
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
        "model": res.model,
    }


def main(argv=None):
    out = run(default_config().parse_args(argv))
    return out["rmse"], out["nlpd"]


if __name__ == "__main__":
    main()
