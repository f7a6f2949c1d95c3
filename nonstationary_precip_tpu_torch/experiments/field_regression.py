#!/usr/bin/env python3
"""Artifact-level regression against the reference's shipped DGP2 fields.

Counterpart of ``nonstationary_precip_tpu/experiments/field_regression.py``.
The reference publishes two predicted precipitation fields of its DGP2,
vendored under ``data/reference_artifacts/``:

* ``f_mean_sigma_dgp2.csv``: the 394-site UIB spatial field in raw mm/day
  (pred, std, lat, lon);
* ``dgp2_spatio_temporal_means_sigmas.csv``: a 394-site field in an
  unrecorded normalisation, so only its spatial pattern is an oracle.

This experiment trains the port's DeepGP counterparts and scores the drift:

* spatial (``spatial_field``): the split-0 configuration of deepgp_spatial
  (whitened, 315 training rows, 2 → 2 → 2 → 1, M = 250, S = 3, 400
  epochs), one model; the field at all 394 sites against the reference's
  (Pearson correlation and RMSE) and against the ground truth.  Its data
  term goes through the fused kernel (K7) on the card;
* spatio-temporal (``st_field_pattern``, with ``--model both``): a DeepGP on
  (time, lon, lat), months 1-4 of 2000 → month 5, its pattern correlation
  with the reference's at the 43 sites they share.  D = 3 is outside K7's
  gate, so it takes the composed data term.

Randomness comes from the caller, as everywhere in the port: each model's
init z comes from ``torch.Generator().manual_seed(BASE_SEED)``, its ε for
every training step and for the prediction from
``np.random.default_rng(BASE_SEED)``, drawn up front.  The site joins on
(lat, lon) are pandas' inner merges, done in numpy; the field goes to
``results_dir()/f_mean_sigma_dgp2_torch.csv``.

``main`` returns (RMSE vs the reference field, 1 − its correlation), the
pair the ``dgp_field_regression`` band of run_benchmarks.py holds.

Run: python -m nonstationary_precip_tpu_torch.experiments.field_regression [--model both|spatial] [--device cuda|cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nonstationary_precip_tpu_torch.data.dataprep import (
    load_csv,
    sklearn_style_shuffle,
    train_test_split,
    whitening_transform,
)
from nonstationary_precip_tpu_torch.data.datasets import (
    load_uib_spatio_temporal,
    read_columns,
    spatio_temporal_month_split,
)
from nonstationary_precip_tpu_torch.experiments.deepgp_spatial import NUM_PRED_SAMPLES, draw_eps
from nonstationary_precip_tpu_torch.models.deep_gp import DeepGP
from nonstationary_precip_tpu_torch.ops import elbo_fused, svgp_precompute
from nonstationary_precip_tpu_torch.train.config import ExperimentConfig
from nonstationary_precip_tpu_torch.train.optim import fit_minibatched, num_minibatch_steps
from nonstationary_precip_tpu_torch.utils.config import BASE_SEED, DATASET_DIR, device, results_dir

ARTIFACTS = "reference_artifacts"
FIELD_COLUMNS = ("", "pred", "std", "lat", "lon")
FIELD_CSV = "f_mean_sigma_dgp2_torch.csv"
ST_BATCH = 1024  # the spatio-temporal model's batch (the JAX experiment's min(1024, n))


def default_config() -> ExperimentConfig:
    """The experiment's configuration: the JAX ``main``'s."""
    return ExperimentConfig(model="both", lr=0.01, num_epochs=400, num_samples=3, num_layers=2, batch_size=315,
                            num_inducing=250)


def _mixture_moments(means, variances):
    """Gaussian-mixture mean and variance over the sample axis."""
    mu = means.mean(axis=0)
    return mu, (variances + means**2).mean(axis=0) - mu**2


def init_model(cfg: ExperimentConfig, input_dims: int, dev, dtype=torch.float32, draw_seed: int = BASE_SEED):
    """The DeepGP that ``_fit_predict`` trains, before its first step."""
    return DeepGP.create(torch.Generator().manual_seed(draw_seed), input_dims=input_dims,
                         num_layers=cfg.num_layers, num_inducing=cfg.num_inducing, dtype=dtype, device=dev)


def _fit_predict(x, y, x_pred, cfg: ExperimentConfig, batch_size: int, seed: int, num_pred: int, dev,
                 dtype=torch.float32, draw_seed: int = BASE_SEED):
    """One DeepGP on (x, y) with the experiment's randomness, and its
    predictive mixture at x_pred.  ``draw_seed`` seeds the init and the ε
    (the experiments' BASE_SEED), ``seed`` the batch schedule.  Returns
    (mixture, per-sample means, per-sample variances, TrainResult)."""
    x, y, x_pred = (torch.as_tensor(a, dtype=dtype, device=dev) for a in (x, y, x_pred))
    n = x.shape[0]
    batch_size = min(batch_size, n)
    model = init_model(cfg, x.shape[-1], dev, dtype, draw_seed)
    rng = np.random.default_rng(draw_seed)
    steps = num_minibatch_steps(n, cfg.num_epochs, batch_size)
    eps_train, eps_pred = (tuple(torch.as_tensor(e, dtype=dtype, device=dev) for e in eps) for eps in (
        draw_eps(rng, (steps, cfg.num_samples), cfg.num_layers, batch_size),
        draw_eps(rng, (num_pred,), cfg.num_layers, x_pred.shape[0])))

    def loss_fn(m, eps, xb, yb):
        return m.loss(xb, yb, num_data=n, eps=eps)

    res = fit_minibatched(model, loss_fn, x, y, eps_train, num_epochs=cfg.num_epochs, batch_size=batch_size,
                          lr=cfg.lr, seed=seed)
    with torch.no_grad():
        dist, means, variances = res.model.predict(x_pred, eps_pred)
    return dist, means, variances, res


def spatial_field(cfg: ExperimentConfig, dev=None):
    """Train the spatial DeepGP (split 0 of deepgp_spatial, whitened) and
    predict the field at all 394 sites in raw mm/day, in the CSV's row
    order, on ``dev`` (default: ``cfg.device``, which raises where it names
    a card that is not there).  Returns ({pred, std, lat, lon, tp},
    TrainResult)."""
    dev = device(cfg.device) if dev is None else dev
    data = load_csv(DATASET_DIR / "uib_spatial.csv")
    w = whitening_transform(sklearn_style_shuffle(data, 0))
    train_x, train_y, _, _ = train_test_split(w.x, w.y, cfg.train_percent / 100)
    x_all = (data[:, :2] - w.meanx) / w.stdx
    _, means, variances, res = _fit_predict(train_x, train_y, x_all, cfg, cfg.batch_size, 0, NUM_PRED_SAMPLES, dev)
    mu_w, var_w = _mixture_moments(means.double().cpu().numpy(), variances.double().cpu().numpy())
    field = {"pred": mu_w * w.stdy + w.meany, "std": np.sqrt(var_w) * w.stdy, "lat": data[:, 1], "lon": data[:, 0],
             "tp": data[:, 2]}
    return field, res


def st_field_pattern(cfg: ExperimentConfig, dev=None):
    """The month-5 site field of the spatio-temporal DeepGP in raw space, one
    row per test site (the split's row order), on ``dev`` (default:
    ``cfg.device``).  Returns (field, TrainResult)."""
    dev = device(cfg.device) if dev is None else dev
    x_train, y_train, x_test, _, meany, stdy, _, _ = spatio_temporal_month_split()
    dist, _, _, res = _fit_predict(x_train, y_train, x_test, cfg, ST_BATCH, BASE_SEED, cfg.num_samples, dev)
    return dist.mean.double().cpu().numpy() * stdy + meany, res


def _inner_join(left_lat, left_lon, right_lat, right_lon):
    """Row indices (left, right) of pandas' inner merge on (lat, lon): the
    left rows in order, each with its matching right rows in order."""
    right = {}
    for j, key in enumerate(zip(right_lat.tolist(), right_lon.tolist())):
        right.setdefault(key, []).append(j)
    pairs = [(i, j) for i, key in enumerate(zip(left_lat.tolist(), left_lon.tolist())) for j in right.get(key, ())]
    li, ri = zip(*pairs) if pairs else ((), ())
    return np.array(li, dtype=np.int64), np.array(ri, dtype=np.int64)


def _corr(a, b) -> float:
    return float(np.corrcoef(a, b)[0, 1])


def _month_sites(month: int) -> np.ndarray:
    """(time, lon, lat) of the year-2000 rows of uib_spatio_temporal.csv whose
    dense time rank is ``month``, in CSV row order (the JAX experiment's
    ``d2[d2["month"] == month]``)."""
    _, x, _ = load_uib_spatio_temporal()
    x = x[x[:, 0] < 2001]
    return x[np.unique(x[:, 0], return_inverse=True)[1] + 1 == month]


def run(cfg: ExperimentConfig) -> dict:
    """The whole experiment; returns the field metrics, the steps and
    seconds of each half, and the field."""
    if cfg.model not in ("both", "spatial"):
        raise ValueError(f"--model is both or spatial, got {cfg.model!r}")
    dev = device(cfg.device)
    if dev.type == "cuda":  # compile the kernels before the timed loops, not inside them
        svgp_precompute.build()
        elbo_fused.build()
    t_wall = time.perf_counter()
    ref = read_columns(f"{ARTIFACTS}/f_mean_sigma_dgp2.csv", FIELD_COLUMNS)
    ref_pred, ref_lat, ref_lon = ref[:, 1], ref[:, 3], ref[:, 4]
    ours, res = spatial_field(cfg, dev)
    li, ri = _inner_join(ref_lat, ref_lon, ours["lat"], ours["lon"])
    if len(li) != len(ref):
        raise RuntimeError(f"site join must be exact: {len(li)} of {len(ref)} reference sites matched")
    pred_ref, pred_ours, tp = ref_pred[li], ours["pred"][ri], ours["tp"][ri]
    out = {
        "rmse_vs_ref": float(np.sqrt(np.mean((pred_ref - pred_ours) ** 2))),
        "corr_vs_ref": _corr(pred_ref, pred_ours),
        "corr_truth": _corr(tp, pred_ours),
        "corr_truth_ref": _corr(tp, pred_ref),
        "spatial_steps": res.steps,
        "spatial_train_seconds": res.seconds,
        "field": ours,
    }
    out_dir = results_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    # the JAX experiment's pandas to_csv: an index column, then pred/std/lat/lon
    table = np.column_stack([np.arange(len(ours["pred"])), *(ours[k] for k in FIELD_COLUMNS[1:])])
    np.savetxt(out_dir / FIELD_CSV, table, delimiter=",", header=",".join(FIELD_COLUMNS), comments="",
               fmt=["%d"] + ["%.17g"] * 4)
    print(f"spatial field: corr vs reference artifact {out['corr_vs_ref']:.4f}, rmse {out['rmse_vs_ref']:.4f} mm/day")
    print(f"spatial field: corr vs ground truth — ours {out['corr_truth']:.4f}, "
          f"reference {out['corr_truth_ref']:.4f}")

    if cfg.model == "both":
        st_ref = read_columns(f"{ARTIFACTS}/dgp2_spatio_temporal_means_sigmas.csv", FIELD_COLUMNS)
        st_cfg = ExperimentConfig(lr=0.01, num_epochs=max(cfg.num_epochs // 2, 50), num_samples=10, num_layers=2,
                                  batch_size=ST_BATCH, num_inducing=cfg.num_inducing, device=cfg.device)
        st_pred, st_res = st_field_pattern(st_cfg, dev)
        # the test month's sites, in the split's row order (its time
        # column is month 5 of 2000)
        x_st = _month_sites(5)
        li, ri = _inner_join(st_ref[:, 3], st_ref[:, 4], x_st[:, 2], x_st[:, 1])
        out["st_corr"] = _corr(st_ref[li, 1], st_pred[ri])
        out["st_sites"] = len(li)
        out["st_steps"] = st_res.steps
        out["st_train_seconds"] = st_res.seconds
        print(f"ST field: pattern corr vs reference artifact at {len(li)} sites = {out['st_corr']:.4f}")
    out["wall_seconds"] = time.perf_counter() - t_wall
    return out


def main(argv=None):
    out = run(default_config().parse_args(argv))
    return out["rmse_vs_ref"], 1.0 - out["corr_vs_ref"]


if __name__ == "__main__":
    main()
