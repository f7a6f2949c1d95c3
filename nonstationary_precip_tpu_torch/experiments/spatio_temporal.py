#!/usr/bin/env python3
"""UIB spatio-temporal precipitation: stationary against nonstationary.

Counterpart of ``nonstationary_precip_tpu/experiments/spatio_temporal.py``:
``uib_spatio_temporal.csv``, year-2000 months 1-4 train (172 rows) and month
5 test (43), ``--model Stationary`` (exact GP, separable sum kernel) or
``--model Non-Stationary`` (sparse spatial Gibbs plus sparse temporal on
shared frozen k-means inducing inputs), Adam lr 0.015 × 500, RMSE
(σ-rescaled) and per-point NLPD, then the predictive at all 215 rows of
the five months written as ``st_<model>_means_sigmas.csv``
(pred,std,time,lon,lat) under ``results_dir()``, with numpy, and the
5-month facet figure of the predictive mean (mm/day) as
``st_<model>_facets.png`` (``utils/plotting.facetgrid_plot``).

The k-means seed row is drawn by ``np.random.default_rng(BASE_SEED)``
(``first_centre``), where the JAX experiment draws it from
``PRNGKey(BASE_SEED)``.  The JAX default of 500 inducing inputs exceeds
the 172 training rows, so k-means repeats centres and K_zz is singular
(``safe_cholesky``'s jitter decides); the quality band's run passes
``--num_inducing 100``.  matplotlib is imported only to draw the figure:
where it is missing (the card's machine) the run says so once and draws
nothing; any other failure of the figure raises, where the JAX experiment
swallows every exception (as the production driver's plot step, ROADMAP
§3 P1).

Run: python -m nonstationary_precip_tpu_torch.experiments.spatio_temporal --model Non-Stationary [--device cuda|cpu]
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from nonstationary_precip_tpu_torch.data.datasets import spatio_temporal_month_split
from nonstationary_precip_tpu_torch.models.spatio_temporal import (
    SparseSpatioTemporalNonstationary,
    SpatioTemporalStationary,
)
from nonstationary_precip_tpu_torch.ops import gibbs_gram
from nonstationary_precip_tpu_torch.ops.kmeans import kmeans_inducing_points
from nonstationary_precip_tpu_torch.priors.lognormal_process import LogNormalProcess
from nonstationary_precip_tpu_torch.train.config import ExperimentConfig
from nonstationary_precip_tpu_torch.train.metrics import nlpd_marginal, rmse_rescaled
from nonstationary_precip_tpu_torch.train.optim import fit
from nonstationary_precip_tpu_torch.utils.config import BASE_SEED, device, results_dir


def default_config() -> ExperimentConfig:
    """The experiment's configuration: the JAX ``main``'s."""
    return ExperimentConfig(model="Stationary", lr=0.015, max_iters=500, num_inducing=500)


def first_centre(n: int) -> int:
    """The k-means seed row among the n training rows."""
    return int(np.random.default_rng(BASE_SEED).integers(n))


def make_model(cfg: ExperimentConfig, x_train: torch.Tensor, dtype=torch.float32):
    """The configured model on ``x_train``'s device, with the JAX
    experiment's trainability."""
    dev = x_train.device
    if not cfg.model.lower().startswith("non"):
        return SpatioTemporalStationary.create(dtype=dtype, device=dev)
    prior = LogNormalProcess.create(input_dim=2, mean=math.log(cfg.prior_mean), outputscale=cfg.prior_scale,
                                    lengthscale=cfg.prior_ell, dtype=dtype, device=dev)
    z = kmeans_inducing_points(first_centre(x_train.shape[0]), x_train, cfg.num_inducing)
    return SparseSpatioTemporalNonstationary.create(z, prior, dtype=dtype, device=dev)


def run(cfg: ExperimentConfig) -> dict:
    """The whole experiment; returns what ``main`` reports, plus the loss
    trace, the timings, the trained model and the field CSV's path."""
    dev = device(cfg.device)
    dtype = torch.float32
    if dev.type == "cuda":  # compile K9 before the timed loop, not inside it
        gibbs_gram.build()
    x_train, y_train, x_test, y_test, meany, stdy, x_norm, _ = spatio_temporal_month_split()
    x_train, y_train, x_test, y_test, x_all = (torch.as_tensor(a, dtype=dtype, device=dev)
                                               for a in (x_train, y_train, x_test, y_test, x_norm))
    t_wall = time.perf_counter()
    model = make_model(cfg, x_train, dtype)
    res = fit(model, lambda m, xx, yy: m.loss(xx, yy), x_train, y_train, lr=cfg.lr, num_steps=cfg.max_iters)
    with torch.no_grad():
        p = res.model.predictive(x_train, y_train, x_test)
        r, nl = float(rmse_rescaled(p.mean, y_test, stdy)), float(nlpd_marginal(y_test, p.mean, p.var))
        pf = res.model.predictive(x_train, y_train, x_all)
        field = np.column_stack([pf.mean.cpu().numpy(), np.sqrt(pf.var.cpu().numpy()), x_norm[:, 0], x_norm[:, 1],
                                 x_norm[:, 2]])
    wall_s = time.perf_counter() - t_wall
    print(f"RMSE test = {r:.4f}")
    print(f"NLPD test = {nl:.4f}")
    out_dir = results_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    csv_path = out_dir / f"st_{cfg.model.lower()}_means_sigmas.csv"
    np.savetxt(csv_path, field, delimiter=",", header="pred,std,time,lon,lat", comments="", fmt="%.9g")
    facets = facet_figure(field[:, 0] * stdy + meany, x_norm, cfg.model,
                          out_dir / f"st_{cfg.model.lower()}_facets.png")
    print(f"train: {res.steps} steps; wall {wall_s:.2f} s on {dev}")
    return {"rmse": r, "nlpd": nl, "losses": res.losses, "steps": res.steps, "train_seconds": res.seconds,
            "wall_seconds": wall_s, "model": res.model, "csv": csv_path, "facets": facets}


def facet_figure(mean_f: np.ndarray, x_norm: np.ndarray, model: str, path):
    """The 5-month facet map of the predictive mean (mm/day) at every row,
    one panel a month (JAX ``spatio_temporal.py:118-136``), written to
    ``path``; returns the path, or None (and says so) without matplotlib."""
    from nonstationary_precip_tpu_torch.utils.plotting import facetgrid_plot, pyplot

    if pyplot("the facet figure") is None:
        return None

    months = sorted(np.unique(x_norm[:, 0]))
    first = x_norm[:, 0] == months[0]
    facetgrid_plot(x_norm[first, 1], x_norm[first, 2], [mean_f[x_norm[:, 0] == t] for t in months],
                   suptitle=f"{model} predictive mean (mm/day)", savepath=path)
    return path


def main(argv=None):
    out = run(default_config().parse_args(argv))
    return out["rmse"], out["nlpd"]


if __name__ == "__main__":
    main()
