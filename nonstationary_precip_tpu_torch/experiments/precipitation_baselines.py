#!/usr/bin/env python3
"""Production-style training driver: config → split → train → observe →
checkpoint → early stop.

Counterpart of ``nonstationary_precip_tpu/experiments/precipitation_baselines.py``
(the reference's most framework-like driver): the full CLI config, a
censored-region or random test split, k-means inducing points, a JSONL (and,
where ``tensorboardX`` imports, TensorBoard) log of the hypers and metrics,
rolling best / best-RMSE / best-NLPD checkpoints, an early stop on
|Δloss| < threshold, a final checkpoint and ``--resume`` from any of them.

Data: any CSV with columns [x..., y]; ``--data`` defaults to the bundled UIB
spatial field.  A netCDF path goes to ``data/dataprep.load_netcdf_precip``,
which needs xarray and raises without it, as the JAX package's does.

Models: ``--model DiagonalGibbs`` (the Gibbs GP with its LogNormal-process
prior; ``--inference exact`` or ``sparse``, whose k-means starts at the
split's row ``spatial_gibbs.first_centre(0, n)`` where JAX draws it from
``PRNGKey(BASE_SEED)``), anything else the SE-ARD ``ExactGP``.  On the card
the exact Gibbs loss takes K9 (its Gram) at the bundled data's N and K8 at
768 ≤ N ≤ 1280, the sparse one K9 twice a step, and each predictive K9 (and
K10a and K11 where their gates admit it).

``--plot_interval`` draws the predictive mean and σ (and the lengthscale
field) with ``utils/plotting`` into TensorBoard.  Where matplotlib does not
import, the driver says so once and draws nothing; the JAX driver swallows
every exception of that step instead.

Run: python -m nonstationary_precip_tpu_torch.experiments.precipitation_baselines \\
       --model DiagonalGibbs --inference sparse --max_iters 2000 [--device cpu]
"""

from __future__ import annotations

import math
import time
from pathlib import Path

import numpy as np
import torch

from nonstationary_precip_tpu_torch.data.dataprep import load_csv, load_netcdf_precip
from nonstationary_precip_tpu_torch.experiments.spatial_gibbs import first_centre
from nonstationary_precip_tpu_torch.kernels.base import Scale
from nonstationary_precip_tpu_torch.kernels.stationary import RBF
from nonstationary_precip_tpu_torch.models.exact_gp import ExactGP
from nonstationary_precip_tpu_torch.models.gibbs_gp import GibbsExactGP, GibbsSparseGP
from nonstationary_precip_tpu_torch.ops.kmeans import kmeans_inducing_points
from nonstationary_precip_tpu_torch.priors.lognormal_process import LogNormalProcess
from nonstationary_precip_tpu_torch.train.checkpoint import BestCheckpointer, restore_pytree, save_pytree
from nonstationary_precip_tpu_torch.train.config import ExperimentConfig
from nonstationary_precip_tpu_torch.train.logging import MetricsLogger, param_table
from nonstationary_precip_tpu_torch.train.metrics import nlpd_joint, rmse_raw, rmse_rescaled
from nonstationary_precip_tpu_torch.train.optim import fit
from nonstationary_precip_tpu_torch.utils.config import DATASET_DIR, device

DTYPE = torch.float32


def censored_split(x: np.ndarray, y: np.ndarray, rng, frac=0.2):
    """Censored-region test split: hold out the ``frac`` of rows nearest (in
    the first two columns) to a random row (the reference's 'censored'
    test_type, precipitation_baselines.py:170-204)."""
    centre = x[rng.integers(len(x))]
    d = np.linalg.norm(x[:, :2] - centre[:2], axis=-1)
    n_test = int(frac * len(x))
    test_idx = np.argsort(d)[:n_test]
    mask = np.ones(len(x), dtype=bool)
    mask[test_idx] = False
    return x[mask], y[mask], x[~mask], y[~mask]


def random_split(x, y, rng, frac=0.2):
    idx = rng.permutation(len(x))
    n_test = int(frac * len(x))
    te, tr = idx[:n_test], idx[n_test:]
    return x[tr], y[tr], x[te], y[te]


def default_config() -> ExperimentConfig:
    return ExperimentConfig(data=str(DATASET_DIR / "uib_spatial.csv"), model="DiagonalGibbs", max_iters=2000,
                            log_interval=50, test_interval=200)


def load_data(cfg: ExperimentConfig) -> dict:
    """The standardised (ddof = 1) columns split by ``cfg.test_type`` from
    ``default_rng(cfg.seed)``, in float64 numpy, with the scales."""
    path = str(cfg.data)
    data = load_netcdf_precip(path) if path.endswith((".nc", ".nc4", ".cdf")) else load_csv(path)
    x, y = data[:, :-1], data[:, -1]
    meanx, stdx = x.mean(0), x.std(0, ddof=1)
    meany, stdy = y.mean(), y.std(ddof=1)
    rng = np.random.default_rng(cfg.seed)
    split = censored_split if cfg.test_type == "censored" else random_split
    x_tr, y_tr, x_te, y_te = split((x - meanx) / stdx, (y - meany) / stdy, rng, frac=1 - cfg.train_percent / 100)
    return {"x_train": x_tr, "y_train": y_tr, "x_test": x_te, "y_test": y_te, "meanx": meanx, "stdx": stdx,
            "stdy": float(stdy)}


def build_model(cfg: ExperimentConfig, x_train: torch.Tensor) -> torch.nn.Module:
    """The configured model at x_train's dtype and device, its trainable
    parameters set as the JAX driver's mask sets them."""
    dtype, dev, d = x_train.dtype, x_train.device, x_train.shape[-1]
    if cfg.model != "DiagonalGibbs":  # the stationary SE-ARD baseline, all of it trains
        return ExactGP.create(Scale.create(RBF.create(d, dtype=dtype, device=dev), dtype=dtype, device=dev),
                              mean_type="zero", dtype=dtype, device=dev)
    noise = cfg.noise if cfg.noise > 0 else None
    scale = cfg.scale if cfg.scale > 0 else 1.0
    prior = LogNormalProcess.create(d, mean=math.log(cfg.prior_mean), outputscale=cfg.prior_scale,
                                    lengthscale=cfg.prior_ell, dtype=dtype, device=dev)
    if cfg.inference == "sparse":
        z = kmeans_inducing_points(first_centre(0, x_train.shape[0]), x_train, cfg.num_inducing)
        model = GibbsSparseGP.create(z, prior, noise=noise, outputscale=scale, dtype=dtype, device=dev)
    else:
        model = GibbsExactGP.create(x_train, prior, noise=noise, outputscale=scale, dtype=dtype, device=dev)
    return model.trainable(train_noise=cfg.noise == 0, train_scale=cfg.scale == 0)


def metrics(model, tensors, stdy: float) -> tuple:
    """(predictive, RMSE in σ_y units, raw RMSE, joint NLPD) at the test rows."""
    x_train, y_train, x_test, y_test = tensors
    with torch.no_grad():
        pred = model.predictive(x_train, y_train, x_test)
        return pred, rmse_rescaled(pred.mean, y_test, stdy), rmse_raw(pred.mean, y_test), nlpd_joint(pred, y_test, stdy)


class _Plotter:
    """The plot step: the predictive mean and σ (and the first lengthscale
    dim, where the model has a field) at the test rows, into ``logger``.
    Without matplotlib it says so once and draws nothing."""

    def __init__(self, logger: MetricsLogger, data: dict, tensors):
        self.logger, self.tensors = logger, tensors
        x_te = data["x_test"]
        self.lon = x_te[:, 0] * data["stdx"][0] + data["meanx"][0]
        self.lat = x_te[:, 1] * data["stdx"][1] + data["meanx"][1]
        self.missing = None

    def __call__(self, step: int, model):
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            if self.missing is None:
                self.missing = str(e)
                print(f"plot_interval: matplotlib does not import ({e}); drawing no figures")
            return
        from nonstationary_precip_tpu_torch.utils.plotting import simple_plot

        x_train, y_train, x_test, _ = self.tensors
        with torch.no_grad():
            pred = model.predictive(x_train, y_train, x_test)
            figs = {"pred_mean": (pred.mean, "mean"), "pred_std": (torch.sqrt(pred.var), "std")}
            if hasattr(model, "lengthscale_field"):
                figs["lengthscale_0"] = (model.lengthscale_field(x_train, x_test)[:, 0], "ell0")
        for tag, (values, title) in figs.items():
            self.logger.figure(step, tag, simple_plot(self.lon, self.lat, values.cpu().numpy(), title))


def run(cfg: ExperimentConfig) -> dict:
    """The driver on ``cfg``: returns the final RMSE and NLPD, the fit's
    steps, losses and seconds, the trained model, the float32 tensors
    (x_train, y_train, x_test, y_test) and the run directory."""
    dev = device(cfg.device)
    name = cfg.name or f"{cfg.model}_{cfg.inference}_{int(time.time())}"
    logdir = Path(cfg.logdir) / name
    cfg.dump(logdir / "config.json")
    logger = MetricsLogger(logdir, name="train")
    ckpt = BestCheckpointer(logdir)

    data = load_data(cfg)
    tensors = tuple(torch.as_tensor(data[k], dtype=DTYPE, device=dev)
                    for k in ("x_train", "y_train", "x_test", "y_test"))
    stdy = data["stdy"]
    model = build_model(cfg, tensors[0])
    if cfg.resume:
        # the reference writes checkpoints but has no resume path
        model = restore_pytree(Path(cfg.resume) / "model", model)
        print(f"resumed model from {cfg.resume}")
    table = param_table(model)
    print(table)
    (logdir / "params.txt").write_text(table)
    save_pytree(logdir / "init_model" / "model", model)  # the reference's init_model.pt
    plot = _Plotter(logger, data, tensors)

    def callback(steps_done, m, losses):
        loss = float(losses[-1])
        scalars = {"objective": loss, "noise": float(m.likelihood.noise)}
        if hasattr(m, "outputscale"):
            scalars["outputscale"] = float(m.outputscale)
        # per-dim kernel lengthscales (reference precipitation_baselines.py:296-304)
        base = getattr(getattr(m, "kernel", None), "base", None)
        if base is not None and hasattr(base, "lengthscale"):
            for i, v in enumerate(base.lengthscale.detach().cpu().numpy().ravel()):
                scalars[f"lengthscale_{i}"] = float(v)
        if steps_done % cfg.test_interval == 0 or steps_done >= cfg.max_iters:
            _, r, rr, nl = metrics(m, tensors, stdy)
            scalars.update(rmse=float(r), rmse_raw=float(rr), nlpd=float(nl))
            ckpt.update(steps_done, m, objective=loss, rmse=scalars["rmse"], nlpd=scalars["nlpd"])
        if cfg.plot_interval and (steps_done % cfg.plot_interval == 0 or steps_done >= cfg.max_iters):
            plot(steps_done, m)
        logger.scalars(steps_done, **scalars)

    res = fit(model, lambda m, xx, yy: m.loss(xx, yy), tensors[0], tensors[1], lr=cfg.lr, num_steps=cfg.max_iters,
              threshold=cfg.threshold, chunk=cfg.log_interval, callback=callback)
    ckpt.save_final(res.steps, res.model)
    _, r, _, nl = metrics(res.model, tensors, stdy)
    r, nl = float(r), float(nl)
    last = float(res.losses[-1]) if len(res.losses) else float("nan")
    print(f"final: steps {res.steps}  loss {last:.4f}  RMSE {r:.4f}  NLPD {nl:.4f}")
    logger.close()
    return {"rmse": r, "nlpd": nl, "steps": res.steps, "losses": res.losses, "seconds": res.seconds,
            "model": res.model, "tensors": tensors, "stdy": stdy, "logdir": logdir}


def main(argv=None):
    out = run(default_config().parse_args(argv))
    return out["rmse"], out["nlpd"]


if __name__ == "__main__":
    main()
