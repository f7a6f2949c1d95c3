"""Carry model weights from the JAX package into the port.

The JAX package's models are pytrees; a caller flattens one to a dict of
numpy arrays keyed by dotted leaf path (the port never imports jax), and the
functions here build the port's module from it.  Leaves may be single
(one model) or stacked on a leading split axis (K models at once).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Mapping

import numpy as np
import torch
from torch import nn

from nonstationary_precip_tpu_torch.kernels.base import Scale
from nonstationary_precip_tpu_torch.kernels.stationary import RBF
from nonstationary_precip_tpu_torch.models.deep_gp import DeepGP
from nonstationary_precip_tpu_torch.models.exact_gp import ExactGP
from nonstationary_precip_tpu_torch.models.gibbs_gp import GibbsExactGP, GibbsSparseGP
from nonstationary_precip_tpu_torch.models.likelihoods import GaussianLikelihood
from nonstationary_precip_tpu_torch.models.multivariate_gibbs_gp import MultivariateGibbsGP, SparseMultivariateGibbsGP
from nonstationary_precip_tpu_torch.models.sgpr import SGPR
from nonstationary_precip_tpu_torch.models.spatio_temporal import (
    SparseSpatioTemporalNonstationary,
    SpatioTemporalStationary,
    make_stationary_st_kernel,
    make_temporal_kernel,
)
from nonstationary_precip_tpu_torch.models.svgp import SVGPLayer
from nonstationary_precip_tpu_torch.priors.lognormal_process import LogNormalProcess
from nonstationary_precip_tpu_torch.priors.matrix_normal import MatrixNormalPrior

#: The leaves of a JAX ``GibbsExactGP``, by dotted path.
GIBBS_EXACT_KEYS = (
    "log_ell",
    "raw_outputscale",
    "likelihood.raw_noise",
    "prior.mean_const",
    "prior.raw_outputscale",
    "prior.raw_lengthscale",
)


#: The parameters of the JAX large-N gate (``experiments/gibbs_largen.py``).
LARGEN_KEYS = ("log_ell_pp", "raw_s2", "log_noise")


def largen_params_from_jax(params: Mapping[str, np.ndarray], device, dtype=torch.float32) -> dict:
    """The large-N gate's parameter dict {log_ell_pp (N, 2), raw_s2,
    log_noise} as the port's tensors, from the JAX run's numpy arrays."""
    missing = [k for k in LARGEN_KEYS if k not in params]
    if missing:
        raise KeyError(f"largen_params_from_jax: missing {missing}")
    return {k: torch.tensor(np.array(params[k]), dtype=dtype, device=device) for k in LARGEN_KEYS}


def gibbs_exact_from_jax(params: Mapping[str, np.ndarray], device, dtype=torch.float32) -> GibbsExactGP:
    """The port's ``GibbsExactGP`` holding the JAX model's leaves.

    ``params`` maps each of ``GIBBS_EXACT_KEYS`` to a numpy array; the
    result has the default trainability (only the latent field trains)."""
    missing = [k for k in GIBBS_EXACT_KEYS if k not in params]
    if missing:
        raise KeyError(f"gibbs_exact_from_jax: missing leaves {missing}")

    def t(key):
        return torch.tensor(np.array(params[key]), dtype=dtype, device=device)

    prior = LogNormalProcess(t("prior.mean_const"), t("prior.raw_outputscale"), t("prior.raw_lengthscale"))
    return GibbsExactGP(prior, GaussianLikelihood(t("likelihood.raw_noise")),
                        t("raw_outputscale"), t("log_ell"))


#: The leaves of one JAX ``SVGPLayer``, in its field order (``mean_w`` only
#: for a linear mean).
SVGP_KEYS = ("z", "var_mean", "var_chol", "raw_outputscale", "raw_lengthscale", "mean_b", "mean_w")


def deepgp_from_jax(params: Mapping[str, np.ndarray], device, dtype=torch.float32, *,
                    num_layers: int = None, share_hidden: bool = False) -> DeepGP:
    """The port's ``DeepGP`` holding a JAX ``DeepGP``'s leaves.

    ``params`` maps dotted leaf paths (``layers.0.z``, ``head.var_chol``,
    ``likelihood.raw_noise``, ...) to numpy arrays, single or stacked on a
    leading split axis.  ``num_layers`` and ``share_hidden`` are the JAX
    model's static fields; ``num_layers`` defaults to the number of layers
    in ``params`` (1 when ``share_hidden``)."""
    def t(key):
        if key not in params:
            raise KeyError(f"deepgp_from_jax: missing leaf {key!r}")
        return torch.tensor(np.array(params[key]), dtype=dtype, device=device)

    def layer(prefix):
        linear = f"{prefix}.mean_w" in params
        leaves = [t(f"{prefix}.{k}") for k in SVGP_KEYS[:-1]]
        return SVGPLayer(*leaves, mean_w=t(f"{prefix}.mean_w") if linear else None,
                         mean_type="linear" if linear else "constant")

    n_stored = len({k.split(".")[1] for k in params if k.startswith("layers.")})
    layers = [layer(f"layers.{i}") for i in range(n_stored)]
    if num_layers is None:
        num_layers = n_stored
    return DeepGP(layers, layer("head"), GaussianLikelihood(t("likelihood.raw_noise")),
                  share_hidden=share_hidden, num_layers=num_layers)


#: The JAX fused data term's parameter dict (``pallas_elbo._reference_fwd``),
#: by the port's key: the five output groups go side by side.
ELBO_GROUPS = {"z": ("z1", "z2", "zh"), "ell": ("ell1", "ell2", "ellh"), "s2": ("s21", "s22", "s2h"),
               "w": ("w1", "w2", "wh")}
ELBO_MEANS = ("mw1", "mb1", "mw2", "mb2", "mbh")


def elbo_params_from_jax(params: Mapping[str, np.ndarray], device, dtype=torch.float32) -> dict:
    """The port's fused-data-term parameters (``ops/elbo_fused.py``) from the
    JAX package's stacked-group dict of numpy arrays, single (one model,
    given a member axis of 1) or stacked on a leading member axis."""
    stacked = np.ndim(params["z1"]) == 4

    def a(key):
        v = np.asarray(params[key])
        return v if stacked else v[None]

    out = {k: np.concatenate([a(g) for g in groups], axis=1) for k, groups in ELBO_GROUPS.items()}
    out.update({k: a(k) for k in ELBO_MEANS})
    return {k: torch.tensor(v, dtype=dtype, device=device) for k, v in out.items()}


def exact_gp_from_jax(params: Mapping[str, np.ndarray], kernel: nn.Module, device,
                      dtype=torch.float32) -> ExactGP:
    """The port's ``ExactGP`` around ``kernel`` (the port's module of the
    JAX model's kernel structure: its lower bounds and ``active_dims``, which
    are static fields, not leaves) holding a JAX ``ExactGP``'s leaves.

    ``params`` maps every parameter name of the port's model to a numpy
    array, single or stacked on a leading split axis.  The names are the
    JAX leaf paths, dotted: ``kernel.base.raw_lengthscale``,
    ``kernel.raw_outputscale``, ``kernel.base.kernels.0.raw_lengthscale``
    (JAX's ``.kernel.base.kernels[0].raw_lengthscale``), ``raw_period``,
    ``likelihood.raw_noise`` and, for a constant mean, ``mean_const``."""
    mean_type = "constant" if "mean_const" in params else "zero"
    model = ExactGP.create(kernel, mean_type=mean_type, dtype=dtype, device=device)
    return _load_leaves(model, params, device, dtype, "exact_gp_from_jax")


def _load_leaves(model: nn.Module, params: Mapping[str, np.ndarray], device, dtype, who: str) -> nn.Module:
    """Set every parameter of ``model`` from ``params`` (dotted JAX leaf
    paths, the port's parameter names), keeping each parameter's
    ``requires_grad``; raises on a missing or an unknown leaf."""
    names = [n for n, _ in model.named_parameters()]
    missing, extra = sorted(set(names) - set(params)), sorted(set(params) - set(names))
    if missing or extra:
        raise KeyError(f"{who}: missing leaves {missing}, unknown leaves {extra}")
    for name in names:
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        value = torch.tensor(np.array(params[name]), dtype=dtype, device=device)
        setattr(mod, leaf, nn.Parameter(value, requires_grad=getattr(mod, leaf).requires_grad))
    return model


#: The leaves of a JAX ``GibbsSparseGP``, by dotted path.
GIBBS_SPARSE_KEYS = ("z", "log_ell_z", "raw_outputscale", "likelihood.raw_noise", "prior.mean_const",
                     "prior.raw_outputscale", "prior.raw_lengthscale")


def gibbs_sparse_from_jax(params: Mapping[str, np.ndarray], device, dtype=torch.float32, *,
                          scale_correction: bool = False) -> GibbsSparseGP:
    """The port's ``GibbsSparseGP`` holding a JAX ``GibbsSparseGP``'s leaves
    (``GIBBS_SPARSE_KEYS``), single or stacked on a leading split axis;
    ``scale_correction`` is the JAX model's static field.  Default
    trainability (the latent field and z train)."""
    missing = [k for k in GIBBS_SPARSE_KEYS if k not in params]
    if missing:
        raise KeyError(f"gibbs_sparse_from_jax: missing leaves {missing}")

    def t(key):
        return torch.tensor(np.array(params[key]), dtype=dtype, device=device)

    prior = LogNormalProcess(t("prior.mean_const"), t("prior.raw_outputscale"), t("prior.raw_lengthscale"))
    return GibbsSparseGP(prior, GaussianLikelihood(t("likelihood.raw_noise")), t("raw_outputscale"), t("z"),
                         t("log_ell_z"), scale_correction=scale_correction)


def sgpr_from_jax(params: Mapping[str, np.ndarray], kernel: nn.Module, device, dtype=torch.float32) -> SGPR:
    """The port's ``SGPR`` around ``kernel`` (the port's module of the JAX
    kernel's structure, as for ``exact_gp_from_jax``) holding a JAX
    ``SGPR``'s leaves: ``kernel.…``, ``likelihood.raw_noise`` and ``z``.
    Every parameter trains."""
    model = SGPR.create(kernel, np.zeros((1, 1)), dtype=dtype, device=device)
    return _load_leaves(model, params, device, dtype, "sgpr_from_jax")


def spatio_temporal_from_jax(params: Mapping[str, np.ndarray], device, dtype=torch.float32, *,
                             scale_correction: bool = False):
    """The port's spatio-temporal model holding a JAX one's leaves:
    ``SparseSpatioTemporalNonstationary`` where ``params`` has a latent
    field (``log_ell_z``), else ``SpatioTemporalStationary``.  The
    nonstationary model keeps its default trainability (prior and z
    frozen)."""
    if "log_ell_z" not in params:
        model = SpatioTemporalStationary(make_stationary_st_kernel(dtype, device),
                                         GaussianLikelihood.create(dtype=dtype, device=device), None, "zero")
        return _load_leaves(model, params, device, dtype, "spatio_temporal_from_jax")

    def t(key):
        if key not in params:
            raise KeyError(f"spatio_temporal_from_jax: missing leaf {key!r}")
        return torch.tensor(np.array(params[key]), dtype=dtype, device=device)

    prior = LogNormalProcess(t("prior.mean_const"), t("prior.raw_outputscale"), t("prior.raw_lengthscale"))
    model = SparseSpatioTemporalNonstationary(prior, GaussianLikelihood(t("likelihood.raw_noise")), t("z"),
                                              t("log_ell_z"), t("raw_spatial_outputscale"),
                                              make_temporal_kernel(dtype, device),
                                              scale_correction=scale_correction)
    return _load_leaves(model, params, device, dtype, "spatio_temporal_from_jax")


#: The leaves of a JAX ``MultivariateGibbsGP`` and ``SparseMultivariateGibbsGP``,
#: by dotted path (the matrix-normal prior's three children by name).
MV_GIBBS_KEYS = ("likelihood.raw_noise", "h", "d_mat", "h_prior.loc", "h_prior.row_cov", "h_prior.col_cov",
                 "x_anchor")
MV_GIBBS_SPARSE_KEYS = ("likelihood.raw_noise", "z", "h_z", "d_mat", "h_prior.loc", "h_prior.row_cov",
                        "h_prior.col_cov")


def _mv_leaves(params: Mapping[str, np.ndarray], keys, device, dtype, who: str) -> dict:
    missing = [k for k in keys if k not in params]
    if missing:
        raise KeyError(f"{who}: missing leaves {missing}")
    return {k: torch.tensor(np.array(params[k]), dtype=dtype, device=device) for k in keys}


def _mv_prior(t: dict) -> MatrixNormalPrior:
    return MatrixNormalPrior(t["h_prior.loc"], t["h_prior.row_cov"], t["h_prior.col_cov"])


def mv_gibbs_from_jax(params: Mapping[str, np.ndarray], device, dtype=torch.float32, *,
                      detach_h: bool = False) -> MultivariateGibbsGP:
    """The port's ``MultivariateGibbsGP`` holding a JAX one's leaves
    (``MV_GIBBS_KEYS``); ``detach_h`` is the JAX model's static field.
    Default trainability (H, D and the noise train)."""
    t = _mv_leaves(params, MV_GIBBS_KEYS, device, dtype, "mv_gibbs_from_jax")
    return MultivariateGibbsGP(GaussianLikelihood(t["likelihood.raw_noise"]), t["h"], t["d_mat"], _mv_prior(t),
                               t["x_anchor"], detach_h=detach_h)


def mv_gibbs_sparse_from_jax(params: Mapping[str, np.ndarray], device, dtype=torch.float32, *,
                             detach_h: bool = False) -> SparseMultivariateGibbsGP:
    """The port's ``SparseMultivariateGibbsGP`` holding a JAX one's leaves
    (``MV_GIBBS_SPARSE_KEYS``); default trainability (z, H(z), D and the
    noise train)."""
    t = _mv_leaves(params, MV_GIBBS_SPARSE_KEYS, device, dtype, "mv_gibbs_sparse_from_jax")
    return SparseMultivariateGibbsGP(GaussianLikelihood(t["likelihood.raw_noise"]), t["z"], t["h_z"], t["d_mat"],
                                     _mv_prior(t), detach_h=detach_h)


def serve_model_from_jax(name: str, params: Mapping[str, np.ndarray], d: int, device, dtype=torch.float32, *,
                         num_layers: int = None) -> nn.Module:
    """The model of serve's family ``name`` (``serve.MODELS``) holding a
    JAX model's leaves, with the trainability ``serve._build`` gives it.
    ``d`` is the input width (the SE-ARD kernel's dims), ``num_layers`` the
    deep GP's."""
    if name == "seard":
        kernel = Scale.create(RBF.create(d, dtype=dtype, device=device), dtype=dtype, device=device)
        return exact_gp_from_jax(params, kernel, device, dtype)
    if name == "deepgp":
        return deepgp_from_jax(params, device, dtype, num_layers=num_layers)
    return {"gibbs_exact": gibbs_exact_from_jax, "gibbs_sparse": gibbs_sparse_from_jax,
            "mv_gibbs": mv_gibbs_from_jax, "mv_gibbs_sparse": mv_gibbs_sparse_from_jax,
            "st_stationary": spatio_temporal_from_jax,
            "st_nonstationary": spatio_temporal_from_jax}[name](params, device, dtype)


def serve_case_from_jax(ref, case: str, csv_dir) -> tuple:
    """One case of a pinned JAX serve (``ref``: the opened npz that
    ``tools/pin_jax_serve.py`` writes): ``(argv, init, fitted, draws)``.  ``argv`` is the JAX run's CLI
    flags, with ``--train_csv`` its data written under ``csv_dir`` (no
    ``--device``, no ``--output``); ``init`` and ``fitted`` are its model's
    leaves by dotted path before and after the fit (``fitted`` holds the
    frozen leaves too); ``draws`` is what ``serve.run`` takes in place of
    its streams' draws (the deep GP's ε, the matrix-free probes)."""
    name = str(ref[f"{case}.data"])
    csv = Path(csv_dir) / f"{name}.csv"
    if not csv.exists():
        np.savetxt(csv, ref[f"data.{name}"], delimiter=",", header=str(ref[f"header.{name}"]), comments="",
                   fmt="%.17g")
    argv = ["--model", str(ref[f"{case}.model"]), "--train_csv", str(csv), *json.loads(str(ref[f"{case}.argv"]))]

    def leaves(head):
        return {k[len(head):]: ref[k] for k in ref.files if k.startswith(head)}

    def layers(what):
        return [ref[k] for k in sorted(k for k in ref.files if k.startswith(f"{case}.{what}_"))]

    draws = {}
    if f"{case}.eps_train_0" in ref.files:
        draws.update(eps_train=layers("eps_train"), eps_pred=layers("eps_pred"))
    if f"{case}.u1" in ref.files:
        draws.update(prior_probes=list(zip(ref[f"{case}.prior_u1"], ref[f"{case}.prior_u2"])),
                     probes=(ref[f"{case}.u1"], ref[f"{case}.u2"]))
    init = leaves(f"{case}.init.")
    return argv, init, {**init, **leaves(f"{case}.fitted.")}, draws
