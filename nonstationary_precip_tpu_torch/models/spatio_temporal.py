"""Spatio-temporal GP models over (time, lon, lat) inputs.

Counterpart of ``nonstationary_precip_tpu/models/spatio_temporal.py``:

* ``SpatioTemporalStationary``: an exact GP with zero mean and the
  separable sum kernel Scale(RBF(t)·Periodic(t), outputscale > 7) +
  Scale(RBF(lon, lat));
* ``SparseSpatioTemporalNonstationary``: the sum of a sparse nonstationary
  spatial Gibbs kernel (latent log-lengthscale field at the inducing
  points, Nyström root and trace term) and a sparse temporal stationary
  kernel on the same frozen inducing points.  Training factors the dense
  sum of the two Nyström approximations (N = 172 rows); prediction
  conditions exactly on the approximate kernel (Nyström plus diagonal
  correction).  The spatial K_xz goes through the Gibbs dispatcher, K9 on
  the card wherever its gate admits it.

Both take one model (no split axis).
"""

from __future__ import annotations

import torch
from torch import nn

from nonstationary_precip_tpu_torch.kernels.base import Scale
from nonstationary_precip_tpu_torch.kernels.gibbs import gibbs_gram
from nonstationary_precip_tpu_torch.kernels.inducing import nystrom_root
from nonstationary_precip_tpu_torch.kernels.stationary import RBF, Periodic
from nonstationary_precip_tpu_torch.models.distributions import MVN
from nonstationary_precip_tpu_torch.models.exact_gp import ExactGP
from nonstationary_precip_tpu_torch.models.likelihoods import GaussianLikelihood
from nonstationary_precip_tpu_torch.ops.linalg import cho_solve, mvn_logpdf_from_chol, safe_cholesky, tri_solve
from nonstationary_precip_tpu_torch.priors.lognormal_process import LogNormalProcess
from nonstationary_precip_tpu_torch.utils.transforms import positive, raw_init

SPATIAL_DIMS = [1, 2]
TEMPORAL_DIMS = (0,)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def make_temporal_kernel(dtype=torch.float32, device=None) -> Scale:
    """Scale(RBF(t)·Periodic(t)) with outputscale > 7, at softplus(0) above
    the bound."""
    kw = dict(active_dims=TEMPORAL_DIMS, dtype=dtype, device=device)
    return Scale.create(RBF.create(1, **kw) * Periodic.create(1, **kw), outputscale=7.6931, lower_bound=7.0,
                        dtype=dtype, device=device)


def make_stationary_st_kernel(dtype=torch.float32, device=None):
    """Scale(RBF(t)·Periodic(t), outputscale > 7) + Scale(RBF(lon, lat))."""
    spatial = Scale.create(RBF.create(1, active_dims=tuple(SPATIAL_DIMS), dtype=dtype, device=device), dtype=dtype,
                           device=device)
    return make_temporal_kernel(dtype, device) + spatial


class SpatioTemporalStationary(ExactGP):
    """Exact GP with the stationary separable kernel and zero mean."""

    @classmethod
    def create(cls, noise: float = None, dtype=torch.float32, device=None):  # type: ignore[override]
        return super().create(make_stationary_st_kernel(dtype, device), noise=noise, mean_type="zero", dtype=dtype,
                              device=device)


class SparseSpatioTemporalNonstationary(nn.Module):
    """Sum of sparse nonstationary-spatial and sparse stationary-temporal
    kernels over x = (time, lon, lat), sharing frozen inducing points z.

    Spatial part: Scale ∘ Nyström(Gibbs) on columns (1, 2) with the latent
    log-lengthscale field at z[:, (1, 2)].  Temporal part:
    Nyström(Scale(RBF·Periodic)) on column 0, the Scale inside the inducing
    wrapper, as in the reference."""

    def __init__(self, prior: LogNormalProcess, likelihood: GaussianLikelihood, z: torch.Tensor,
                 log_ell_z: torch.Tensor, raw_spatial_outputscale: torch.Tensor, temporal_kernel: Scale,
                 scale_correction: bool = False):
        super().__init__()
        self.prior = prior
        self.likelihood = likelihood
        self.z = nn.Parameter(z)  # (M, 3)
        self.log_ell_z = nn.Parameter(log_ell_z)  # (M, 2)
        self.raw_spatial_outputscale = nn.Parameter(raw_spatial_outputscale)
        self.temporal_kernel = temporal_kernel
        self.scale_correction = scale_correction
        self.trainable()

    @classmethod
    def create(cls, z, prior: LogNormalProcess, noise=None, outputscale=1.0, dtype=torch.float32, device=None):
        z = torch.as_tensor(z, dtype=dtype, device=device).clone()
        return cls(prior=prior, likelihood=GaussianLikelihood.create(noise, dtype=dtype, device=device), z=z,
                   log_ell_z=prior.init_log_field(z[:, SPATIAL_DIMS]).to(dtype).clone(),
                   raw_spatial_outputscale=raw_init(torch.as_tensor(outputscale, dtype=dtype, device=device)),
                   temporal_kernel=make_temporal_kernel(dtype, device))

    def trainable(self, train_noise: bool = True, train_scale: bool = True) -> "SparseSpatioTemporalNonstationary":
        """The prior and z are frozen (the reference freezes the shared
        inducing points); noise and the spatial outputscale per flag; the
        rest trains.  In place; returns self."""
        for p in self.parameters():
            p.requires_grad_(True)
        for p in self.prior.parameters():
            p.requires_grad_(False)
        self.z.requires_grad_(False)
        self.likelihood.raw_noise.requires_grad_(train_noise)
        self.raw_spatial_outputscale.requires_grad_(train_scale)
        return self

    # -- covariance pieces ---------------------------------------------------

    def _spatial_root(self, x):
        """Unscaled Nyström root of the Gibbs spatial kernel at x (N, M)."""
        xs, zs = x[:, SPATIAL_DIMS], self.z[:, SPATIAL_DIMS]
        ell_z = torch.exp(self.log_ell_z)
        ell_x = self.prior.conditional_mean(xs, (zs, ell_z))
        root, _ = nystrom_root(gibbs_gram(xs, ell_x, zs, ell_z), gibbs_gram(zs, ell_z, zs, ell_z))
        return root

    def _temporal_root(self, x):
        """Nyström root of the scaled temporal kernel at x (N, M)."""
        root, _ = nystrom_root(self.temporal_kernel(x, self.z), self.temporal_kernel(self.z))
        return root

    @property
    def spatial_outputscale(self) -> torch.Tensor:
        return positive(self.raw_spatial_outputscale)

    # -- objective -------------------------------------------------------------

    def loss(self, x, y) -> torch.Tensor:
        """−(log N(y; 0, s²Q_sp + Q_t + σ²I) + added_sp + added_t + prior)/N.

        Both trace terms follow GPyTorch's harvesting: the temporal one on
        the scaled kernel (Scale inside the wrapper), the spatial one on the
        unscaled base kernel unless ``scale_correction``."""
        n = y.shape[-1]
        noise = self.likelihood.noise
        s2 = self.spatial_outputscale
        root_sp_u = self._spatial_root(x)
        root_t = self._temporal_root(x)
        k = s2 * (root_sp_u @ root_sp_u.T) + root_t @ root_t.T
        chol = safe_cholesky(k + noise * _eye(n, k))
        logp = mvn_logpdf_from_chol(y, torch.zeros_like(y), chol)

        q_sp_diag_u = torch.sum(root_sp_u * root_sp_u, dim=-1)
        sp_scale = s2 if self.scale_correction else 1.0
        added_sp = -0.5 * torch.sum(sp_scale * (1.0 - q_sp_diag_u)) / noise
        q_t_diag = torch.sum(root_t * root_t, dim=-1)
        added_t = -0.5 * torch.sum(self.temporal_kernel.diag(x) - q_t_diag) / noise
        prior_term = self.prior.log_prob(self.z[:, SPATIAL_DIMS], self.log_ell_z)
        return -(logp + added_sp + added_t + prior_term) / n

    # -- prediction --------------------------------------------------------------

    def _approx_kernel(self, x1, x2=None):
        """The Nyström-approximate sum kernel K̃(x1, x2), with the SGPR
        diagonal corrections on the symmetric case."""
        r1_sp, r1_t = self._spatial_root(x1), self._temporal_root(x1)
        s2 = self.spatial_outputscale
        if x2 is None:
            k = s2 * (r1_sp @ r1_sp.T) + r1_t @ r1_t.T
            corr_sp = torch.clamp(1.0 - torch.sum(r1_sp * r1_sp, dim=-1), min=0.0)
            corr_t = torch.clamp(self.temporal_kernel.diag(x1) - torch.sum(r1_t * r1_t, dim=-1), min=0.0)
            return k + torch.diag(s2 * corr_sp + corr_t)
        r2_sp, r2_t = self._spatial_root(x2), self._temporal_root(x2)
        return s2 * (r1_sp @ r2_sp.T) + r1_t @ r2_t.T

    def posterior(self, x_train, y_train, x_new, *, noiseless: bool = True) -> MVN:
        """Exact conditioning on the approximate kernel."""
        n = y_train.shape[-1]
        noise = self.likelihood.noise
        k_xx = self._approx_kernel(x_train) + noise * _eye(n, x_train)
        k_sx = self._approx_kernel(x_new, x_train)
        k_ss = self._approx_kernel(x_new)
        chol = safe_cholesky(k_xx)
        mean = k_sx @ cho_solve(chol, y_train)
        v = tri_solve(chol, k_sx.T)
        cov = k_ss - v.T @ v
        if not noiseless:
            cov = cov + noise * _eye(cov.shape[-1], cov)
        return MVN(mean, cov)

    def predictive(self, x_train, y_train, x_new) -> MVN:
        return self.posterior(x_train, y_train, x_new, noiseless=False)
