"""Exact and sparse GP models with the multivariate (Paciorek–Schervish)
Gibbs kernel and a matrix-normal prior on the latent H matrix.

Counterpart of ``nonstationary_precip_tpu/models/multivariate_gibbs_gp.py``.
Reference semantics kept from it:
  * the reference detaches H inside the Gram, so H learns only through its
    matrix-normal prior term; ``detach_h=False`` (the default) lets the
    marginal likelihood drive H, ``detach_h=True`` reproduces the reference;
  * the H prior's row covariance is a frozen RBF and its column covariance
    c·I (exact model: lengthscale (0.2, 0.2), c = 5; sparse model: (1.3,
    1.1), c = 1).

The prior's matrices (and the exact model's anchor inputs) are frozen
leaves: parameters with ``requires_grad=False``, so ``train/optim.fit``
leaves them alone and a ``state_dict`` carries them.  ``create`` draws H₀
and D₀ from the caller's ``torch.Generator``, or takes the caller's
standard-normal draws behind them.  The dense algebra is
``ops/linalg``'s ``safe_cholesky``, ``tri_solve`` and ``cho_solve``: the
library at N = 394, K10a and K11 where N enters their 768..1280 window, as
the JAX package's dispatch does.
"""

from __future__ import annotations

import torch
from torch import nn

from nonstationary_precip_tpu_torch.kernels.multivariate_gibbs import paciorek_schervish_gram_2d, sigma_components_2d
from nonstationary_precip_tpu_torch.models.distributions import MVN
from nonstationary_precip_tpu_torch.models.likelihoods import GaussianLikelihood
from nonstationary_precip_tpu_torch.ops.linalg import cho_solve, mvn_logpdf_from_chol, safe_cholesky, tri_solve
from nonstationary_precip_tpu_torch.priors.matrix_normal import MatrixNormalPrior, latent_rbf_row_cov


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _make_prior(anchor: torch.Tensor, row_ls, col_cov: float) -> MatrixNormalPrior:
    row_cov = latent_rbf_row_cov(anchor, row_ls)
    loc = torch.zeros((anchor.shape[0], 2), dtype=anchor.dtype, device=anchor.device)
    return MatrixNormalPrior(loc, row_cov, col_cov * _eye(2, anchor))


def _rbf_cross(x: torch.Tensor, anchor: torch.Tensor, row_ls) -> torch.Tensor:
    """The row covariance's RBF between x and the anchor rows, clamped at 0
    by ``torch.maximum`` (``jnp.maximum``'s gradient at a tie)."""
    ell = torch.as_tensor(row_ls, dtype=x.dtype, device=x.device)
    a = x / ell
    b = anchor / ell
    a_sq = torch.sum(a * a, dim=-1)[:, None]
    b_sq = torch.sum(b * b, dim=-1)[None, :]
    d2 = a_sq + b_sq - 2.0 * a @ b.T
    return torch.exp(-0.5 * torch.maximum(d2, torch.zeros((), dtype=x.dtype, device=x.device)))


def _draw_init(draw, prior: MatrixNormalPrior):
    """H₀, a draw from the prior, then D₀, the diagonal matrix of two
    standard-normal draws, in that order from ``draw``, a generator, on the
    prior's device; or ``draw`` is those draws themselves, (Z (N, 2), d
    (2,)), e.g. the ones the JAX package's ``create`` makes from its key."""
    dtype, dev = prior.loc.dtype, prior.loc.device
    if isinstance(draw, torch.Generator):
        h0 = prior.sample(draw)
        d = torch.randn((2,), generator=draw, dtype=dtype, device=draw.device)
    else:
        z, d = draw
        h0 = prior.sample(torch.as_tensor(z, dtype=dtype, device=dev))
        d = torch.as_tensor(d, dtype=dtype)
    return h0, torch.diag(d.to(dev))


class _MultivariateGibbsBase(nn.Module):
    """The Gram, loss and predictive shared by the exact and sparse models;
    a subclass supplies ``_h_train(x)`` (H at the training inputs) and
    ``_prior_h()`` (the matrix H's prior is placed on)."""

    def gram(self, x1, h1, x2=None, h2=None) -> torch.Tensor:
        if self.detach_h:
            h1 = h1.detach()
            h2 = None if h2 is None else h2.detach()
        sig1 = sigma_components_2d(h1, self.d_mat)
        if x2 is None:
            return paciorek_schervish_gram_2d(x1, sig1, x1, sig1)
        sig2 = sigma_components_2d(h2, self.d_mat)
        return paciorek_schervish_gram_2d(x1, sig1, x2, sig2)

    def loss(self, x, y) -> torch.Tensor:
        """−(log N(y; 0, K + σ²I) + log MN(H)) / N (GPyTorch prior harvesting)."""
        n = y.shape[-1]
        k = self.gram(x, self._h_train(x))
        chol = safe_cholesky(k + self.likelihood.noise * _eye(n, k))
        logp = mvn_logpdf_from_chol(y, torch.zeros_like(y), chol)
        prior_term = self.h_prior.log_prob(self._prior_h())
        return -(logp + prior_term) / n

    def posterior(self, x_train, y_train, x_new, *, noiseless: bool = True) -> MVN:
        n = y_train.shape[-1]
        h_x = self._h_train(x_train)
        h_s = self._h_at(x_new)
        k_xx = self.gram(x_train, h_x)
        k_sx = self.gram(x_new, h_s, x_train, h_x)
        k_ss = self.gram(x_new, h_s)
        chol = safe_cholesky(k_xx + self.likelihood.noise * _eye(n, k_xx))
        mean = k_sx @ cho_solve(chol, y_train)
        v = tri_solve(chol, k_sx.T)
        cov = k_ss - v.T @ v + 1e-4 * _eye(k_ss.shape[-1], k_ss)
        if not noiseless:
            cov = cov + self.likelihood.noise * _eye(cov.shape[-1], cov)
        return MVN(mean, cov)

    def predictive(self, x_train, y_train, x_new) -> MVN:
        return self.posterior(x_train, y_train, x_new, noiseless=False)


class MultivariateGibbsGP(_MultivariateGibbsBase):
    """Exact GP, zero mean, multivariate Gibbs covariance over D = 2 inputs,
    with the trainable latent H at the training inputs."""

    ROW_LS = (0.2, 0.2)  # frozen row-cov RBF lengthscale (reference :46)
    COL_COV = 5.0  # column covariance 5·I (reference :54)

    def __init__(self, likelihood: GaussianLikelihood, h: torch.Tensor, d_mat: torch.Tensor,
                 h_prior: MatrixNormalPrior, x_anchor: torch.Tensor, detach_h: bool = False):
        super().__init__()
        self.likelihood = likelihood
        self.h = nn.Parameter(h)  # (N, 2) latent matrix at the training inputs
        self.d_mat = nn.Parameter(d_mat)  # (2, 2) learnable offset
        self.h_prior = h_prior
        self.x_anchor = nn.Parameter(x_anchor, requires_grad=False)
        self.detach_h = detach_h
        self.trainable()

    @classmethod
    def create(cls, generator: torch.Generator, x, noise=None, detach_h: bool = False, dtype=torch.float32,
               device=None) -> "MultivariateGibbsGP":
        x = torch.as_tensor(x, dtype=dtype, device=device).clone()
        prior = _make_prior(x, cls.ROW_LS, cls.COL_COV)
        h0, d0 = _draw_init(generator, prior)
        return cls(GaussianLikelihood.create(noise, dtype=dtype, device=x.device), h0, d0, prior, x,
                   detach_h=detach_h)

    def trainable(self, train_noise: bool = True) -> "MultivariateGibbsGP":
        """The prior and the anchor inputs are frozen; H and D train, the
        noise per flag.  In place; returns self."""
        for p in self.h_prior.parameters():
            p.requires_grad_(False)
        self.x_anchor.requires_grad_(False)
        self.likelihood.raw_noise.requires_grad_(train_noise)
        self.h.requires_grad_(True)
        self.d_mat.requires_grad_(True)
        return self

    def _h_at(self, x_new) -> torch.Tensor:
        """Matrix-normal conditional mean of H at new points,
        H* = K_*x U⁻¹ H (the column covariance cancels)."""
        return self.h_prior.conditional_mean(_rbf_cross(x_new, self.x_anchor, self.ROW_LS), self.h)

    def _h_train(self, x) -> torch.Tensor:
        return self.h

    def _prior_h(self) -> torch.Tensor:
        return self.h


class SparseMultivariateGibbsGP(_MultivariateGibbsBase):
    """Sparse variant: H lives at M inducing inputs z; H at the data is the
    matrix-normal conditional mean given H(z)."""

    ROW_LS = (1.3, 1.1)  # reference :44 (Scale(RBF) with these lengthscales)
    COL_COV = 1.0  # reference :56, the identity column covariance

    def __init__(self, likelihood: GaussianLikelihood, z: torch.Tensor, h_z: torch.Tensor, d_mat: torch.Tensor,
                 h_prior: MatrixNormalPrior, detach_h: bool = False):
        super().__init__()
        self.likelihood = likelihood
        self.z = nn.Parameter(z)  # (M, 2)
        self.h_z = nn.Parameter(h_z)  # (M, 2)
        self.d_mat = nn.Parameter(d_mat)
        self.h_prior = h_prior
        self.detach_h = detach_h
        self.trainable()

    @classmethod
    def create(cls, generator: torch.Generator, z, noise=None, detach_h: bool = False, dtype=torch.float32,
               device=None) -> "SparseMultivariateGibbsGP":
        z = torch.as_tensor(z, dtype=dtype, device=device).clone()
        prior = _make_prior(z, cls.ROW_LS, cls.COL_COV)
        h0, d0 = _draw_init(generator, prior)
        return cls(GaussianLikelihood.create(noise, dtype=dtype, device=z.device), z, h0, d0, prior,
                   detach_h=detach_h)

    def trainable(self, train_noise: bool = True, train_z: bool = True) -> "SparseMultivariateGibbsGP":
        """The prior is frozen; H(z) and D train, the noise and z per flag.
        In place; returns self."""
        for p in self.h_prior.parameters():
            p.requires_grad_(False)
        self.z.requires_grad_(train_z)
        self.likelihood.raw_noise.requires_grad_(train_noise)
        self.h_z.requires_grad_(True)
        self.d_mat.requires_grad_(True)
        return self

    def _h_at(self, x) -> torch.Tensor:
        return self.h_prior.conditional_mean(_rbf_cross(x, self.z, self.ROW_LS), self.h_z)

    def _h_train(self, x) -> torch.Tensor:
        return self._h_at(x)

    def _prior_h(self) -> torch.Tensor:
        return self.h_z
