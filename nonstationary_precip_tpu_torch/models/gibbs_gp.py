"""MAP inference for the diagonal-Gibbs nonstationary exact GP.

Counterpart of ``nonstationary_precip_tpu/models/gibbs_gp.py``
(``GibbsExactGP`` and ``gibbs_map_loss_batched``).  A latent log-lengthscale
field at the training inputs is optimised under MLL + prior log-prob (both
÷N, GPyTorch convention); prediction conditions the field at new points on
the trained one through the log-normal process's conditional mean.

Every parameter may carry a leading split axis: a stacked model holds the K
benchmark splits at once, and every method then works on all of them (the
JAX package's ``vmap`` written out as a batch dimension).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from nonstationary_precip_tpu_torch.kernels.gibbs import gibbs_gram
from nonstationary_precip_tpu_torch.models.distributions import MVN
from nonstationary_precip_tpu_torch.models.likelihoods import GaussianLikelihood
from nonstationary_precip_tpu_torch.ops.chol_inv import MAX_N, chol_inv_batched_safe
from nonstationary_precip_tpu_torch.ops.gibbs_fused import gibbs_noisy_chol_alpha
from nonstationary_precip_tpu_torch.ops.linalg import cho_solve, diag_part, safe_cholesky, tri_solve
from nonstationary_precip_tpu_torch.priors.lognormal_process import LogNormalProcess
from nonstationary_precip_tpu_torch.utils.transforms import positive, raw_init


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


class GibbsExactGP(nn.Module):
    """Zero-mean exact GP with scaled diagonal-Gibbs covariance and a
    trainable latent log-lengthscale field at the N training inputs."""

    def __init__(self, prior: LogNormalProcess, likelihood: GaussianLikelihood,
                 raw_outputscale: torch.Tensor, log_ell: torch.Tensor):
        super().__init__()
        self.prior = prior
        self.likelihood = likelihood
        self.raw_outputscale = nn.Parameter(raw_outputscale)
        self.log_ell = nn.Parameter(log_ell)  # (..., N, D)
        self.trainable()

    @classmethod
    def create(cls, x_train, prior: LogNormalProcess, noise=None, outputscale=1.0,
               dtype=torch.float32, device=None):
        return cls(
            prior=prior,
            likelihood=GaussianLikelihood.create(noise, dtype=dtype, device=device),
            raw_outputscale=raw_init(torch.as_tensor(outputscale, dtype=dtype, device=device)),
            log_ell=prior.init_log_field(x_train).to(dtype).clone(),
        )

    @property
    def outputscale(self) -> torch.Tensor:
        return positive(self.raw_outputscale)

    def trainable(self, train_noise: bool = False, train_scale: bool = False) -> "GibbsExactGP":
        """Freeze parameters the way the reference does: the latent field
        always trains, the prior is always frozen, noise and outputscale
        train per flag.  Sets ``requires_grad`` in place; returns self."""
        for p in self.prior.parameters():
            p.requires_grad_(False)
        self.likelihood.raw_noise.requires_grad_(train_noise)
        self.raw_outputscale.requires_grad_(train_scale)
        self.log_ell.requires_grad_(True)
        return self

    # -- objective ----------------------------------------------------------

    def loss(self, x: torch.Tensor, y: torch.Tensor, prior_chols=None) -> torch.Tensor:
        """−(log N(y; 0, s²K_gibbs + σ²I) + prior_logprob) / N, per leading
        batch index.  ``prior_chols`` hoists the frozen prior's Gram algebra:
        ``prior.gram_pre(x)`` or ``prior.gram_chol(x)``.

        An unbatched model (x (N, D), the field (N, D)) takes the JAX
        package's dispatcher ``gibbs_noisy_chol_alpha``: K8 inside its gate on
        the card, else the composed Gram → ``safe_cholesky`` → ``tri_solve``,
        which a batched model always takes."""
        n = y.shape[-1]
        if x.ndim == 2 and self.log_ell.ndim == 2:
            chol, alpha = gibbs_noisy_chol_alpha(x, torch.exp(self.log_ell), y, self.outputscale,
                                                 self.likelihood.noise)
        else:
            chol = safe_cholesky(noisy_gibbs_gram(self, x))
            alpha = tri_solve(chol, y)
        quad = torch.sum(alpha * alpha, dim=-1)
        logdet = 2.0 * torch.sum(torch.log(diag_part(chol)), dim=-1)
        logp = -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))
        prior_term = self.prior.log_prob(x, self.log_ell, prior_chols)
        return -(logp + prior_term) / n

    # -- prediction ---------------------------------------------------------

    def posterior(self, x_train, y_train, x_new, *, noiseless: bool = True) -> MVN:
        """Manual GP conditioning as the reference's DiagonalExactGP.predict:
        lengthscales at x_new are the prior's conditional mean given the
        trained field; the covariance gets the reference's +1e-4 I."""
        n = y_train.shape[-1]
        ell1 = torch.exp(self.log_ell)
        s2 = self.outputscale[..., None, None]
        k_xx = s2 * gibbs_gram(x_train, ell1, x_train, ell1)
        ell2 = self.prior.conditional_mean(x_new, (x_train, ell1))
        k_ss = s2 * gibbs_gram(x_new, ell2, x_new, ell2)
        k_sx = s2 * gibbs_gram(x_new, ell2, x_train, ell1)

        noise = self.likelihood.noise[..., None, None]
        chol = safe_cholesky(k_xx + noise * _eye(n, k_xx))
        mu = (k_sx @ cho_solve(chol, y_train)[..., None])[..., 0]
        v = tri_solve(chol, k_sx.mT)
        eye_s = _eye(k_ss.shape[-1], k_ss)
        sigma = k_ss - v.mT @ v + 1e-4 * eye_s
        if not noiseless:
            sigma = sigma + noise * eye_s
        return MVN(mu, sigma)

    def predictive(self, x_train, y_train, x_new) -> MVN:
        return self.posterior(x_train, y_train, x_new, noiseless=False)

    def lengthscale_field(self, x_train, x_new=None) -> torch.Tensor:
        """Trained (or conditionally extended) lengthscale field, (..., N, D)."""
        ell = torch.exp(self.log_ell)
        if x_new is None:
            return ell
        return self.prior.conditional_mean(x_new, (x_train, ell))


def gibbs_b_eligible(mats: torch.Tensor) -> bool:
    """Shape gate of the batched-(L, L⁻¹) MAP loss, the JAX package's
    ``gibbs_b_eligible``: a (T ≤ 16, 128 ≤ N ≤ 384) stack goes through K1.
    On the card K1 takes float32 only; on the CPU its plain version takes
    any dtype."""
    if mats.ndim != 3:
        return False
    t, n, _ = mats.shape
    dtype_ok = mats.device.type == "cpu" or mats.dtype == torch.float32
    return dtype_ok and t <= 16 and 128 <= n <= MAX_N


def noisy_gibbs_gram(models: GibbsExactGP, x: torch.Tensor) -> torch.Tensor:
    """s²·K_gibbs(x, ℓ) + σ²I at the model's current field, per leading
    batch index: the matrix the MAP loss factors."""
    ell = torch.exp(models.log_ell)
    k = gibbs_gram(x, ell, x, ell)
    return models.outputscale[..., None, None] * k + models.likelihood.noise[..., None, None] * _eye(x.shape[-2], k)


def gibbs_map_loss_batched(models: GibbsExactGP, x, y, prior_pre) -> torch.Tensor:
    """Per-split MAP losses (T,) of a stacked ``GibbsExactGP`` — the
    hand-batched form of the per-split ``loss``.

    For an eligible stack the (L, L⁻¹) pair comes from one K1 launch for all
    splits, and the exported L⁻¹ turns the solves into batched matmuls:
    α = L⁻¹y, and the MLL pullback runs through K1's matmul-only backward.
    Other shapes take the per-split ``loss`` over the split axis."""
    n = y.shape[-1]
    k = noisy_gibbs_gram(models, x)
    if not gibbs_b_eligible(k):
        return models.loss(x, y, prior_pre)
    l, li = chol_inv_batched_safe(k)
    alpha = (li @ y[..., None])[..., 0]
    quad = torch.sum(alpha * alpha, dim=-1)
    logdet = 2.0 * torch.sum(torch.log(diag_part(l)), dim=-1)
    logp = -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))
    prior_term = models.prior.log_prob(x, models.log_ell, prior_pre)
    return -(logp + prior_term) / n
