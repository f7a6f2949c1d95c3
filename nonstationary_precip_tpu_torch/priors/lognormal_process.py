"""Log-normal latent process: D independent GPs on the log-lengthscale.

Counterpart of the dense part of
``nonstationary_precip_tpu/priors/lognormal_process.py``:

  * ``conditional_mean`` — exp of the conditional mean only (no conditional
    covariance), with 1e-4 jitter on the conditioning Gram;
  * ``log_prob``         — joint MVN log-density of the log-field with 1e-4
    jitter, summed over dims and divided by N.

Layout: lengthscale fields are (..., N, D), row per point; each output dim d
has its own constant mean and its own Scale(RBF-ARD) kernel over the D_in
input dims.  Every parameter may carry leading batch dimensions (one prior
per split), matching leading dimensions of x.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from nonstationary_precip_tpu_torch.kernels.stationary import _sq_dist as sq_dist
from nonstationary_precip_tpu_torch.ops.linalg import (
    add_jitter,
    cho_solve,
    mvn_logpdf_from_chol,
    safe_cholesky,
)
from nonstationary_precip_tpu_torch.utils.transforms import positive, raw_init

_COND_JITTER = 1e-4  # reference: gibbs_kernels.py:88,107


class LogNormalProcess(nn.Module):
    """D independent GP priors on log-lengthscale fields.

    Parameters (after any leading batch dims):
      mean_const       (D,)        constant mean of each log-GP
      raw_outputscale  (D,)        Scale kernel outputscale (softplus raw)
      raw_lengthscale  (D, D_in)   RBF-ARD lengthscales    (softplus raw)
    """

    def __init__(self, mean_const, raw_outputscale, raw_lengthscale):
        super().__init__()
        self.mean_const = nn.Parameter(mean_const, requires_grad=False)
        self.raw_outputscale = nn.Parameter(raw_outputscale, requires_grad=False)
        self.raw_lengthscale = nn.Parameter(raw_lengthscale, requires_grad=False)

    @classmethod
    def create(
        cls,
        input_dim: int,
        mean: float = 0.0,
        outputscale: float = None,
        lengthscale: float = None,
        dtype=torch.float32,
        device=None,
    ):
        """One log-GP per input dim.  Defaults mirror GPyTorch inits:
        constant mean 0, softplus(0) outputscale/lengthscale."""
        d_out = input_dim
        kw = dict(dtype=dtype, device=device)
        mc = torch.full((d_out,), mean, **kw)
        ros = (
            torch.zeros((d_out,), **kw)
            if outputscale is None
            else raw_init(torch.full((d_out,), outputscale, **kw))
        )
        rls = (
            torch.zeros((d_out, input_dim), **kw)
            if lengthscale is None
            else raw_init(torch.full((d_out, input_dim), lengthscale, **kw))
        )
        return cls(mc, ros, rls)

    # -- internals ---------------------------------------------------------

    def _gram(self, x1, x2=None):
        """Batched Scale(RBF-ARD) Grams, one per output dim: (..., D, N1, N2)."""
        x2 = x1 if x2 is None else x2
        ell = positive(self.raw_lengthscale)[..., :, None, :]  # (..., D, 1, D_in)
        s2 = positive(self.raw_outputscale)[..., :, None, None]  # (..., D, 1, 1)
        return s2 * torch.exp(-0.5 * sq_dist(x1[..., None, :, :] / ell, x2[..., None, :, :] / ell))

    def mean(self, x) -> torch.Tensor:
        """Prior mean of the log-field at x: (..., N, D)."""
        n = x.shape[-2]
        mc = self.mean_const[..., None, :]
        return mc.expand(*mc.shape[:-2], n, mc.shape[-1])

    # -- reference API -----------------------------------------------------

    def conditional_mean(self, x: torch.Tensor, given: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        """exp of E[log ℓ(x) | log ℓ(x_g) = log ell_g]: (..., N, D) positive.

        The conditional covariance is dropped; jitter 1e-4 on the
        conditioning Gram; exp of the mean (not the log-normal mean)."""
        xg, ell_g = given
        k_xg = self._gram(x, xg)  # (..., D, N, Ng)
        k_gg = add_jitter(self._gram(xg), _COND_JITTER)  # (..., D, Ng, Ng)
        resid = torch.log(ell_g).mT - self.mean(xg).mT  # (..., D, Ng)
        alpha = cho_solve(safe_cholesky(k_gg), resid)  # (..., D, Ng)
        mu = self.mean(x).mT + (k_xg @ alpha[..., None])[..., 0]  # (..., D, N)
        return torch.exp(mu).mT

    def gram_chol(self, x: torch.Tensor) -> torch.Tensor:
        """chol(K_d + 1e-4 I) per output dim: (..., D, N, N).  Loop-invariant
        under a frozen prior: compute once per fit and pass to ``log_prob``."""
        return safe_cholesky(add_jitter(self._gram(x), _COND_JITTER))

    def gram_pre(self, x: torch.Tensor):
        """(K⁻¹ (..., D, N, N), logdet (..., D)) of K_d + 1e-4 I — the
        fully-hoisted form of ``gram_chol`` for a frozen prior: the per-step
        prior term becomes one batched matmul and a constant."""
        chols = self.gram_chol(x)
        eye = torch.eye(chols.shape[-1], dtype=chols.dtype, device=chols.device)
        linv = torch.linalg.solve_triangular(chols, eye.expand_as(chols), upper=False)
        kinv = linv.mT @ linv
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)), dim=-1)
        return kinv, logdet

    def log_prob(self, x: torch.Tensor, log_ell: torch.Tensor, chols=None) -> torch.Tensor:
        """Σ_d log N(log_ell[..., d]; mean_d, K_d + 1e-4 I) / N — the
        reference's per-N-normalised prior term.

        ``chols`` may be the (..., D, N, N) Cholesky stack from ``gram_chol``
        or the (K⁻¹, logdet) pair from ``gram_pre``."""
        n = x.shape[-2]
        if isinstance(chols, tuple):
            kinv, logdet = chols
            diff = log_ell.mT - self.mean(x).mT  # (..., D, N)
            quad = torch.sum(diff * (kinv @ diff[..., None])[..., 0], dim=-1)
            lp = -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))
            return torch.sum(lp, dim=-1) / n
        if chols is None:
            chols = self.gram_chol(x)
        lp = mvn_logpdf_from_chol(log_ell.mT, self.mean(x).mT, chols)  # (..., D)
        return torch.sum(lp, dim=-1) / n

    def init_log_field(self, x: torch.Tensor) -> torch.Tensor:
        """Initial latent log-lengthscale field = prior mean at x: (..., N, D)."""
        return self.mean(x)
