"""Fixed-hyperparameter latent GP prior.

Counterpart of ``nonstationary_precip_tpu/priors/latent_gp.py``: a zero-mean
GP with frozen Scale(RBF-ARD) hyperparameters at a fixed input set, used as
the prior over a lengthscale or amplitude process.  The covariance (jitter
1e-5 included) is computed once and kept as a frozen leaf.
"""

from __future__ import annotations

from typing import Union

import torch
from torch import nn

from nonstationary_precip_tpu_torch.kernels.stationary import _sq_dist as sq_dist
from nonstationary_precip_tpu_torch.ops.linalg import mvn_logpdf_from_chol, safe_cholesky

_JITTER = 1e-5


class LatentGpPrior(nn.Module):
    def __init__(self, x: torch.Tensor, cov: torch.Tensor):
        super().__init__()
        self.x = nn.Parameter(x, requires_grad=False)  # (N, D) fixed inputs
        self.cov = nn.Parameter(cov, requires_grad=False)  # (N, N), jitter included

    @classmethod
    def create(cls, x: torch.Tensor, sig_f: float, ls) -> "LatentGpPrior":
        ell = torch.as_tensor(ls, dtype=x.dtype, device=x.device)
        a = x / ell
        eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
        return cls(x=x.clone(), cov=sig_f * torch.exp(-0.5 * sq_dist(a, a)) + _JITTER * eye)

    def log_prob(self, values: torch.Tensor) -> torch.Tensor:
        return mvn_logpdf_from_chol(values, torch.zeros_like(values), safe_cholesky(self.cov))

    def sample(self, draw: Union[torch.Generator, torch.Tensor]) -> torch.Tensor:
        """L ε, with ε an (N,) standard-normal draw: given, or drawn from the
        generator ``draw``."""
        if isinstance(draw, torch.Generator):
            draw = torch.randn((self.x.shape[0],), generator=draw, dtype=self.x.dtype, device=draw.device)
        eps = torch.as_tensor(draw, dtype=self.x.dtype, device=self.x.device)
        return safe_cholesky(self.cov) @ eps
