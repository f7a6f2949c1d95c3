"""Predictive distributions: independent marginals and the full joint.

Counterpart of ``nonstationary_precip_tpu/models/distributions.py``
(``DiagNormal``, ``MVN``), batched over leading dimensions.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from nonstationary_precip_tpu_torch.ops.linalg import mvn_logpdf_from_chol, safe_cholesky


class DiagNormal(NamedTuple):
    """Independent Gaussians: predictive marginals, mean and var (..., N)."""

    mean: torch.Tensor
    var: torch.Tensor

    def log_prob(self, y: torch.Tensor) -> torch.Tensor:
        """Per-point log densities."""
        return -0.5 * ((y - self.mean) ** 2 / self.var + torch.log(2 * math.pi * self.var))

    def add_noise(self, noise) -> "DiagNormal":
        return DiagNormal(self.mean, self.var + noise)


class MVN(NamedTuple):
    """Joint Gaussian with mean (..., N) and covariance (..., N, N)."""

    mean: torch.Tensor
    cov: torch.Tensor

    def log_prob(self, y: torch.Tensor) -> torch.Tensor:
        """Joint log density (the reference's ``nlpd`` metric)."""
        return mvn_logpdf_from_chol(y, self.mean, safe_cholesky(self.cov))

    @property
    def var(self) -> torch.Tensor:
        return torch.diagonal(self.cov, dim1=-2, dim2=-1)

    def add_noise(self, noise) -> "MVN":
        """Covariance + noise·I; ``noise`` is a scalar or a (...,) tensor."""
        eye = torch.eye(self.cov.shape[-1], dtype=self.cov.dtype, device=self.cov.device)
        noise = torch.as_tensor(noise, dtype=self.cov.dtype, device=self.cov.device)
        return MVN(self.mean, self.cov + noise[..., None, None] * eye)
