"""Stationary kernels: SE-ARD (RBF), Matérn-5/2 and Periodic.

Counterpart of ``nonstationary_precip_tpu/kernels/stationary.py``.  The RBF
and Matérn Grams use the
‖a‖² + ‖b‖² − 2·a·bᵀ identity clamped at 0, as the JAX package does, so
both sides round alike.  Lengthscales and periods are softplus of their
raw parameters, raw 0 at init (GPyTorch's, softplus(0) ≈ 0.6931).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from nonstationary_precip_tpu_torch.kernels.base import Kernel
from nonstationary_precip_tpu_torch.utils.transforms import positive, raw_init


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances via the matmul identity, clamped at 0."""
    a_sq = torch.sum(a * a, dim=-1)[..., :, None]
    b_sq = torch.sum(b * b, dim=-1)[..., None, :]
    ab = a @ b.mT
    return torch.clamp(a_sq + b_sq - 2.0 * ab, min=0.0)


def _raw(ard_dims: int, value, dtype, device) -> torch.Tensor:
    """Raw (D,) parameter: 0 when ``value`` is None, else softplus⁻¹(value)."""
    if value is None:
        return torch.zeros((ard_dims,), dtype=dtype, device=device)
    return raw_init(torch.as_tensor(value, dtype=dtype, device=device).expand(ard_dims).clone())


class RBF(Kernel):
    """SE-ARD: k = exp(−½ Σ_d (x1_d − x2_d)² / ℓ_d²) (GPyTorch's
    ``RBFKernel(ard_num_dims=D)``)."""

    def __init__(self, raw_lengthscale: torch.Tensor, active_dims: Optional[tuple] = None):
        super().__init__(active_dims)
        self.raw_lengthscale = nn.Parameter(raw_lengthscale)  # (..., D)

    @classmethod
    def create(cls, ard_dims: int = 1, lengthscale=None, active_dims=None, dtype=torch.float32, device=None):
        return cls(_raw(ard_dims, lengthscale, dtype, device), active_dims)

    @property
    def lengthscale(self) -> torch.Tensor:
        return positive(self.raw_lengthscale)

    def gram(self, x1, x2):
        ell = self.lengthscale[..., None, :]
        return torch.exp(-0.5 * _sq_dist(x1 / ell, x2 / ell))

    def _diag(self, x):
        return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)


class Matern52(Kernel):
    """Matérn-5/2 ARD: k = (1 + √5 d + 5d²/3) exp(−√5 d), d the scaled
    distance, taken as √(d² + 1e-20) so its gradient stays finite at d = 0,
    as in the JAX package."""

    def __init__(self, raw_lengthscale: torch.Tensor, active_dims: Optional[tuple] = None):
        super().__init__(active_dims)
        self.raw_lengthscale = nn.Parameter(raw_lengthscale)  # (..., D)

    @classmethod
    def create(cls, ard_dims: int = 1, lengthscale=None, active_dims=None, dtype=torch.float32, device=None):
        return cls(_raw(ard_dims, lengthscale, dtype, device), active_dims)

    @property
    def lengthscale(self) -> torch.Tensor:
        return positive(self.raw_lengthscale)

    def gram(self, x1, x2):
        ell = self.lengthscale[..., None, :]
        d = torch.sqrt(_sq_dist(x1 / ell, x2 / ell) + 1e-20)
        sqrt5_d = math.sqrt(5.0) * d
        return (1.0 + sqrt5_d + (5.0 / 3.0) * d * d) * torch.exp(-sqrt5_d)

    def _diag(self, x):
        return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)


class Periodic(Kernel):
    """Periodic kernel, GPyTorch's convention (the lengthscale divides,
    not its square):  k = exp(−2 Σ_d sin²(π (x1_d − x2_d) / p_d) / ℓ_d)."""

    def __init__(self, raw_lengthscale: torch.Tensor, raw_period: torch.Tensor,
                 active_dims: Optional[tuple] = None):
        super().__init__(active_dims)
        self.raw_lengthscale = nn.Parameter(raw_lengthscale)  # (..., D)
        self.raw_period = nn.Parameter(raw_period)  # (..., D)

    @classmethod
    def create(cls, ard_dims: int = 1, lengthscale=None, period=None, active_dims=None, dtype=torch.float32,
               device=None):
        return cls(_raw(ard_dims, lengthscale, dtype, device), _raw(ard_dims, period, dtype, device), active_dims)

    @property
    def lengthscale(self) -> torch.Tensor:
        return positive(self.raw_lengthscale)

    @property
    def period(self) -> torch.Tensor:
        return positive(self.raw_period)

    def gram(self, x1, x2):
        diff = x1[..., :, None, :] - x2[..., None, :, :]
        arg = math.pi * diff / self.period[..., None, None, :]
        return torch.exp(-2.0 * torch.sum(torch.sin(arg) ** 2 / self.lengthscale[..., None, None, :], dim=-1))

    def _diag(self, x):
        return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
