"""Kernel algebra: composable covariance functions as ``nn.Module``s.

Counterpart of ``nonstationary_precip_tpu/kernels/base.py``.  A kernel's
parameters are its raw (unconstrained) hyperparameters; ``k(x1, x2)``
builds the cross-Gram, ``k(x)`` the symmetric Gram, ``k.diag(x)`` the
diagonal.  Every parameter may carry leading batch dimensions (a stacked
model holds the K benchmark splits at once); inputs then carry the same
leading dimensions.

``active_dims`` slices the input columns a kernel sees.  Algebra:
``k1 + k2`` → Sum, ``k1 * k2`` → Product, ``Scale(k)`` → s²·k with a
softplus-positive outputscale and an optional lower bound (GPyTorch's
``GreaterThan``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nonstationary_precip_tpu_torch.utils.transforms import positive, raw_init


class Kernel(nn.Module):
    """Base of the port's kernels: call conventions and algebra."""

    def __init__(self, active_dims: Optional[tuple] = None):
        super().__init__()
        self.active_dims = None if active_dims is None else tuple(active_dims)

    def _slice(self, x):
        if x is None or self.active_dims is None:
            return x
        return x[..., list(self.active_dims)]

    def forward(self, x1, x2=None):
        xs1 = self._slice(x1)
        xs2 = xs1 if x2 is None else self._slice(x2)
        return self.gram(xs1, xs2)

    def diag(self, x):
        return self._diag(self._slice(x))

    def gram(self, x1, x2):  # pragma: no cover - abstract
        raise NotImplementedError

    def _diag(self, x):
        return torch.diagonal(self.gram(x, x), dim1=-2, dim2=-1)

    def __add__(self, other):
        return Sum(self, other)

    def __mul__(self, other):
        return Product(self, other)


class Sum(Kernel):
    def __init__(self, *kernels: Kernel):
        super().__init__()
        self.kernels = nn.ModuleList(kernels)

    def forward(self, x1, x2=None):
        return sum(k(x1, x2) for k in self.kernels)

    def diag(self, x):
        return sum(k.diag(x) for k in self.kernels)


class Product(Kernel):
    def __init__(self, *kernels: Kernel):
        super().__init__()
        self.kernels = nn.ModuleList(kernels)

    def forward(self, x1, x2=None):
        out = None
        for k in self.kernels:
            g = k(x1, x2)
            out = g if out is None else out * g
        return out

    def diag(self, x):
        out = None
        for k in self.kernels:
            g = k.diag(x)
            out = g if out is None else out * g
        return out


class Scale(Kernel):
    """outputscale · base(x1, x2), outputscale = softplus(raw) + lower_bound
    (``lower_bound`` is GPyTorch's ``GreaterThan`` constraint, e.g. the
    temporal experiment's outputscale > 7)."""

    def __init__(self, base: Kernel, raw_outputscale: torch.Tensor, lower_bound: float = 0.0):
        super().__init__()
        self.base = base
        self.raw_outputscale = nn.Parameter(raw_outputscale)
        self.lower_bound = float(lower_bound)

    @classmethod
    def create(cls, base: Kernel, outputscale=1.0, lower_bound: float = 0.0, dtype=torch.float32, device=None):
        value = torch.clamp(torch.as_tensor(outputscale, dtype=dtype, device=device) - lower_bound, min=1e-6)
        return cls(base, raw_init(value), lower_bound)

    @property
    def outputscale(self) -> torch.Tensor:
        return positive(self.raw_outputscale) + self.lower_bound

    def forward(self, x1, x2=None):
        return self.outputscale[..., None, None] * self.base(x1, x2)

    def diag(self, x):
        return self.outputscale[..., None] * self.base.diag(x)
