"""Positivity transforms for raw (unconstrained) parameters.

Counterpart of ``nonstationary_precip_tpu/utils/transforms.py``: GPyTorch's
softplus parameterisation, ``constrained = softplus(raw)``, and
``LearnedSoftPlus`` (the reference's models/latent_priors.py:16-25: a
softplus with a learnable, log-parameterised β and a linearisation
threshold of 20).
"""

from __future__ import annotations

import math

import torch
from torch import nn


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + eˣ) as ``logaddexp(x, 0)`` — the JAX package's form (no
    linearisation threshold, unlike ``torch.nn.functional.softplus``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def inv_softplus(y: torch.Tensor) -> torch.Tensor:
    """Inverse of softplus: log(exp(y) - 1), stable for large y."""
    return y + torch.log(-torch.expm1(-y))


def positive(raw: torch.Tensor) -> torch.Tensor:
    """Constrained value of a raw parameter (softplus, GPyTorch default)."""
    return softplus(raw)


def raw_init(value, dtype=None, device=None) -> torch.Tensor:
    """Raw parameter whose constrained value equals ``value``."""
    return inv_softplus(torch.as_tensor(value, dtype=dtype, device=device))


class LearnedSoftPlus(nn.Module):
    """Softplus with a learnable β: log1p(exp(βx))/β where βx < threshold,
    else x."""

    def __init__(self, log_beta: torch.Tensor, threshold: float = 20.0):
        super().__init__()
        self.log_beta = nn.Parameter(log_beta)
        self.threshold = threshold

    @classmethod
    def create(cls, init_beta: float = 1.0, dtype=torch.float32, device=None) -> "LearnedSoftPlus":
        return cls(torch.tensor(math.log(init_beta), dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        beta = torch.exp(self.log_beta)
        beta_x = beta * x
        small = beta_x < self.threshold
        # the unselected branch's input is clamped: exp(βx) overflows past
        # ~88 in float32, and inf/inf in its gradient would give NaN through
        # the where's 0·NaN
        safe_bx = torch.where(small, beta_x, torch.zeros_like(beta_x))
        return torch.where(small, torch.log1p(torch.exp(safe_bx)) / beta, x)
