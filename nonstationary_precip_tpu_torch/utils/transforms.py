"""Positivity transforms for raw (unconstrained) parameters.

Counterpart of ``nonstationary_precip_tpu/utils/transforms.py``: GPyTorch's
softplus parameterisation, ``constrained = softplus(raw)``.
"""

from __future__ import annotations

import torch


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
