"""Stationary-kernel helpers.

Counterpart of ``nonstationary_precip_tpu/kernels/stationary.py``; the port
needs only the squared-distance helper the log-normal prior uses.
"""

from __future__ import annotations

import torch


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances via the matmul identity, clamped at 0."""
    a_sq = torch.sum(a * a, dim=-1)[..., :, None]
    b_sq = torch.sum(b * b, dim=-1)[..., None, :]
    ab = a @ b.mT
    return torch.clamp(a_sq + b_sq - 2.0 * ab, min=0.0)
