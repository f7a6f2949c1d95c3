"""Inducing-point (Nyström / SGPR) covariance building blocks.

Counterpart of ``nonstationary_precip_tpu/kernels/inducing.py``: three
functions over a root matrix R with Q = R Rᵀ, batched over leading
dimensions.  The factor and the solve go through the port's
``safe_cholesky`` and ``tri_solve``, whose dispatch is the JAX package's.
"""

from __future__ import annotations

import torch

from nonstationary_precip_tpu_torch.ops.linalg import safe_cholesky, tri_solve
from nonstationary_precip_tpu_torch.utils.config import EPSILON


def nystrom_root(k_xz: torch.Tensor, k_zz: torch.Tensor, jitter: float = EPSILON):
    """R = K_xz L_zz⁻ᵀ, so that Q = K_xz K_zz⁻¹ K_zx = R Rᵀ: one triangular
    solve against the lower factor, no M × M inverse.  Returns (R (..., N, M),
    L_zz (..., M, M))."""
    l_zz = safe_cholesky(k_zz, jitter)
    # R = K_xz L⁻ᵀ  ⇔  Rᵀ = L⁻¹ K_zx
    return tri_solve(l_zz, k_xz.mT, lower=True).mT, l_zz


def sgpr_diag_correction(k_diag: torch.Tensor, root: torch.Tensor) -> torch.Tensor:
    """clamp(diag(K) − diag(Q), 0, ∞): the SGPR predictive's diagonal
    correction."""
    return torch.clamp(k_diag - torch.sum(root * root, dim=-1), min=0.0)


def inducing_added_loss_term(k_diag: torch.Tensor, root: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Titsias's collapsed-bound trace term −½ Σ (diag(K) − diag(Q)) / σ²,
    added to the data log-probability before the /N scaling."""
    q_diag = torch.sum(root * root, dim=-1)
    return -0.5 * torch.sum((k_diag - q_diag) / noise, dim=-1)
