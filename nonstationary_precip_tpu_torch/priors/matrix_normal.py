"""Matrix-normal prior on an N×D latent matrix, Kronecker-free.

Counterpart of ``nonstationary_precip_tpu/priors/matrix_normal.py``.  With
U = K_row + jitter·I (N×N) and V = K_col (D×D), the Kronecker identities
give everything at O(N²D):

  log p(H) = −½ [ tr(V⁻¹ Hᵀ U⁻¹ H) + N log|V| + D log|U| + ND log 2π ]
  sample   =  M + L_U Z L_Vᵀ,  Z ~ N(0, I_{N×D})
  E[H* | H] = K_*z U⁻¹ (H − M)   (the column covariance cancels)

The three matrices are frozen leaves (parameters with
``requires_grad=False``), so they travel with the model's ``state_dict``.
The standard-normal draw of ``sample`` comes from the caller, as a
``torch.Generator`` or as the (N, D) draw itself.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn

from nonstationary_precip_tpu_torch.kernels.stationary import _sq_dist as sq_dist
from nonstationary_precip_tpu_torch.ops.linalg import cho_solve, diag_part, safe_cholesky, tri_solve

_JITTER = 1e-5  # reference: latent_priors.py:14


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class MatrixNormalPrior(nn.Module):
    """MN(loc, U=row_cov + jitter·I, V=col_cov) over N×D matrices."""

    def __init__(self, loc: torch.Tensor, row_cov: torch.Tensor, col_cov: torch.Tensor, jitter: float = _JITTER):
        super().__init__()
        self.loc = _frozen(loc)
        self.row_cov = _frozen(row_cov)
        self.col_cov = _frozen(col_cov)
        self.jitter = jitter

    @property
    def n(self) -> int:
        return self.row_cov.shape[-1]

    @property
    def d(self) -> int:
        return self.col_cov.shape[-1]

    def _chol_u(self) -> torch.Tensor:
        eye = torch.eye(self.n, dtype=self.row_cov.dtype, device=self.row_cov.device)
        return safe_cholesky(self.row_cov + self.jitter * eye, self.jitter)

    def _chol_v(self) -> torch.Tensor:
        return safe_cholesky(self.col_cov, self.jitter)

    def sample(self, draw: Union[torch.Generator, torch.Tensor]) -> torch.Tensor:
        """One exact draw H = loc + L_U Z L_Vᵀ.  ``draw`` is a generator
        (Z drawn from it on its own device, then moved to the prior's) or Z
        itself, an (N, D) standard-normal tensor."""
        if isinstance(draw, torch.Generator):
            draw = torch.randn((self.n, self.d), generator=draw, dtype=self.loc.dtype, device=draw.device)
        z = torch.as_tensor(draw, dtype=self.loc.dtype, device=self.loc.device)
        return self.loc + self._chol_u() @ z @ self._chol_v().T

    def log_prob(self, h: torch.Tensor) -> torch.Tensor:
        """Coherent matrix-normal log-density (the reference's vec-ordering
        mismatch is not replicated, as in the JAX package)."""
        lu = self._chol_u()
        lv = self._chol_v()
        diff = h - self.loc
        # tr(V⁻¹ diffᵀ U⁻¹ diff) = ‖L_U⁻¹ diff L_V⁻ᵀ‖_F²
        a = tri_solve(lu, diff)  # (N, D)
        b = tri_solve(lv, a.T)  # (D, N)
        quad = torch.sum(b * b)
        logdet_u = 2.0 * torch.sum(torch.log(diag_part(lu)))
        logdet_v = 2.0 * torch.sum(torch.log(diag_part(lv)))
        n, d = self.n, self.d
        return -0.5 * (quad + d * logdet_u + n * logdet_v + n * d * math.log(2 * math.pi))

    def conditional_mean(self, k_xz: torch.Tensor, h: torch.Tensor,
                         loc_new: Optional[torch.Tensor] = None) -> torch.Tensor:
        """E[H(x*) | H] = M* + K_*z U⁻¹ (H − M); ``loc_new`` (M*) defaults
        to zeros."""
        mu = k_xz @ cho_solve(self._chol_u(), h - self.loc)
        return mu if loc_new is None else loc_new + mu


def latent_rbf_row_cov(x: torch.Tensor, lengthscale, outputscale: Optional[float] = None) -> torch.Tensor:
    """Frozen RBF row covariance for the H prior (the reference freezes an
    RBF with lengthscale [0.2, 0.2])."""
    ell = torch.as_tensor(lengthscale, dtype=x.dtype, device=x.device)
    a = x / ell
    k = torch.exp(-0.5 * sq_dist(a, a))
    if outputscale is not None:
        k = outputscale * k
    return k
