"""Multivariate (full-matrix) Gibbs kernel — Paciorek & Schervish (2003).

Counterpart of ``nonstationary_precip_tpu/kernels/multivariate_gibbs.py``:

    k(xᵢ, xⱼ) = |Σᵢ|^{1/4} |Σⱼ|^{1/4} |(Σᵢ+Σⱼ)/2|^{-1/2}
                · exp( − dᵀ ((Σᵢ+Σⱼ)/2)⁻¹ d ),   d = xᵢ − xⱼ

with per-point 2×2 covariances built from a latent N×2 matrix H:

    Σ(x) = softplus( (h(x) h(x)ᵀ)²_elementwise ) + D²_elementwise

(the reference's parameterisation, the elementwise squares of the learnable
D included).  Every pairwise determinant and inverse is closed-form 2×2
algebra on (N₁, N₂) planes, in torch ops: the JAX package has no Pallas
kernel for this Gram, so neither does the port.

The clamps are the JAX package's, kept exactly: det Σ = ac − b² is a
cancellation, and at |h| ≈ 37 on the UIB field float32 rounds it to −65536,
which NaNs the ^¼.  ``_DET_FLOOR`` bounds det Σ, Minkowski's inequality
(det M ≥ √(det Σᵢ det Σⱼ) for the average M) bounds det M, and the
jittered det is bounded by det M + jitter·(a + c); each is a true lower
bound, so well-conditioned inputs take the computed branch bit for bit.
Every clamp is ``torch.maximum`` against a tensor, which splits the
gradient at a tie as ``jnp.maximum`` does.
"""

from __future__ import annotations

from typing import Optional

import torch

from nonstationary_precip_tpu_torch.utils.transforms import softplus

_JITTER = 1e-5  # reference: multivariate_gibbs_kernel.py:17
_DET_FLOOR = 1e-8


def sigma_components_2d(h: torch.Tensor, d_mat: torch.Tensor):
    """Per-point Σ(x) components for D = 2: (a, b, c), each (N,), with
    Σ = [[a, b], [b, c]].  h: (N, 2) rows of the latent matrix; d_mat: the
    (2, 2) learnable offset, whose squared off-diagonal entries are averaged
    (exact when D is diagonal, as initialised)."""
    d2 = d_mat**2
    a = softplus((h[:, 0] * h[:, 0]) ** 2) + d2[0, 0]
    c = softplus((h[:, 1] * h[:, 1]) ** 2) + d2[1, 1]
    b_off = softplus((h[:, 0] * h[:, 1]) ** 2)
    b = b_off + 0.5 * (d2[0, 1] + d2[1, 0])
    return a, b, c


def paciorek_schervish_gram_2d(x1: torch.Tensor, sig1: tuple, x2: torch.Tensor, sig2: tuple,
                               jitter: float = _JITTER) -> torch.Tensor:
    """Gram (N1, N2) from per-point 2×2 Σ components sig1 = (a1, b1, c1),
    each (N1,), and likewise sig2."""
    a1, b1, c1 = sig1
    a2, b2, c2 = sig2
    floor = torch.tensor(_DET_FLOOR, dtype=a1.dtype, device=a1.device)

    det1 = torch.maximum(a1 * c1 - b1 * b1, floor)  # (N1,)
    det2 = torch.maximum(a2 * c2 - b2 * b2, floor)  # (N2,)
    det_pref = (det1[:, None] * det2[None, :]) ** 0.25  # |Σi|^¼|Σj|^¼

    # M = (Σi + Σj)/2 componentwise, with the reference's jitter·I added
    # before inversion
    am = 0.5 * (a1[:, None] + a2[None, :])
    bm = 0.5 * (b1[:, None] + b2[None, :])
    cm = 0.5 * (c1[:, None] + c2[None, :])
    # Minkowski: det M ≥ √(det Σᵢ det Σⱼ)
    det_m = torch.maximum(am * cm - bm * bm, torch.sqrt(det1[:, None] * det2[None, :]))
    am_j, cm_j = am + jitter, cm + jitter
    # the jittered det = det M + jitter·(a + c) + jitter² ≥ det M + jitter·(a + c)
    det_m_j = torch.maximum(am_j * cm_j - bm * bm, det_m + jitter * (am + cm))

    dx = x1[:, None, 0] - x2[None, :, 0]
    dy = x1[:, None, 1] - x2[None, :, 1]
    # dᵀ M⁻¹ d for the jittered 2×2 M, closed form
    quad = (cm_j * dx * dx - 2.0 * bm * dx * dy + am_j * dy * dy) / det_m_j

    pref = det_pref / torch.sqrt(det_m)
    return pref * torch.exp(-quad)


class MultivariateGibbsKernel:
    """Callable wrapper: the Gram from the latent H rows at each input.

    ``h1``/``h2`` are the (N, 2) latent rows at x1/x2 (the trainable H at
    the training inputs; the matrix-normal conditional mean elsewhere);
    ``d_mat`` is the learnable 2×2 offset.  The reference detaches H inside
    the Gram; the models replicate that with ``detach_h``."""

    def __init__(self, active_dims: Optional[tuple] = None):
        self.active_dims = active_dims

    def _slice(self, x):
        if self.active_dims is None:
            return x
        return x[..., list(self.active_dims)]

    def __call__(self, x1, h1, d_mat, x2=None, h2=None):
        xs1 = self._slice(x1)
        sig1 = sigma_components_2d(h1, d_mat)
        if x2 is None:
            return paciorek_schervish_gram_2d(xs1, sig1, xs1, sig1)
        sig2 = sigma_components_2d(h2, d_mat)
        return paciorek_schervish_gram_2d(xs1, sig1, self._slice(x2), sig2)

    def diag(self, x, h, d_mat):
        """k(x, x) = 1 exactly, returned as the constant: in float32 at
        |h| ≈ 37 the quotient (det^¼)²/√det is 0/0."""
        return torch.ones(h.shape[:-1], dtype=h.dtype, device=h.device)
