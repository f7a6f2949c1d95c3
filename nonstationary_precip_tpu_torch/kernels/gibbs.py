"""Diagonal (per-dimension) Gibbs nonstationary kernel.

Counterpart of ``nonstationary_precip_tpu/kernels/gibbs.py``:

    k(x, x') = ∏_d sqrt( 2 ℓ_d(x) ℓ_d(x') / (ℓ_d(x)² + ℓ_d(x')²) )
               · exp( − Σ_d (x_d − x'_d)² / (ℓ_d(x)² + ℓ_d(x')²) )

Layout: x and ell are (..., N, D), row per point; leading dimensions batch.
``gibbs_gram`` is the dispatcher, as in the JAX package: a float32 pair, or
a stack of pairs with one leading shape (the JAX package's ``vmap`` written
out), inside K9's gate (``ops/gibbs_gram.eligible``: on the card, D ≤ 8,
N₁·N₂ ≥ 128² a member) takes the hand-written Gram kernel, one launch for
the stack; everything else ``gibbs_gram_reference``, the plain batched
Gram.  The matrix-free paths
build their panels through the plain Gram by name, as the JAX package's do.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from nonstationary_precip_tpu_torch.utils.transforms import positive


def gibbs_gram_reference(x1: torch.Tensor, ell1: torch.Tensor, x2: torch.Tensor,
                         ell2: torch.Tensor) -> torch.Tensor:
    """Gibbs cross-Gram (..., N1, N2) of x1, ell1 (..., N1, D) and x2, ell2
    (..., N2, D), in plain PyTorch."""
    sq_sum = ell1[..., :, None, :] ** 2 + ell2[..., None, :, :] ** 2
    prod = ell1[..., :, None, :] * ell2[..., None, :, :]
    pref = torch.prod(torch.sqrt(2.0 * prod / sq_sum), dim=-1)
    diff = x1[..., :, None, :] - x2[..., None, :, :]
    quad = torch.sum(diff**2 / sq_sum, dim=-1)
    return pref * torch.exp(-quad)


def gibbs_gram(x1: torch.Tensor, ell1: torch.Tensor, x2: torch.Tensor, ell2: torch.Tensor) -> torch.Tensor:
    """:func:`gibbs_gram_reference`'s Gram, through K9 where its gate
    admits the pair (on the card)."""
    from nonstationary_precip_tpu_torch.ops import gibbs_gram as k9

    if k9.eligible(x1, x2):
        return k9.gibbs_gram_pallas(x1, ell1, x2, ell2)
    return gibbs_gram_reference(x1, ell1, x2, ell2)


@functools.lru_cache(maxsize=8)
def packed_gibbs_cross(d: int):
    """cross_fn of the matrix-free paths' packed payload: rows are
    ``x_aug = [x, log ℓ]`` split at ``d``.  ``raw_s2`` is the raw (softplus)
    outputscale, or None for the unscaled Gram.  The matrix-free backward
    rebuilds panels through this function, so it must compute the operator
    of ``ops/matvec.scaled_packed_gibbs_matvec_builder(d)``."""

    def cross(raw_s2, xa, xb):
        k = gibbs_gram_reference(xa[:, :d], torch.exp(xa[:, d:]), xb[:, :d], torch.exp(xb[:, d:]))
        return k if raw_s2 is None else positive(raw_s2) * k

    return cross


def gibbs_diag(x: torch.Tensor, ell: torch.Tensor) -> torch.Tensor:
    """Diagonal of the Gibbs Gram: identically 1."""
    return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)


class GibbsKernel:
    """Binds optional ``active_dims`` to the Gibbs Gram; ``ell1``/``ell2``
    are the positive lengthscales at the respective inputs, one column per
    active dim."""

    def __init__(self, active_dims: Optional[tuple] = None):
        self.active_dims = active_dims

    def _slice(self, x):
        if self.active_dims is None:
            return x
        return x[..., list(self.active_dims)]

    def _check_ell(self, xs, ell):
        if ell.shape[-1] != xs.shape[-1]:
            raise ValueError(
                f"ell has {ell.shape[-1]} columns but the kernel operates on "
                f"{xs.shape[-1]} active dims ({self.active_dims}); pass ell "
                "sliced to the active dims"
            )

    def __call__(self, x1, ell1, x2=None, ell2=None):
        xs1 = self._slice(x1)
        self._check_ell(xs1, ell1)
        if x2 is None:
            xs2, ell2 = xs1, ell1
        else:
            xs2 = self._slice(x2)
            self._check_ell(xs2, ell2)
        return gibbs_gram(xs1, ell1, xs2, ell2)

    def diag(self, x, ell):
        xs = self._slice(x)
        self._check_ell(xs, ell)
        return gibbs_diag(xs, ell)
