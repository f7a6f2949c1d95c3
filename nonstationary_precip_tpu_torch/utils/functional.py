"""Batched linear-algebra convenience functions: the compatibility API.

Counterpart of ``nonstationary_precip_tpu/utils/functional.py`` (the
reference's ``utils/functional.py``, :14-162), on tensors: terse names for
batched dot, transpose, trace, matvec and quadratic forms,
(half-)vectorisation, Kronecker products and projections, so code that
calls ``fn.quad`` or ``fn.vech`` finds the same surface.  Solves go through
Cholesky (``ops/linalg.solve_psd``), since every matrix here is PSD.  The
port's own modules call ``ops/linalg`` directly.
"""

from __future__ import annotations

import bisect
import math
from typing import NamedTuple

import numpy as np
import torch

from nonstationary_precip_tpu_torch.ops.linalg import robust_logdet, solve_psd  # noqa: F401


def dot(v1, v2):
    """Batch dot product v1ᵀv2 over the last dim."""
    return torch.sum(v1 * v2, dim=-1)


def t(x):
    """Matrix transpose on the last two dims."""
    return x.mT


def tr(x):
    """Trace over the last two dims."""
    return torch.diagonal(x, dim1=-2, dim2=-1).sum(dim=-1)


def mv(matrix, vector, invert: bool = False):
    """matrix @ vector, or matrix⁻¹ vector when ``invert`` (PSD solve)."""
    if invert:
        return solve_psd(matrix, vector)
    return (matrix @ vector[..., None])[..., 0]


def quad(v, matrix, v2=None, invert: bool = False):
    """vᵀ M v2 (or vᵀ M⁻¹ v2 when ``invert``)."""
    if v2 is None:
        v2 = v
    v2 = solve_psd(matrix, v2) if invert else mv(matrix, v2)
    return dot(v, v2)


def expquad(v, matrix, invert: bool = False, out_scale=1.0, exp_scale=0.5):
    """out_scale · exp(−exp_scale · vᵀ M^{±1} v)."""
    return out_scale * torch.exp(-exp_scale * quad(v, matrix, invert=invert))


def sym(x):
    """Force symmetry: (X + Xᵀ)/2."""
    return 0.5 * (x + t(x))


def op(v1, v2=None):
    """Vector outer product."""
    if v2 is None:
        v2 = v1
    return v1[..., :, None] * v2[..., None, :]


def vec(x):
    """Column-stacking vectorisation of the last two dims."""
    batch = x.shape[:-2]
    return t(x).reshape(*batch, x.shape[-2] * x.shape[-1])


def vech(x):
    """Half-vectorisation: lower-triangle (incl. diagonal) entries, row by row."""
    d = x.shape[-2]
    if x.shape[-1] != d:
        raise ValueError(f"vech needs a square matrix, got {tuple(x.shape)}")
    idx = torch.tril_indices(d, d, device=x.device)
    return x[..., idx[0], idx[1]]


def kron(x, y):
    """Batched Kronecker product over the last two dims."""
    size1 = (x.shape[-2] * y.shape[-2], x.shape[-1] * y.shape[-1])
    res = x[..., :, None, :, None] * y[..., None, :, None, :]
    return res.reshape(*res.shape[:-4], *size1)


def duplication_matrix(n: int, dtype=torch.float32):
    """D_n with vec(X) = D_n vech(X) for symmetric X (the reference's
    ``fn.`` self-reference at utils/functional.py:114 fixed, as in JAX)."""
    m = n * (n + 1) // 2
    out = torch.zeros((n * n, m), dtype=dtype)
    for j in range(1, n + 1):
        for i in range(j, n + 1):
            u = torch.zeros(m, dtype=dtype)
            u[(j - 1) * n + i - j * (j - 1) // 2 - 1] = 1.0
            tmat = torch.zeros((n, n), dtype=dtype)
            tmat[i - 1, j - 1] = 1.0
            tmat[j - 1, i - 1] = 1.0
            out = out + op(vec(tmat), u)
    return out


def diff(x, boundary_value=None, dim: int = -2):
    """Forward differences along ``dim``, length-preserving (the final entry
    repeats the last difference unless ``boundary_value`` is given)."""
    x = x.transpose(dim, -1)
    d = x[..., 1:] - x[..., :-1]
    if boundary_value is None:
        boundary = d[..., -1:]
    else:
        boundary = torch.as_tensor(boundary_value, dtype=x.dtype, device=x.device)[..., None]
        boundary = boundary.expand(*d.shape[:-1], 1)
    return torch.cat([d, boundary], dim=-1).transpose(dim, -1)


def normalise(x, axis: int = -1):
    """Zero-mean, √N-scaled unit-norm over ``axis``."""
    x = x - torch.mean(x, dim=axis, keepdim=True)
    norm = torch.linalg.vector_norm(x, dim=axis, keepdim=True)
    return math.sqrt(x.shape[axis]) * x / torch.clamp_min(norm, 1e-12)


class Projection(NamedTuple):
    projection: torch.Tensor
    matrix: torch.Tensor


def project_pca(d: int, y) -> Projection:
    """Project rows of y (..., N, Δ) onto the d directions of maximum
    variance; returns (projection (..., N, d), basis (d, Δ))."""
    _, eigenvecs = torch.linalg.eigh(t(y) @ y)
    basis = t(eigenvecs[..., -d:])
    return Projection(torch.einsum("...dk,...nk->...nd", basis, y), basis)


def project_lstsq(y, c, d) -> Projection:
    """Least-squares x for y = Cx + d."""
    soln = torch.linalg.lstsq(c, t(y - d)).solution
    return Projection(t(soln), c)


def bisect_right(array, value, tol: float = 1e-8) -> int:
    """Tolerant host-side bisect (the reference's utils/functional.py:67-74)."""
    return bisect.bisect_right(np.asarray(array), value + tol)


def bisect_left(array, value, tol: float = 1e-8) -> int:
    return bisect.bisect_left(np.asarray(array), value + tol)
