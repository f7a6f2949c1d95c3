"""Dense linear algebra for GP inference, Cholesky-centric.

Counterpart of ``nonstationary_precip_tpu/ops/linalg.py``.  Everything is
batched over leading dimensions (the JAX package's ``vmap`` written out).
``safe_cholesky`` is one ``torch.autograd.Function``: the escalating-jitter
retry runs in the forward, and the backward is the closed-form Cholesky
pullback from the saved factor, so autograd never differentiates the retry
control flow (the jitter level is a non-differentiable choice, as in
GPyTorch's ``psd_safe_cholesky``).  The dispatch sites are the JAX
package's: ``cholesky`` sends a single float32 matrix with 768 ≤ N ≤ 1280 to
K10a, the blocked Cholesky (``ops/chol_blocked.py``), and one with
6144 ≤ N ≤ 8192 to K5, the streaming Cholesky (``ops/chol_stream.py``);
``tri_solve`` sends a lower, non-transposed solve of 2-D operands inside
K11's gate to the blocked triangular solve (``ops/trsm.py``).
"""

from __future__ import annotations

import math

import torch

from nonstationary_precip_tpu_torch.ops import chol_blocked, chol_stream, trsm
from nonstationary_precip_tpu_torch.utils.config import EPSILON

__all__ = [
    "add_jitter",
    "cholesky",
    "safe_cholesky",
    "tri_solve",
    "cho_solve",
    "diag_part",
    "mvn_logpdf_from_chol",
]


def add_jitter(mat: torch.Tensor, jitter: float = EPSILON) -> torch.Tensor:
    """K + jitter·I on the last two dims."""
    n = mat.shape[-1]
    return mat + jitter * torch.eye(n, dtype=mat.dtype, device=mat.device)


def cholesky_failed(chol: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """Per-member failure flag of a ``cholesky_ex`` result, (...,) bool.

    ``cholesky_ex`` reports a non-positive pivot as ``info > 0`` and leaves
    a partial factor; the JAX package's test is "any non-finite entry of L"
    (its Cholesky fills a failed factor with NaN).  Both count here."""
    return (info > 0) | ~torch.isfinite(chol).all(dim=-1).all(dim=-1)


def escalating_jitter(mat: torch.Tensor, factor, jitter: float, max_tries: int):
    """Run ``factor(mats) -> (out, failed)`` on ``mat`` and refactor each
    failing member from ``mat + j·I``, j = ``jitter`` then ×10, at most
    ``max_tries`` times.

    ``out`` is a tuple of tensors with ``mat``'s batch shape in front;
    ``failed`` is a (...,) bool.  Escalation is per member, as in the JAX
    package's while-loop: a member that never failed keeps j = 0 and its
    first result, a member that turns finite at retry k keeps that jitter.
    A member still failing after the last try comes back NaN.  Returns
    ``(out, j)`` with j the (...,) jitter each member ended with."""
    base = jitter if jitter > 0 else EPSILON
    batch, n = mat.shape[:-2], mat.shape[-1]
    flat = mat.reshape(-1, n, n)
    out, failed = factor(flat)
    out = [o.clone() for o in out]
    j = torch.zeros(flat.shape[0], dtype=mat.dtype, device=mat.device)
    eye = torch.eye(n, dtype=mat.dtype, device=mat.device)
    for _ in range(max_tries):
        if not bool(failed.any()):
            break
        j = torch.where(failed, torch.where(j == 0, torch.full_like(j, base), j * 10.0), j)
        idx = failed.nonzero()[:, 0]
        sub_out, sub_failed = factor(flat[idx] + j[idx, None, None] * eye)
        for o, s in zip(out, sub_out):
            o[idx] = s
        failed = failed.clone()
        failed[idx] = sub_failed
    if bool(failed.any()):
        for o in out:
            o[failed] = float("nan")
    return tuple(o.reshape(*batch, *o.shape[1:]) for o in out), j.reshape(batch)


def cholesky_ex(mat: torch.Tensor):
    """(L, info) of ``mat`` (..., n, n), the JAX package's ``cholesky``
    dispatch: one float32 matrix with 768 ≤ N ≤ 1280 goes through K10a
    (``ops/chol_blocked``), one with 6144 ≤ N ≤ 8192 through K5
    (``ops/chol_stream``), each the kernel on the card and its plain version
    on the CPU, a failed factor NaN and ``info`` 0; everything else takes
    ``torch.linalg.cholesky_ex``, as the JAX package leaves it to XLA."""
    ok = torch.zeros((), dtype=torch.int32, device=mat.device)
    if chol_blocked.eligible(mat):
        return chol_blocked.blocked_cholesky(mat), ok
    if chol_stream.stream_eligible(mat):
        return chol_stream.streaming_cholesky(mat), ok
    return torch.linalg.cholesky_ex(mat)


def cholesky(mat: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor with :func:`cholesky_ex`'s dispatch."""
    return cholesky_ex(mat)[0]


def _cholesky_attempt(mats):
    """One try of ``safe_cholesky`` of a 2-D matrix on ``escalating_jitter``'s
    (1, n, n) stack, through :func:`cholesky_ex`'s dispatch."""
    chol, info = cholesky_ex(mats[0])
    return (chol[None],), cholesky_failed(chol[None], info.reshape(1))


def _batched_attempt(mats):
    """One try of ``safe_cholesky`` of a stack: the library, as the JAX
    package's dispatch takes 2-D matrices only."""
    chol, info = torch.linalg.cholesky_ex(mats)
    return (chol,), cholesky_failed(chol, info)


class _SafeCholesky(torch.autograd.Function):
    """Cholesky with per-member escalating-jitter retry (forward) and the
    Murray (2016) closed-form pullback (backward)."""

    @staticmethod
    def forward(ctx, mat, jitter, max_tries):
        attempt = _cholesky_attempt if mat.ndim == 2 else _batched_attempt
        (chol,), _ = escalating_jitter(mat, attempt, jitter, max_tries)
        ctx.save_for_backward(chol)
        return chol

    @staticmethod
    def backward(ctx, g):
        (chol,) = ctx.saved_tensors
        return cholesky_pullback(chol, g), None, None


def cholesky_pullback(chol: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Closed-form Cholesky pullback from the saved factor (Murray 2016; the
    JAX package's ``_chol_pullback``): K̄ = sym(L⁻ᵀ Φ(LᵀL̄) L⁻¹), Φ = tril
    with halved diagonal; two triangular solves, no refactorisation."""
    p = chol.mT @ g
    phi = torch.tril(p) - 0.5 * torch.diag_embed(torch.diagonal(p, dim1=-2, dim2=-1))
    w = torch.linalg.solve_triangular(chol.mT, phi, upper=True)
    kbar_t = torch.linalg.solve_triangular(chol.mT, w.mT, upper=True)
    return 0.5 * (kbar_t + kbar_t.mT)


def safe_cholesky(mat: torch.Tensor, jitter: float = EPSILON, max_tries: int = 6) -> torch.Tensor:
    """Lower Cholesky factor with escalating-jitter retry (GPyTorch
    ``psd_safe_cholesky`` semantics: the plain factorisation first, then
    jitter·10ⁱ on failure, per batch member)."""
    return _SafeCholesky.apply(mat, jitter, max_tries)


def tri_solve(chol: torch.Tensor, rhs: torch.Tensor, *, lower: bool = True, trans: bool = False) -> torch.Tensor:
    """Solve L x = rhs (or Lᵀ x = rhs when ``trans``) for triangular L.

    rhs may be a vector (..., n) or a matrix (..., n, k).  A lower,
    non-transposed solve of a 2-D L and a 2-D rhs inside K11's gate goes
    through ``ops/trsm`` (the kernel on the card, its plain version on the
    CPU), as the JAX package's ``tri_solve`` dispatches it."""
    if lower and not trans and rhs.ndim == 2 and chol.ndim == 2 and trsm.eligible(chol, rhs):
        return trsm.blocked_trsm(chol, rhs)
    vec = rhs.ndim == chol.ndim - 1
    if vec:
        rhs = rhs[..., None]
    a, upper = (chol.mT, lower) if trans else (chol, not lower)
    out = torch.linalg.solve_triangular(a, rhs, upper=upper)
    return out[..., 0] if vec else out


def cho_solve(chol: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve (L Lᵀ) x = rhs given lower-triangular L."""
    return tri_solve(chol, tri_solve(chol, rhs), trans=True)


def diag_part(mat: torch.Tensor) -> torch.Tensor:
    """Diagonal of (..., N, N)."""
    return torch.diagonal(mat, dim1=-2, dim2=-1)


def mvn_logpdf_from_chol(y: torch.Tensor, mean: torch.Tensor, chol: torch.Tensor) -> torch.Tensor:
    """log N(y | mean, L Lᵀ) with L lower triangular, batched over leading dims."""
    n = y.shape[-1]
    alpha = tri_solve(chol, y - mean)
    quad = torch.sum(alpha**2, dim=-1)
    logdet = 2.0 * torch.sum(torch.log(diag_part(chol)), dim=-1)
    return -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))
