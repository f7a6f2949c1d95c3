"""Row-sharded BBMM: the exact-GP MLL and prediction with the train Gram
split over ranks, never whole on one device.

Counterpart of ``nonstationary_precip_tpu/parallel/sharded_cg.py``:

  * each rank builds only its (N/P, N) row block of K + σ²I from its rows
    of x (``_gram_rows``: σ² on the global diagonal, local row j being
    global row rank·N/P + j), or applies it without forming it through a
    ``local_matvec_builder`` (``packed_gibbs_local_matvec``: K2 on the
    rectangular block);
  * the mBCG matvec is the local (N/P, N) × (N, R) product followed by a
    tiled ``all_gather``, so every CG scalar is a reduction of replicated
    vectors and every rank walks the same trajectory;
  * the backward forms only the rank's (N/P, N) rows of the cotangent
    ½ααᵀ − ¼/R (S Rᵀ + R Sᵀ) and pulls them back through the plain
    ``cross_fn`` row block, as JAX does (never K3); the kernel's, σ²'s and
    the column side's x gradients are summed over the ranks, and the
    local rows' x gradient is gathered into place, so per-point state
    packed into x (Gibbs lengthscales) trains.

The estimator is ``ops/lazy_cg``'s: ``sharded_cg_mll`` is ``lazy_cg_mll``
with the sharded operator and backward, the preconditioner factor and the
probes built from the global x on every rank exactly as there, and
``make_sharded_chunked_mll``, the posterior and the serving state and
query are the single-device entries over the same operator (with mBCG's
``stop_every``, as the port's chunked entries are); only the mean-only
query keeps a sharded contraction of its own.  Randomness comes from the caller (``probe_noise``,
``precond_key``), as in ``lazy_cg``.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from nonstationary_precip_tpu_torch.ops.lazy_cg import (
    ChunkedMLL,
    LazyPosteriorState,
    _panel,
    check_divisible,
    default_cross,
    lazy_cg_mll,
    lazy_cg_posterior,
    lazy_posterior_query,
    lazy_posterior_state,
    panel_pullback,
)
from nonstationary_precip_tpu_torch.parallel.collectives import all_gather, psum
from nonstationary_precip_tpu_torch.parallel.mesh import Mesh


def _check_divisible(n: int, mesh: Mesh):
    check_divisible(n, mesh.size, "x", "mesh size")


def _gram_rows(kernel, x_local, x, sigma2, mesh: Mesh, cross_fn):
    """This rank's (N/P, N) row block of K + σ²I.  The σ² ridge lands on
    the global diagonal: local row j is global row rank·(N/P) + j."""
    return _panel(kernel, x_local, x, sigma2, mesh.rank * x_local.shape[0], cross_fn)


@functools.lru_cache(maxsize=8)
def packed_gibbs_local_matvec(d: int):
    """Local matvec builder for the packed Gibbs payload
    x_aug = [x, log ℓ]: rows [i0, i0 + N/P) of (K + σ²I)v, i0 = rank·N/P,
    through ``ops/matvec.make_gibbs_matvec`` on the rectangular (N/P, N)
    block (K2 on the card, its plain version on the CPU), so the row block
    the default path materialises never exists.  Pass it as
    ``local_matvec_builder``; forward only (the backward rebuilds the row
    block through ``cross_fn``).  ``kernel`` is unused: the unscaled Gram."""
    from nonstationary_precip_tpu_torch.ops.matvec import make_gibbs_matvec

    def builder(kernel, x_local, x, sigma2, mesh: Mesh):
        nl = x_local.shape[0]
        i0 = mesh.rank * nl
        mv = make_gibbs_matvec(x_local[:, :d], torch.exp(x_local[:, d:]), x[:, :d], torch.exp(x[:, d:]))
        return lambda v: mv(v) + sigma2 * v[i0:i0 + nl]

    return builder


def _local_operator(kernel, x, sigma2, mesh: Mesh, cross_fn, local_matvec_builder):
    """v ↦ this rank's rows of (K + σ²I)v: the builder's, or the row block
    materialised once and re-read every iteration."""
    x_local = mesh.rows(x)
    if local_matvec_builder is not None:
        return local_matvec_builder(kernel, x_local, x, sigma2, mesh)
    k_local = _gram_rows(kernel, x_local, x, sigma2, mesh, cross_fn)
    return lambda v: k_local @ v


def sharded_operator(mesh: Mesh, cross_fn: Callable, local_matvec_builder: Optional[Callable] = None):
    """A ``matvec_builder`` for ``ops/lazy_cg``: ``(kernel, x, sigma2) ->
    matvec``, the (N, R) → (N, R) product with K + σ²I made of each rank's
    rows and one tiled ``all_gather``; x is held whole by every rank."""

    def builder(kernel, x, sigma2):
        _check_divisible(x.shape[0], mesh)
        local = _local_operator(kernel, x, sigma2, mesh, cross_fn, local_matvec_builder)
        return lambda v: all_gather(local(v), mesh)

    return builder


def sharded_panel_vjp(mesh: Mesh, cross_fn: Callable):
    """A ``panel_vjp`` for ``ops/lazy_cg``: this rank's rows of the MLL
    cotangent pulled back through the plain ``cross_fn`` row block
    (``panel_pullback``), then the kernel's, σ²'s and the column side's x
    gradients summed over the ranks, and the rows' x gradients gathered in
    rank order (JAX's ``bwd_inner``).  Every rank returns the whole,
    replicated gradient."""

    def panel_vjp(kernel, x, sigma2, alpha, solves, rights, g):
        nl = x.shape[0] // mesh.size
        kg, rows, cols, s2g = panel_pullback(cross_fn, kernel, x, sigma2, alpha, solves, rights, g,
                                             mesh.rank * nl, nl, nl)
        if isinstance(kg, torch.Tensor):
            kg = psum(kg, mesh)
        elif kg is not None:
            kg = tuple(None if t is None else psum(t, mesh) for t in kg)
        return kg, all_gather(rows, mesh) + psum(cols, mesh), psum(s2g, mesh)

    return panel_vjp


# ---------------------------------------------------------------------------
# MLL (differentiable w.r.t. the kernel, x, resid, sigma2)
# ---------------------------------------------------------------------------


def sharded_cg_mll(kernel, x: torch.Tensor, resid: torch.Tensor, probe_noise, sigma2, mesh: Mesh, *,
                   max_iters: int = 100, tol: float = 1e-6, cross_fn: Optional[Callable] = None,
                   local_matvec_builder: Optional[Callable] = None, precond_rank: int = 0, precond_key=None,
                   precond: str = "pivchol", precond_shift: float = 1.0,
                   precond_lpc: Optional[torch.Tensor] = None, stop_every: int = 0,
                   info: Optional[dict] = None) -> torch.Tensor:
    """−½ rᵀK⁻¹r − ½ log det K − (n/2) log 2π with K = kernel(x) + σ²I
    row-split over ``mesh`` (never whole).  x, resid and σ² are held whole
    by every rank; the value and the gradients (w.r.t. the kernel, x, resid
    and σ²) come back the same on every rank.

    ``lazy_cg_mll``'s contract otherwise: ``probe_noise`` the (N, R)
    Rademacher probes, or with a preconditioner the normal draws (u1, u2)
    of N(0, P) probes; the factor (greedy pivoted Cholesky, RPCholesky's
    or the Nyström one per ``precond`` and ``precond_key``, or
    ``precond_lpc``) built from the global x on every rank, with ridge
    ``precond_shift``·σ².  ``local_matvec_builder`` (e.g.
    ``packed_gibbs_local_matvec(d)``) swaps the materialised row block for
    a fused Gram·v; the trajectories then agree with the default to
    rounding, not bitwise.  ``stop_every``, ``info`` as in ``lazy_cg_mll``.
    The mesh size must divide N."""
    n = x.shape[0]
    _check_divisible(n, mesh)
    cross = cross_fn or default_cross
    return lazy_cg_mll(kernel, x, resid, probe_noise, sigma2, block=n, max_iters=max_iters, tol=tol,
                       precond_rank=precond_rank, precond_key=precond_key, precond=precond,
                       precond_shift=precond_shift, precond_lpc=precond_lpc, cross_fn=cross,
                       matvec_builder=sharded_operator(mesh, cross, local_matvec_builder),
                       panel_vjp=sharded_panel_vjp(mesh, cross), stop_every=stop_every, info=info)


def make_sharded_chunked_mll(mesh: Mesh, chunk_iters: int, n_chunks: int, tol: float, precond_rank: int,
                             precond: str, precond_shift: float, cross_fn: Callable,
                             local_matvec_builder: Optional[Callable] = None) -> ChunkedMLL:
    """The row-sharded ``ops/lazy_cg.make_chunked_mll``: a ``ChunkedMLL``
    whose ``value_and_grad(kernel, x, resid, sigma2, probe_noise,
    pkey=None, early_stop=True)`` is :func:`sharded_cg_mll` at a budget of
    ``chunk_iters``·``n_chunks`` iterations, stopped early every
    ``chunk_iters`` (the JAX package drives chunks of device programs from
    the host to stay under its TPU's execution wall)."""
    return ChunkedMLL(chunk_iters, n_chunks, mll=functools.partial(sharded_cg_mll, mesh=mesh), tol=tol,
                      precond_rank=precond_rank, precond=precond, precond_shift=precond_shift, cross_fn=cross_fn,
                      local_matvec_builder=local_matvec_builder)


# ---------------------------------------------------------------------------
# posterior (prediction: deterministic, no probes, no gradient)
# ---------------------------------------------------------------------------


@torch.no_grad()
def sharded_cg_posterior(kernel, x: torch.Tensor, resid: torch.Tensor, x_test: torch.Tensor, sigma2, mesh: Mesh,
                         *, max_iters: int = 1000, tol: float = 1e-6, cross_fn: Optional[Callable] = None,
                         local_matvec_builder: Optional[Callable] = None, precond_rank: int = 0, precond_key=None,
                         precond: str = "pivchol"):
    """(mean, cov) of the zero-mean exact-GP posterior at ``x_test``:
    ``ops/lazy_cg.lazy_cg_posterior`` with its one mBCG (1 + N*
    right-hand sides) over the row-sharded operator.  A breakdown makes
    both NaN.  The caller adds its mean function and noise."""
    _check_divisible(x.shape[0], mesh)
    cross = cross_fn or default_cross
    return lazy_cg_posterior(kernel, x, resid, x_test, sigma2, block=x.shape[0], max_iters=max_iters, tol=tol,
                             precond_rank=precond_rank, precond_key=precond_key, precond=precond, cross_fn=cross,
                             matvec_builder=sharded_operator(mesh, cross, local_matvec_builder))


@torch.no_grad()
def sharded_posterior_state(kernel, x: torch.Tensor, resid: torch.Tensor, sigma2, mesh: Mesh, *,
                            max_iters: int = 64, tol: float = 1e-8, precond_rank: int = 150,
                            precond: str = "pivchol", precond_key=None, precond_shift: float = 1.0,
                            cross_fn: Optional[Callable] = None,
                            local_matvec_builder: Optional[Callable] = None) -> LazyPosteriorState:
    """The row-sharded build of ``ops/lazy_cg.LazyPosteriorState``: the α
    solve is sharded mBCG, the factor replicated math built from the global
    x.  Returns the single-device builder's state, so a query can be served
    by either :func:`sharded_posterior_query` or ``lazy_posterior_query``."""
    _check_divisible(x.shape[0], mesh)
    cross = cross_fn or default_cross
    return lazy_posterior_state(kernel, x, resid, sigma2, block=x.shape[0], max_iters=max_iters, tol=tol,
                                precond_rank=precond_rank, precond=precond, precond_key=precond_key,
                                precond_shift=precond_shift, cross_fn=cross,
                                matvec_builder=sharded_operator(mesh, cross, local_matvec_builder))


@torch.no_grad()
def sharded_posterior_query(state: LazyPosteriorState, x_test: torch.Tensor, mesh: Mesh, *, mean_only: bool = False,
                            max_iters: int = 64, tol: float = 1e-6, precond_shift: float = 1.0,
                            cross_fn: Optional[Callable] = None, local_matvec_builder: Optional[Callable] = None,
                            return_info: bool = False):
    """(mean, cov) at ``x_test`` from a prebuilt state (sharded or single
    device: the same tuple).  ``mean_only``: one sharded cross contraction,
    Σ over the ranks of their rows' K_*xᵀα (no solve).  Otherwise
    ``ops/lazy_cg.lazy_posterior_query`` over the row-sharded operator: its
    variance mBCG with N* right-hand sides and the state's factor, and its
    conventions where the port departs from the JAX package (F1: a
    breakdown makes mean and cov NaN; F2: under ``mean_only``
    ``info["broke"]`` is the α solve's, a NaN α).  ``info`` as there."""
    kernel, x, alpha, _, _, alpha_relres = state[:6]
    _check_divisible(x.shape[0], mesh)
    cross = cross_fn or default_cross
    if not mean_only:
        return lazy_posterior_query(state, x_test, block=x.shape[0], max_iters=max_iters, tol=tol,
                                    precond_shift=precond_shift, cross_fn=cross,
                                    matvec_builder=sharded_operator(mesh, cross, local_matvec_builder),
                                    return_info=return_info)
    mean = psum(cross(kernel, mesh.rows(x), x_test).mT @ mesh.rows(alpha), mesh)
    if return_info:
        info = {"relres": torch.zeros((0,), dtype=mean.dtype, device=mean.device),
                "relres_max": torch.as_tensor(alpha_relres, dtype=mean.dtype, device=mean.device),
                "broke": torch.any(torch.isnan(alpha)), "iters": 0}
        return mean, None, info
    return mean, None
