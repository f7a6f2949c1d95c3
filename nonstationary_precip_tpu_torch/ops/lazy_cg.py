"""Matrix-free ("lazy") BBMM on one device: the exact-GP marginal
log-likelihood and its gradients with the N×N Gram never in memory.

Counterpart of ``nonstationary_precip_tpu/ops/lazy_cg.py``, the part the
large-N paths run (``experiments/gibbs_largen.py`` with a tensor kernel,
``experiments/exact_largen.py`` with a module kernel):
  * the mBCG matvec rebuilds (block, N) row panels of K + σ²I from x, or
    goes through a fused ``matvec_builder`` (K2, ``ops/matvec.py``);
  * ``lazy_cg_mll`` is one ``torch.autograd.Function`` whose backward never
    forms the (N, N) cotangent: dMLL/dK = ½ααᵀ − ½·mean_i (K⁻¹zᵢ)rᵢᵀ is
    rank-(1+R), pulled back either panel by panel through ``cross_fn``
    (``make_jnp_panel_vjp``) or by a fused ``panel_vjp`` (K3);
  * σ² rides the panel diagonal, so its gradient falls out of the same
    trace identity.

``lazy_cg_posterior`` is the matrix-free posterior: one mBCG solve with
1 + N* right-hand sides, no probes.  ``lazy_posterior_state`` hoists its
query-independent half (α = K⁻¹r and the preconditioner factor) once per
fit, and ``lazy_posterior_query`` serves a batch from it.  ``lazy_cg_quad``
and ``lazy_slq_logdet`` are the frozen-operator primitives of the
matrix-free prior: a quadratic form whose gradient goes to its vector
only, and a constant SLQ logdet.

Every preconditioned path takes ``precond_shift``: P = LLᵀ + c·I with
c = shift·σ², the JAX package's Woodbury ridge (shift > 1 buys f32
stability at large N; the estimators are P-generic).  The factor L is the
greedy pivoted Cholesky, RPCholesky's sampled pivots (``key``: the Gumbel
draws) or the Nyström factor of ``rank`` landmarks (``lazy_nystrom_factor``).

Every solve takes ``stop_every``: mBCG then reads its done flags every
``stop_every`` iterations and stops once every column has converged
(``bbmm.mbcg``), with the full run's result.  ``make_chunked_mll``,
``make_chunked_solve``, ``lazy_posterior_state_chunked`` and
``lazy_posterior_query_chunked`` are the JAX package's host-chunked entries
(there, to keep each device program under its TPU's execution wall): here
they call the paths above with a budget of ``chunk_iters``·``n_chunks``
iterations, stopped every ``chunk_iters``.

Kernels whose state is per point (the Gibbs lengthscale field) use the
packed payload ``x_aug = [x, log ℓ]`` with a ``cross_fn`` that unpacks it
(``kernels.gibbs.packed_gibbs_cross``).  Randomness comes from the caller:
``probe_noise`` is (u1 (rank, R), u2 (N, R)) standard normal draws with a
preconditioner, else the (N, R) probes themselves; a ``precond_key`` is
RPCholesky's (rank, N) Gumbel draws or the Nyström landmarks' indices, or a
``torch.Generator`` they are drawn from.
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch import nn

from nonstationary_precip_tpu_torch.ops.bbmm import (
    lanczos_logdet,
    mbcg,
    precond_logdet,
    sample_precond_probes,
    woodbury_precond,
)


def default_cross(kernel, xa, xb):
    return kernel(xa, xb)


def check_divisible(n: int, m: int, what: str, unit: str):
    if n % m:
        raise ValueError(
            f"{what} length {n} is not divisible by the {unit} {m} — pad the data "
            "(padding Gram rows is NOT neutral: fake train points change the solve)")


def _panel(kernel, x_blk, x, sigma2, i0, cross_fn):
    """Rows [i0, i0+B) of K + σ²I, the only piece of the Gram that exists."""
    kb = cross_fn(kernel, x_blk, x)
    idx = i0 + torch.arange(x_blk.shape[0], device=x.device)
    mask = (torch.arange(x.shape[0], device=x.device)[None, :] == idx[:, None]).to(kb.dtype)
    return kb + sigma2 * mask


def _lazy_matvec(kernel, x, sigma2, block, cross_fn):
    """(N, R) → (N, R) multiply by K + σ²I, one (block, N) panel at a time."""
    n = x.shape[0]

    def matvec(v):
        return torch.cat([_panel(kernel, x[i0:i0 + block], x, sigma2, i0, cross_fn) @ v
                          for i0 in range(0, n, block)])

    return matvec


def _operator(kernel, x, sigma2, block, cross_fn, matvec_builder):
    """The (N, R) → (N, R) multiply by K + σ²I: ``matvec_builder``'s fused
    one (K2) if given, else lazy row panels through ``cross_fn``."""
    if matvec_builder is not None:
        return matvec_builder(kernel, x, sigma2)
    return _lazy_matvec(kernel, x, sigma2, block, cross_fn)


def _gumbel_rows(key, rank: int, n: int, x: torch.Tensor) -> torch.Tensor:
    """RPCholesky's (rank, N) Gumbel draws on x's device: ``key`` itself (an
    array of them, e.g. JAX's ``gumbel(fold_in(key, j), (N,))`` row j), or
    drawn from ``key``, a ``torch.Generator``, as −log(−log u) with u
    uniform on [tiny, 1), JAX's ``gumbel``."""
    if isinstance(key, torch.Generator):
        u = torch.rand((rank, n), generator=key, dtype=x.dtype, device=key.device)
        g = -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(x.dtype).tiny)))
    else:
        g = torch.as_tensor(key, dtype=x.dtype)
    if g.shape != (rank, n):
        raise ValueError(f"RPCholesky draws must be (rank, N) = ({rank}, {n}), got {tuple(g.shape)}")
    return g.to(x.device)


@torch.no_grad()
def lazy_pivoted_cholesky(kernel, x: torch.Tensor, rank: int, cross_fn: Callable = default_cross,
                          jitter: float = 1e-8, key=None) -> torch.Tensor:
    """Rank-``rank`` pivoted Cholesky (N, rank) of the noise-free
    K(x, x) without forming it: the diagonal from single-point evaluations,
    each pivot row from one (1, N) cross-Gram build.  The pivot stays on
    the device (argmax and index_select, no host read per pivot).  Same
    recursion as ``ops/bbmm.pivoted_cholesky``.

    ``key=None``: the greedy pivot, argmax of the residual diagonal.  Else
    RPCholesky (Chen, Epperly, Tropp & Webber 2022): pivot j is sampled with
    probability ∝ the residual diagonal, as argmax(gⱼ + log d) with gⱼ the
    j-th row of Gumbel draws (``_gumbel_rows``: ``key`` is the (rank, N)
    draws or a ``torch.Generator`` they come from).  This is JAX's
    ``categorical(fold_in(key, j), log d)``, so JAX's draws give JAX's
    pivots; an exhausted pivot has d = 0, log d = −inf, probability 0."""
    n = x.shape[0]
    gumbel = None if key is None else _gumbel_rows(key, rank, n, x)
    d = torch.vmap(lambda xi: cross_fn(kernel, xi[None], xi[None])[0, 0])(x)
    l = torch.zeros((n, rank), dtype=x.dtype, device=x.device)
    for j in range(rank):
        score = d if gumbel is None else gumbel[j] + torch.log(d)
        piv = torch.argmax(score).reshape(1)
        dmax = d.index_select(0, piv)
        krow = cross_fn(kernel, x.index_select(0, piv), x)[0]
        resid = krow - l @ l.index_select(0, piv)[0]
        col = resid / torch.sqrt(torch.clamp_min(dmax, jitter))
        col = torch.where(d > 0.0, col, torch.zeros_like(col))
        l[:, j] = col
        d = torch.clamp_min(d - col * col, 0.0).index_fill(0, piv, 0.0)
    return l


def _warn_dead_rank(lam: torch.Tensor, cutoff, rank: int) -> int:
    """The capacity guard of the JAX package (DESIGN §30): when the landmark
    Gram keeps fewer than rank/8 eigendirections above the cutoff, the other
    columns add no preconditioning and widen the f32 Woodbury inner problem,
    so warn, eagerly (one host read; the port has no traced mode in which
    JAX's check skips).  Returns the count kept."""
    k = int(torch.sum(lam > cutoff))
    if k < rank // 8:
        warnings.warn(
            f"lazy_nystrom_factor: only {k}/{rank} landmark-Gram eigendirections sit above the cutoff "
            f"{float(cutoff):.2e} — the remaining columns add no preconditioning capacity and erode the f32 "
            f"Woodbury stability margin at scale.  Prefer rank ≈ {max(2 * k, 64)}, or raise ridge/precond_shift "
            "(DESIGN.md §30).",
            stacklevel=3,
        )
    return k


def canonical_eigh(w: torch.Tensor):
    """``torch.linalg.eigh`` with each eigenvector's sign fixed: its entry
    of largest magnitude (the first of equals) made positive.  LAPACK and
    cuSOLVER return either sign, and a Nyström column's sign meets the
    caller's probe draws (z = L u₁ + √c u₂), so without this the CPU and
    the card would draw different probes from the same u₁.  P = LLᵀ + cI
    does not depend on it."""
    lam, v = torch.linalg.eigh(w)
    lead = v.gather(0, torch.argmax(v.abs(), dim=0, keepdim=True))
    return lam, v * torch.where(lead < 0, -1.0, 1.0).to(v.dtype)


def nystrom_landmarks(n: int, rank: int, key=None, device=None) -> torch.Tensor:
    """The Nyström landmarks' row indices (rank,): JAX's stride
    (arange(rank)·(n // rank)) mod n without a key; else ``key`` itself (an
    index vector, e.g. JAX's ``permutation(key, n)[:rank]``) or the first
    ``rank`` of a ``torch.Generator``'s permutation."""
    if key is None:
        return (torch.arange(rank, device=device) * (n // rank)) % n
    if isinstance(key, torch.Generator):
        return torch.randperm(n, generator=key, device=key.device)[:rank].to(device)
    idx = torch.as_tensor(key, dtype=torch.int64, device=device)
    if idx.shape != (rank,):
        raise ValueError(f"Nyström landmarks must be ({rank},) indices, got {tuple(idx.shape)}")
    return idx


@torch.no_grad()
def lazy_nystrom_factor(kernel, x: torch.Tensor, rank: int, cross_fn: Callable = default_cross, key=None,
                        block: int = 4096, ridge: float = 1e-5) -> torch.Tensor:
    """Rank-``rank`` Nyström factor (N, rank) of the noise-free K(x, x):
    L = K(x, m) V Λ^(−½) from the landmark Gram K(m, m) = VΛVᵀ
    (:func:`canonical_eigh`, outside any kernel, as JAX's ``eigh``), with the
    directions whose eigenvalue is at most ``ridge``·λmax zeroed (a zero
    column of L, not amplified noise): LLᵀ = K(x, m) W⁺ K(m, x) on the kept
    subspace, PSD and ≼ K.  The (N, rank) cross panels, ``block`` rows at a
    time, go through ``cross_fn`` (the plain Gram, never K9).  The same
    contract as :func:`lazy_pivoted_cholesky`.  Landmarks:
    :func:`nystrom_landmarks`.  Warns when fewer than rank/8 directions are
    kept (:func:`_warn_dead_rank`)."""
    n = x.shape[0]
    rank = min(rank, n)
    x_lm = x.index_select(0, nystrom_landmarks(n, rank, key, x.device))
    lam, v = canonical_eigh(cross_fn(kernel, x_lm, x_lm))  # ascending
    cutoff = ridge * lam[-1]
    _warn_dead_rank(lam, cutoff, rank)
    inv_sqrt = torch.where(lam > cutoff, 1.0 / torch.sqrt(torch.maximum(lam, cutoff)), torch.zeros_like(lam))
    proj = v * inv_sqrt[None, :]
    return torch.cat([cross_fn(kernel, x[i:i + block], x_lm) @ proj for i in range(0, n, block)])


def build_precond_factor(precond, kernel, x, rank, cross, key=None):
    """The (N, rank) preconditioner factor: ``'pivchol'`` (greedy pivots, or
    RPCholesky's with ``key``) or ``'nystrom'`` (stride landmarks, or the
    keyed ones).  Public so that a caller can hoist the build
    (``lazy_cg_mll(precond_lpc=...)``)."""
    if precond == "pivchol":
        return lazy_pivoted_cholesky(kernel, x, rank, cross, key=key)
    if precond == "nystrom":
        return lazy_nystrom_factor(kernel, x, rank, cross, key=key)
    raise ValueError(f"precond must be 'pivchol' or 'nystrom', got {precond!r}")


# ---------------------------------------------------------------------------
# MLL (differentiable w.r.t. the kernel, x, resid, sigma2)
# ---------------------------------------------------------------------------


class _Settings(NamedTuple):
    block: int
    max_iters: int
    tol: float
    precond_rank: int
    cross_fn: Callable
    matvec_builder: Optional[Callable]
    panel_vjp: Optional[Callable]
    precond_shift: float
    stop_every: int


def _core_fwd(s: _Settings, kernel, x, resid, probes, sigma2, lpc):
    """The JAX package's ``core_fwd`` (:325-366): value, the vectors the
    backward needs (α = K⁻¹r, the probe solves, the trace's right vectors)
    and the mBCG result."""
    n = resid.shape[0]
    matvec = _operator(kernel, x, sigma2, s.block, s.cross_fn, s.matvec_builder)
    if s.precond_rank > 0:
        # the preconditioner parameterises the estimator, not the estimand:
        # σ² is frozen in it; z ~ N(0, P) and P⁻¹z keep E[z (P⁻¹z)ᵀ] = I
        # (JAX's ``_woodbury`` is ``woodbury_precond``); its ridge is
        # c = precond_shift·σ²
        c = s.precond_shift * sigma2.detach()
        minv = woodbury_precond(lpc, c)
        probe_rights = minv(probes)
        probe_w = torch.sum(probes * probe_rights, dim=0)
        logdet_p = precond_logdet(lpc, c, n)
    else:
        minv = None
        probe_rights = probes  # E[z zᵀ] = I for Rademacher probes
        probe_w = torch.sum(probes * probes, dim=0)
        logdet_p = torch.zeros((), dtype=resid.dtype, device=resid.device)
    res = mbcg(matvec, torch.cat([resid[:, None], probes], dim=1), max_iters=s.max_iters, tol=s.tol,
               precond=minv, stop_every=s.stop_every)
    alpha, solves = res.x[:, 0], res.x[:, 1:]
    logdet = logdet_p + lanczos_logdet(res.alphas[:, 1:], res.betas[:, 1:], probe_w)
    two_pi = torch.tensor(2.0 * math.pi, dtype=resid.dtype, device=resid.device)
    val = -0.5 * torch.dot(resid, alpha) - 0.5 * logdet - 0.5 * n * torch.log(two_pi)
    val = torch.where(torch.any(res.broke), torch.full_like(val, math.nan), val)
    return val, (alpha, solves, probe_rights), res


def kernel_params(kernel) -> tuple:
    """The tensors a module kernel's gradient is taken for: its parameters,
    in ``kernel.parameters()`` order.  Empty for a tensor or None kernel,
    whose gradient is the kernel's own."""
    return tuple(kernel.parameters()) if isinstance(kernel, nn.Module) else ()


class _LazyCGMLL(torch.autograd.Function):
    """``core`` of the JAX package's ``_mll_machinery``: forward ``core_fwd``,
    backward the fused ``panel_vjp`` or the panel-by-panel pullback.

    A module kernel's parameters ride as the trailing inputs ``kparams``, so
    autograd routes their gradients (the JAX package differentiates the
    kernel pytree itself); a tensor kernel gets its gradient directly.
    ``info``, a dict or None, receives the run's evidence."""

    @staticmethod
    def forward(ctx, kernel, x, resid, probes, sigma2, lpc, settings, info, *kparams):
        val, (alpha, solves, rights), res = _core_fwd(settings, kernel, x, resid, probes, sigma2, lpc)
        if info is not None:
            info.update(relres=res.residnorm, iters=res.ran)
        ctx.settings = settings
        ctx.kernel = kernel
        ctx.num_kparams = len(kparams)
        ctx.save_for_backward(x, sigma2, alpha, solves, rights)
        return val

    @staticmethod
    def backward(ctx, g):
        x, sigma2, alpha, solves, rights = ctx.saved_tensors
        s = ctx.settings
        pvjp = s.panel_vjp if s.panel_vjp is not None else make_jnp_panel_vjp(s.cross_fn, s.block)
        kg, xgrad, s2g = pvjp(ctx.kernel, x, sigma2, alpha, solves, rights, g)
        if isinstance(ctx.kernel, torch.Tensor):
            kernel_grad, param_grads = kg, (None,) * ctx.num_kparams
        else:
            kernel_grad = None
            param_grads = tuple(kg) if ctx.num_kparams else ()
        return (kernel_grad, xgrad, -g * alpha, None, s2g, None, None, None, *param_grads)


def lazy_cg_mll(kernel, x: torch.Tensor, resid: torch.Tensor, probe_noise, sigma2, *,
                block: int = 1024, max_iters: int = 100, tol: float = 1e-6, precond_rank: int = 0,
                precond_key=None, precond: str = "pivchol", precond_shift: float = 1.0,
                precond_lpc: Optional[torch.Tensor] = None, cross_fn: Optional[Callable] = None,
                matvec_builder: Optional[Callable] = None, panel_vjp: Optional[Callable] = None,
                stop_every: int = 0, info: Optional[dict] = None) -> torch.Tensor:
    """−½ rᵀK⁻¹r − ½ log det K − (n/2) log 2π with K = kernel(x) + σ²I, K
    never in memory.  Differentiable w.r.t. ``kernel`` (a tensor, such as
    the raw outputscale of ``packed_gibbs_cross``, or an ``nn.Module``,
    whose parameters then get their gradients), ``x``, ``resid`` and
    ``sigma2``.

    ``probe_noise``: with a preconditioner (``precond_rank > 0`` or
    ``precond_lpc``), the standard normal draws (u1 (rank, R), u2 (N, R))
    from which the probes z = L u₁ + √c u₂ ~ N(0, P) are made,
    P = LLᵀ + c·I, c = ``precond_shift``·σ²; without one, the (N, R)
    Rademacher probes themselves.  The preconditioner factor (built by
    greedy pivoted Cholesky unless ``precond_lpc`` is given), the probes
    and σ² inside P carry no gradient.

    ``matvec_builder`` swaps the mBCG matvec for a fused one (K2);
    ``panel_vjp`` swaps the backward panel loop for a fused sweep (K3) with
    the contract ``(kernel, x, sigma2, alpha, solves, rights, g) ->
    (kernel_grad, x_grad, sigma2_grad)``; for a module kernel,
    ``kernel_grad`` is a tuple aligned with ``kernel.parameters()``.  Both must compute the operator
    of ``cross_fn``.  ``block`` must divide N (it is clamped to N first).
    ``stop_every``: mBCG's early stop (``bbmm.mbcg``).  ``info``, a dict,
    receives the evidence: ``relres`` the (1 + R,) final relative
    residuals, ``iters`` the mBCG iterations run."""
    n = x.shape[0]
    block = min(block, n)
    check_divisible(n, block, "x", "row-panel block")
    cross = cross_fn or default_cross
    sigma2 = torch.as_tensor(sigma2, dtype=x.dtype, device=x.device)
    if precond_lpc is not None:
        precond_rank = precond_lpc.shape[-1]
    with torch.no_grad():
        if precond_rank > 0:
            lpc = (precond_lpc if precond_lpc is not None
                   else build_precond_factor(precond, kernel, x, precond_rank, cross, precond_key)).detach()
            u1, u2 = probe_noise
            probes = sample_precond_probes(lpc, precond_shift * sigma2.detach(), u1, u2)
        else:
            lpc = torch.zeros((n, 0), dtype=x.dtype, device=x.device)
            probes = probe_noise.detach()
    settings = _Settings(block, max_iters, tol, precond_rank, cross, matvec_builder, panel_vjp,
                         float(precond_shift), stop_every)
    return _LazyCGMLL.apply(kernel, x, resid, probes, sigma2, lpc, settings, info, *kernel_params(kernel))


@functools.lru_cache(maxsize=16)
def make_jnp_panel_vjp(cross_fn: Callable, block: int):
    """The MLL backward as a panel loop with autograd, with the contract of
    ``ops/matvec.packed_gibbs_panel_vjp`` (the sweep K3 replaces):

        panel_vjp(kernel, x, sigma2, alpha, solves, rights, g)
            -> (kernel_grad, x_grad, sigma2_grad)

    ``kernel_grad`` is the gradient of a tensor kernel, a tuple aligned with
    ``kernel.parameters()`` for a module kernel (None for a frozen
    parameter), and None for a None kernel.

    Each (block, N) panel's cotangent rows of ½ααᵀ − (¼/R)(SZᵀ + ZSᵀ) are
    pulled back through ``_panel``.  x enters every panel twice, as the
    panel's rows and as the full column side; the two cotangents are summed."""

    def panel_vjp(kernel, x, sigma2, alpha, solves, rights, g):
        n = x.shape[0]
        blk = min(block, n)
        check_divisible(n, blk, "x", "row-panel block")
        kg, rows, cols, s2g = panel_pullback(cross_fn, kernel, x, sigma2, alpha, solves, rights, g, 0, n, blk)
        return kg, rows + cols, s2g

    return panel_vjp


def panel_pullback(cross_fn: Callable, kernel, x, sigma2, alpha, solves, rights, g, i0: int, nrows: int,
                   blk: int):
    """The MLL cotangent of rows [i0, i0 + nrows) of K + σ²I, pulled back
    through ``_panel`` ``blk`` rows at a time: (kernel_grad, the rows' own x
    gradient (nrows, D), the column side's x gradient (N, D), σ²'s
    gradient), ``kernel_grad`` as :func:`make_jnp_panel_vjp`'s.  Over all N
    rows the x gradient is the sum of the two; the row-sharded backward
    (``parallel/sharded_cg.py``) takes one rank's rows."""
    r = rights.shape[-1]
    tensor_kernel = isinstance(kernel, torch.Tensor)
    kern = kernel.detach().requires_grad_() if tensor_kernel else kernel
    params = kernel_params(kernel)
    kleaves = (kern,) if tensor_kernel else tuple(p for p in params if p.requires_grad)
    xf = x.detach().requires_grad_()
    s2 = sigma2.detach().requires_grad_()
    leaves = kleaves + (xf, s2)
    acc = [torch.zeros_like(t) for t in leaves]
    rows = []
    for b0 in range(i0, i0 + nrows, blk):
        sl = slice(b0, b0 + blk)
        kbar = 0.5 * torch.outer(alpha[sl], alpha) - (0.25 / r) * (solves[sl] @ rights.T + rights[sl] @ solves.T)
        xb = x[sl].detach().requires_grad_()
        with torch.enable_grad():
            panel = _panel(kern, xb, xf, s2, b0, cross_fn)
            grads = torch.autograd.grad(panel, (xb, *leaves), grad_outputs=g * kbar, allow_unused=True)
        grads = [torch.zeros_like(t) if gr is None else gr for t, gr in zip((xb, *leaves), grads)]
        rows.append(grads[0])
        acc = [a + gr for a, gr in zip(acc, grads[1:])]
    if tensor_kernel:
        kg = acc[0]
    elif params:
        live = iter(acc[:len(kleaves)])
        kg = tuple(next(live) if p.requires_grad else None for p in params)
    else:
        kg = None
    return kg, torch.cat(rows), acc[-2], acc[-1]


# ---------------------------------------------------------------------------
# convergence diagnostics (gate evidence, not an estimator)
# ---------------------------------------------------------------------------


@torch.no_grad()
def lazy_cg_diagnostics(kernel, x: torch.Tensor, resid: torch.Tensor, probe_noise, sigma2, *,
                        block: int = 1024, max_iters: int = 100, tol: float = 1e-6, precond_rank: int = 0,
                        precond_key=None, precond: str = "pivchol", precond_shift: float = 1.0,
                        precond_lpc: Optional[torch.Tensor] = None, cross_fn: Optional[Callable] = None,
                        matvec_builder: Optional[Callable] = None) -> dict:
    """Convergence evidence for the solves :func:`lazy_cg_mll` runs: the same
    matvec, preconditioner, probes and mBCG budget, returning
    {"relres_solve", "relres_max", "iters_max", "broke"}: relres_solve is
    the K⁻¹y solve's final relative residual, relres_max the worst column."""
    n = x.shape[0]
    block = min(block, n)
    check_divisible(n, block, "x", "row-panel block")
    cross = cross_fn or default_cross
    sigma2 = torch.as_tensor(sigma2, dtype=x.dtype, device=x.device)
    if precond_lpc is not None:
        precond_rank = precond_lpc.shape[-1]
    matvec = _operator(kernel, x, sigma2, block, cross, matvec_builder)
    if precond_rank > 0:
        lpc = (precond_lpc if precond_lpc is not None
               else build_precond_factor(precond, kernel, x, precond_rank, cross, precond_key))
        u1, u2 = probe_noise
        c = precond_shift * sigma2
        probes = sample_precond_probes(lpc, c, u1, u2)
        minv = woodbury_precond(lpc, c)
    else:
        probes, minv = probe_noise, None
    res = mbcg(matvec, torch.cat([resid[:, None], probes], dim=1), max_iters=max_iters, tol=tol, precond=minv)
    return {
        "relres_solve": float(res.residnorm[0]),
        "relres_max": float(torch.max(res.residnorm)),
        "iters_max": int(torch.max(res.iters)),
        "broke": bool(torch.any(res.broke)),
    }


# ---------------------------------------------------------------------------
# posterior (prediction: deterministic, no probes)
# ---------------------------------------------------------------------------


def lazy_cg_posterior(kernel, x: torch.Tensor, resid: torch.Tensor, x_test: torch.Tensor, sigma2, *,
                      block: int = 1024, max_iters: int = 1000, tol: float = 1e-6, precond_rank: int = 0,
                      precond_key=None, precond: str = "pivchol", precond_shift: float = 1.0,
                      cross_fn: Optional[Callable] = None, matvec_builder: Optional[Callable] = None):
    """(mean, cov) of the zero-mean exact-GP posterior at ``x_test``:
    mean = K*ₓK⁻¹r, cov = K** − K*ₓK⁻¹Kₓ*, the train-side solves by one
    mBCG run over lazy row panels (or ``matvec_builder``'s fused matvec)
    with all 1 + N* right-hand sides at once.  A breakdown poisons mean and
    cov with NaN.  The caller adds its mean function and observation noise.
    The preconditioner is the rank-``precond_rank`` pivoted Cholesky with
    ridge ``precond_shift``·σ², and with it σ² carries no gradient (as in the
    JAX package's ``_posterior_machinery``, :1309-1331).  Not differentiable
    through a fused matvec, which has no backward."""
    n = x.shape[0]
    block = min(block, n)
    check_divisible(n, block, "x", "row-panel block")
    cross = cross_fn or default_cross
    sigma2 = torch.as_tensor(sigma2, dtype=x.dtype, device=x.device)
    if precond_rank > 0:
        lpc = build_precond_factor(precond, kernel, x, precond_rank, cross, precond_key)
        sigma2 = sigma2.detach()
        minv = woodbury_precond(lpc, precond_shift * sigma2)
    else:
        minv = None
    matvec = _operator(kernel, x, sigma2, block, cross, matvec_builder)
    b_cols = cross(kernel, x, x_test)  # (N, N*)
    res = mbcg(matvec, torch.cat([resid[:, None], b_cols], dim=1), max_iters=max_iters, tol=tol, precond=minv)
    mean = b_cols.T @ res.x[:, 0]
    cov_term = b_cols.T @ res.x[:, 1:]
    cov = cross(kernel, x_test, x_test) - 0.5 * (cov_term + cov_term.T)
    bad = torch.any(res.broke)
    return (torch.where(bad, torch.full_like(mean, math.nan), mean),
            torch.where(bad, torch.full_like(cov, math.nan), cov))


# ---------------------------------------------------------------------------
# frozen-operator primitives: quadratic form and SLQ logdet
# ---------------------------------------------------------------------------


class _LazyCGQuad(torch.autograd.Function):
    """diffᵀ(K + σ²I)⁻¹diff with the pullback 2·g·(K + σ²I)⁻¹diff to
    ``diff`` only (the JAX package's ``_quad_machinery``): the operator is
    frozen by contract."""

    @staticmethod
    def forward(ctx, diff, matvec, minv, max_iters, tol, stop_every, info):
        res = mbcg(matvec, diff[:, None], max_iters=max_iters, tol=tol, precond=minv, stop_every=stop_every)
        if info is not None:
            info.update(relres=res.residnorm[0], iters=res.ran)
        alpha = res.x[:, 0]
        q = torch.dot(diff, alpha)
        q = torch.where(torch.any(res.broke), torch.full_like(q, math.nan), q)
        ctx.save_for_backward(alpha)
        return q

    @staticmethod
    def backward(ctx, g):
        (alpha,) = ctx.saved_tensors
        return 2.0 * g * alpha, None, None, None, None, None, None


def lazy_cg_quad(kernel, x: torch.Tensor, diff: torch.Tensor, sigma2, *, lpc: Optional[torch.Tensor] = None,
                 block: int = 1024, max_iters: int = 64, tol: float = 1e-6, precond_shift: float = 1.0,
                 cross_fn: Optional[Callable] = None, matvec_builder: Optional[Callable] = None,
                 stop_every: int = 0, info: Optional[dict] = None) -> torch.Tensor:
    """diffᵀ(K(x, x) + σ²I)⁻¹diff by one mBCG solve over lazy row panels.

    Differentiable in ``diff`` only, with the pullback 2·(K + σ²I)⁻¹diff,
    exact when CG has converged; ``kernel``, ``x``, σ² and ``lpc`` are
    frozen (the per-step prior quadratic of MAP training under a frozen
    prior).  A breakdown gives NaN.  ``lpc``: a hoisted (N, rank)
    pivoted-Cholesky factor of the noise-free K, the Woodbury
    preconditioner with ridge ``precond_shift``·σ²; without it the prior's
    1e-4 jitter makes plain CG stall at large N.  ``matvec_builder``,
    ``stop_every`` and ``info`` as :func:`lazy_cg_mll`'s (``relres`` the
    solve's; the prior passes K12's builder, ``ops/matvec``)."""
    n = x.shape[0]
    block = min(block, n)
    check_divisible(n, block, "x", "row-panel block")
    cross = cross_fn or default_cross
    x = x.detach()
    sigma2 = torch.as_tensor(sigma2, dtype=x.dtype, device=x.device).detach()
    kern = kernel.detach() if isinstance(kernel, torch.Tensor) else kernel
    minv = None if lpc is None else woodbury_precond(lpc.detach(), precond_shift * sigma2)
    matvec = _operator(kern, x, sigma2, block, cross, matvec_builder)
    return _LazyCGQuad.apply(diff, matvec, minv, max_iters, tol, stop_every, info)


@torch.no_grad()
def lazy_slq_logdet(kernel, x: torch.Tensor, probe_noise, sigma2, *, lpc: Optional[torch.Tensor] = None,
                    block: int = 1024, max_iters: int = 128, tol: float = 1e-10, precond_shift: float = 1.0,
                    cross_fn: Optional[Callable] = None, matvec_builder: Optional[Callable] = None,
                    stop_every: int = 0, info: Optional[dict] = None) -> torch.Tensor:
    """SLQ estimate of log det(K(x, x) + σ²I), matrix-free: the estimator
    ``lazy_cg_mll`` embeds, standalone for a frozen operator, whose logdet
    is a constant of training.  Not differentiable.

    ``probe_noise``: with ``lpc`` (P = LLᵀ + c·I, c = ``precond_shift``·σ²),
    the standard normal draws (u1 (rank, R), u2 (N, R)) of the N(0, P)
    probes (``bbmm.sample_precond_probes``); without it, the (N, R)
    Rademacher probes.  The JAX package draws either from a key.
    ``matvec_builder`` and ``stop_every`` as :func:`lazy_cg_mll`'s (a
    stopped run's estimate is the full run's, bit for bit: ``bbmm.mbcg``
    pads the coefficients as the full run masks them); ``info``, a dict, receives
    ``relres`` the (R,) probes' final relative residuals, ``converged`` the
    iterations each ran before it converged (its whole budget if it did
    not) and ``iters`` the mBCG iterations run."""
    n = x.shape[0]
    block = min(block, n)
    check_divisible(n, block, "x", "row-panel block")
    cross = cross_fn or default_cross
    sigma2 = torch.as_tensor(sigma2, dtype=x.dtype, device=x.device)
    matvec = _operator(kernel, x, sigma2, block, cross, matvec_builder)
    if lpc is not None:
        c = precond_shift * sigma2
        minv = woodbury_precond(lpc, c)
        u1, u2 = probe_noise
        probes = sample_precond_probes(lpc, c, u1, u2)
        probe_w = torch.sum(probes * minv(probes), dim=0)
        base = precond_logdet(lpc, c, n)
    else:
        minv = None
        probes = probe_noise
        probe_w = torch.sum(probes * probes, dim=0)
        base = torch.zeros((), dtype=x.dtype, device=x.device)
    res = mbcg(matvec, probes, max_iters=max_iters, tol=tol, precond=minv, stop_every=stop_every)
    if info is not None:
        info.update(relres=res.residnorm, converged=res.iters, iters=res.ran)
    est = base + lanczos_logdet(res.alphas, res.betas, probe_w)
    return torch.where(torch.any(res.broke), torch.full_like(est, math.nan), est)


# ---------------------------------------------------------------------------
# amortized posterior: fit-time state, cheap per-query-batch serving
# ---------------------------------------------------------------------------


class LazyPosteriorState(NamedTuple):
    """Once-per-fit state for repeated matrix-free posterior queries (the
    JAX package's ``LazyPosteriorState``): α = (K + σ²I)⁻¹r, after which a
    posterior mean is one cross build and one contraction; the (N, rank)
    preconditioner factor the variance solves reuse; the operator (kernel,
    payload, σ²); and the relative residual of the α solve, the evidence
    that it converged (mBCG freezes silently when it does not)."""

    kernel: Any
    x: torch.Tensor  # (N, d) payload the cross_fn understands
    alpha: torch.Tensor  # (N,) (K + σ²I)⁻¹ resid
    lpc: torch.Tensor  # (N, rank) preconditioner factor ((N, 0) if none)
    sigma2: torch.Tensor  # scalar ridge
    alpha_relres: torch.Tensor
    iters: int = 0  # mBCG iterations the α solve ran (its whole budget unless stopped early)


def _auto_budget(n: int) -> int:
    """The converged-iteration budget of the JAX package's matrix-free
    paths (rank-150 preconditioning): 16 iterations for N ≤ 32768, 32 above."""
    return 16 if n <= 32768 else 32


@torch.no_grad()
def lazy_posterior_state(kernel, x: torch.Tensor, resid: torch.Tensor, sigma2, *, block: int = 1024,
                         max_iters: Optional[int] = None, tol: float = 1e-8, precond_rank: int = 150,
                         precond: str = "pivchol", precond_key=None, precond_shift: float = 1.0,
                         precond_lpc: Optional[torch.Tensor] = None, cross_fn: Optional[Callable] = None,
                         matvec_builder: Optional[Callable] = None, stop_every: int = 0) -> LazyPosteriorState:
    """The :class:`LazyPosteriorState` of a fit: one factor build (unless
    ``precond_lpc`` is given) and one single-RHS mBCG solve for α, at twice
    the auto budget unless ``max_iters`` is given (``stop_every``: its early
    stop).  A breakdown makes α NaN.  Frozen serving state: nothing here
    carries a gradient."""
    n = x.shape[0]
    block = min(block, n)
    check_divisible(n, block, "x", "row-panel block")
    cross = cross_fn or default_cross
    if max_iters is None:
        max_iters = 2 * _auto_budget(n)
    precond_rank = min(precond_rank, n)
    kernel = kernel.detach() if isinstance(kernel, torch.Tensor) else kernel
    x = x.detach()
    sigma2 = torch.as_tensor(sigma2, dtype=x.dtype, device=x.device).detach()
    if precond_rank > 0:
        lpc = (precond_lpc if precond_lpc is not None
               else build_precond_factor(precond, kernel, x, precond_rank, cross, precond_key)).detach()
        minv = woodbury_precond(lpc, precond_shift * sigma2)
    else:
        lpc = torch.zeros((n, 0), dtype=x.dtype, device=x.device)
        minv = None
    matvec = _operator(kernel, x, sigma2, block, cross, matvec_builder)
    res = mbcg(matvec, resid.detach()[:, None], max_iters=max_iters, tol=tol, precond=minv, stop_every=stop_every)
    alpha = torch.where(torch.any(res.broke), torch.full_like(res.x[:, 0], math.nan), res.x[:, 0])
    return LazyPosteriorState(kernel, x, alpha, lpc, sigma2, res.residnorm[0], res.ran)


@torch.no_grad()
def lazy_posterior_query(state: LazyPosteriorState, x_test: torch.Tensor, *, mean_only: bool = False,
                         block: int = 1024, max_iters: Optional[int] = None, tol: float = 1e-6,
                         precond_shift: float = 1.0, cross_fn: Optional[Callable] = None,
                         matvec_builder: Optional[Callable] = None, return_info: bool = False,
                         stop_every: int = 0):
    """(mean, cov) at ``x_test`` from a prebuilt state.

    mean = Kₓ*ᵀα: one (N, N*) cross build and one contraction, no solve
    (``mean_only=True`` returns ``(mean, None)``).  cov needs K⁻¹Kₓ*: one
    preconditioned mBCG with N* right-hand sides at the auto budget, with
    the state's factor (``stop_every``: its early stop).  A breakdown of
    that solve turns both mean and cov to NaN, as the JAX package's
    ``lazy_posterior_query`` does (its chunked form NaNs only cov; the
    port's chunked form is this one, F1).

    ``return_info=True`` appends {"relres": (N*,) final relative residuals of
    the variance solves (empty when ``mean_only``), "relres_max": the worst
    of them and of the state's α solve, "broke": the variance solve's
    breakdown flag, and under ``mean_only`` the α solve's (the state's NaN
    α; F2), "iters": the mBCG iterations the variance solve ran}."""
    kernel, x, alpha, lpc, sigma2, alpha_relres = state[:6]
    n = x.shape[0]
    block = min(block, n)
    check_divisible(n, block, "x", "row-panel block")
    cross = cross_fn or default_cross
    b_cols = cross(kernel, x, x_test)  # (N, N*)
    mean = b_cols.T @ alpha
    if mean_only:
        if return_info:
            info = {"relres": torch.zeros((0,), dtype=mean.dtype, device=mean.device),
                    "relres_max": torch.as_tensor(alpha_relres, dtype=mean.dtype, device=mean.device),
                    "broke": torch.any(torch.isnan(alpha)), "iters": 0}
            return mean, None, info
        return mean, None
    if max_iters is None:
        max_iters = _auto_budget(n)
    minv = woodbury_precond(lpc, precond_shift * sigma2) if lpc.shape[-1] > 0 else None
    matvec = _operator(kernel, x, sigma2, block, cross, matvec_builder)
    res = mbcg(matvec, b_cols, max_iters=max_iters, tol=tol, precond=minv, stop_every=stop_every)
    cov_term = b_cols.T @ res.x  # (N*, N*)
    cov = cross(kernel, x_test, x_test) - 0.5 * (cov_term + cov_term.T)
    bad = torch.any(res.broke)
    mean = torch.where(bad, torch.full_like(mean, math.nan), mean)
    cov = torch.where(bad, torch.full_like(cov, math.nan), cov)
    if return_info:
        info = {"relres": res.residnorm,
                "relres_max": torch.maximum(torch.max(res.residnorm),
                                            torch.as_tensor(alpha_relres, dtype=res.residnorm.dtype,
                                                            device=res.residnorm.device)),
                "broke": bad, "iters": res.ran}
        return mean, cov, info
    return mean, cov


# ---------------------------------------------------------------------------
# the host-chunked entries: the paths above, stopped early
# ---------------------------------------------------------------------------


class ChunkedMLL:
    """The host-chunked ``lazy_cg_mll`` with its gradients, the JAX
    package's ``make_chunked_mll`` (:606-820): :func:`lazy_cg_mll` at a
    budget of ``chunk_iters``·``n_chunks`` iterations, stopped early every
    ``chunk_iters``, with its backward (``panel_vjp``: K3, or its row
    blocks, ``ops/matvec.packed_gibbs_panel_vjp(d, row_blocks)``).
    ``iters`` holds the mBCG iterations the last call ran.  Build it with
    :func:`make_chunked_mll`.  ``mll`` is the MLL it stops early:
    :func:`lazy_cg_mll`, or the row-sharded one
    (``parallel/sharded_cg.make_sharded_chunked_mll``)."""

    def __init__(self, chunk_iters: int, n_chunks: int, mll: Optional[Callable] = None, **mll_kw):
        self.chunk_iters, self.n_chunks, self._kw = chunk_iters, n_chunks, mll_kw
        self._mll = mll or lazy_cg_mll
        self.iters = 0

    def value_and_grad(self, kernel, x, resid, sigma2, probe_noise, pkey=None, early_stop: bool = True):
        """(val, relres, (kernel_g, x_g, resid_g, sigma2_g)) of the raw MLL
        (the caller applies its own −1/n), ``probe_noise`` as in
        ``lazy_cg_mll``, the gradient None for a None kernel.  ``pkey``:
        ``lazy_cg_mll``'s ``precond_key`` (None: greedy pivots, stride
        landmarks; the JAX package's ADVICE r4 fix, :654-690).  ``relres``
        is the (1 + R,) final relative residuals; the value is NaN on a
        breakdown."""
        sigma2 = torch.as_tensor(sigma2, dtype=x.dtype, device=x.device)
        leaves = [None if t is None else t.detach().requires_grad_() for t in (kernel, x, resid, sigma2)]
        info = {}
        with torch.enable_grad():
            val = self._mll(leaves[0], leaves[1], leaves[2], probe_noise, leaves[3], precond_key=pkey,
                            max_iters=self.chunk_iters * self.n_chunks,
                            stop_every=self.chunk_iters if early_stop else 0, info=info, **self._kw)
            grads = iter(torch.autograd.grad(val, [t for t in leaves if t is not None]))
        self.iters = info["iters"]
        return val.detach(), info["relres"], tuple(None if t is None else next(grads) for t in leaves)


def make_chunked_mll(block: int, chunk_iters: int, n_chunks: int, tol: float, precond_rank: int, precond: str,
                     precond_shift: float, cross_fn: Callable, matvec_builder: Optional[Callable],
                     panel_vjp: Optional[Callable]) -> ChunkedMLL:
    """A :class:`ChunkedMLL`.  ``chunk_iters × n_chunks`` is the whole mBCG
    budget; ``panel_vjp=None`` takes the panel pullback
    (:func:`make_jnp_panel_vjp`).  The JAX package's ``panel_vjp_rows`` and
    ``bwd_row_chunks`` are the port's ``packed_gibbs_panel_vjp(d, rows)``."""
    return ChunkedMLL(chunk_iters, n_chunks, block=block, tol=tol, precond_rank=precond_rank, precond=precond,
                      precond_shift=precond_shift, cross_fn=cross_fn, matvec_builder=matvec_builder,
                      panel_vjp=panel_vjp)


class ChunkedSolve:
    """The host-chunked preconditioned CG solve (K(x, x) + σ²I) X = B over a
    lazy operator, the JAX package's ``make_chunked_solve`` (:822-893): one
    ``bbmm.mbcg`` at a budget of ``chunk_iters``·``n_chunks``, stopped early
    every ``chunk_iters``.  Build it with :func:`make_chunked_solve`."""

    def __init__(self, block, chunk_iters, n_chunks, tol, cross_fn, matvec_builder, precond_shift):
        self.block, self.chunk_iters, self.n_chunks, self.tol = block, chunk_iters, n_chunks, tol
        self.cross_fn, self.matvec_builder, self.precond_shift = cross_fn, matvec_builder, precond_shift

    def __call__(self, kernel, x, rhs, sigma2, lpc, early_stop: bool = True):
        """(X, relres): X (N, R) NaN-poisoned on a breakdown, relres (R,)
        the final relative residuals.  ``lpc`` the (N, rank) factor, (N, 0)
        for none."""
        return self.solve(kernel, x, rhs, sigma2, lpc, early_stop)[:2]

    @torch.no_grad()
    def solve(self, kernel, x, rhs, sigma2, lpc, early_stop: bool = True):
        """(X, relres, broke, iters): :meth:`__call__`, the breakdown flag
        and the mBCG iterations run."""
        blk = min(self.block, x.shape[0])
        check_divisible(x.shape[0], blk, "x", "row-panel block")
        minv = woodbury_precond(lpc, self.precond_shift * sigma2) if lpc.shape[-1] > 0 else None
        res = mbcg(_operator(kernel, x, sigma2, blk, self.cross_fn, self.matvec_builder), rhs,
                   max_iters=self.chunk_iters * self.n_chunks, tol=self.tol, precond=minv,
                   stop_every=self.chunk_iters if early_stop else 0)
        bad = torch.any(res.broke)
        return torch.where(bad, torch.full_like(res.x, math.nan), res.x), res.residnorm, bad, res.ran


def make_chunked_solve(block: int, chunk_iters: int, n_chunks: int, tol: float, cross_fn: Callable,
                       matvec_builder: Optional[Callable] = None, precond_shift: float = 1.0) -> ChunkedSolve:
    """A :class:`ChunkedSolve`."""
    return ChunkedSolve(block, chunk_iters, n_chunks, tol, cross_fn, matvec_builder, precond_shift)


def lazy_posterior_state_chunked(kernel, x: torch.Tensor, resid: torch.Tensor, sigma2, *, block: int = 2048,
                                 chunk_iters: int = 8, n_chunks: int = 8, **kw) -> LazyPosteriorState:
    """:func:`lazy_posterior_state` with the α solve host-chunked: at most
    ``chunk_iters``·``n_chunks`` iterations, stopped early every
    ``chunk_iters``."""
    return lazy_posterior_state(kernel, x, resid, sigma2, block=block, max_iters=chunk_iters * n_chunks,
                                stop_every=chunk_iters, **kw)


def lazy_posterior_query_chunked(state: LazyPosteriorState, x_test: torch.Tensor, *, block: int = 2048,
                                 chunk_iters: int = 8, n_chunks: int = 8, **kw):
    """:func:`lazy_posterior_query` with the variance solve host-chunked: at
    most ``chunk_iters``·``n_chunks`` iterations, stopped early every
    ``chunk_iters``.  Its conventions are the one-shot query's, where the
    JAX package's chunked query departs from them:
      * F1: a breakdown of the variance solve turns both mean and cov to NaN
        (JAX's chunked query NaNs only cov, ``lazy_cg.py:1008-1023``);
      * F2: ``info["broke"]`` is the CG carry's breakdown flag (JAX takes
        isnan(sol[0])), and in the mean-only branch the α solve's, which the
        state carries as a NaN α (JAX reports False).
    F3: no retry; the α relres rides in ``relres_max``."""
    return lazy_posterior_query(state, x_test, block=block, max_iters=chunk_iters * n_chunks,
                                stop_every=chunk_iters, **kw)
