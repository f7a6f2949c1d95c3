"""Black-box matrix-matrix (BBMM) inference: batched conjugate gradients,
stochastic Lanczos quadrature and the CG-based exact-GP marginal
log-likelihood on a dense Gram (``cg_mll``).

Counterpart of ``nonstationary_precip_tpu/ops/bbmm.py`` (GPyTorch's mBCG,
Gardner et al. 2018).  mBCG runs exactly ``max_iters`` masked iterations in
a Python loop, with no early exit and no host synchronisation inside it:
converged columns freeze through their masks, as in the JAX package's fixed
``lax.scan``.  ``mbcg_chunk`` runs the same loop from a carry; with
``stop_every`` mBCG runs chunks of it and stops once every column has
converged, the host-chunked solves' early stop (``ops/lazy_cg``).
Randomness comes from the caller: ``sample_precond_probes`` takes the
normal draws, not a key, and ``cg_mll`` takes ``lazy_cg_mll``'s
``probe_noise``.  ``cg_mll`` is one ``torch.autograd.Function`` whose
backward is the trace identity dMLL/dK = ½(ααᵀ − E[(K⁻¹z) rᵀ]) from the
solves saved in the forward: no differentiation through the iterations.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch


class CGResult(NamedTuple):
    """Solution and Lanczos data from ``mbcg``."""

    x: torch.Tensor  # (N, R) solutions
    alphas: torch.Tensor  # (T, R) CG step sizes (0 where converged/invalid)
    betas: torch.Tensor  # (T, R) CG direction updates
    residnorm: torch.Tensor  # (R,) final relative residual norms (/ ||b||)
    iters: torch.Tensor  # (R,) iterations to convergence (= T if never)
    broke: torch.Tensor  # (R,) True where CG hit pᵀKp ≤ 0 before converging
    resnorm_hist: torch.Tensor  # (T, R) relative residual after each iteration
    ran: int  # iterations run (T unless stopped early)


def mbcg_init(b: torch.Tensor, precond=None):
    """(b, safe_bnorm, carry0) for the mBCG iteration."""
    r = b.shape[1]
    minv = precond if precond is not None else (lambda v: v)
    safe_bnorm = torch.clamp_min(torch.linalg.vector_norm(b, dim=0), 1e-30)
    z0 = minv(b)
    rz0 = torch.sum(b * z0, dim=0)
    zeros_b = torch.zeros(r, dtype=torch.bool, device=b.device)
    init = (torch.zeros_like(b), b, z0, z0, rz0, zeros_b, torch.zeros(r, dtype=torch.int32, device=b.device),
            zeros_b)
    return b, safe_bnorm, init


def _make_mbcg_step(matvec, precond, tol, safe_bnorm, dtype):
    minv = precond if precond is not None else (lambda v: v)
    # pᵀKp ≤ 0 while the residual is still large means breakdown; near the
    # dtype's convergence floor it is benign stagnation (JAX package, :130-139)
    stall = max(10.0 * tol, 1e3 * torch.finfo(dtype).eps)

    def step(carry):
        x, res, z, p, rz, done, it, broke = carry
        kp = matvec(p)
        pkp = torch.sum(p * kp, dim=0)
        relres = torch.linalg.vector_norm(res, dim=0) / safe_bnorm
        broke = broke | (~done & (pkp <= 0.0) & (relres > stall))
        valid = ~done & (pkp > 0.0)
        alpha = torch.where(valid, rz / torch.where(pkp > 0.0, pkp, torch.ones_like(pkp)), torch.zeros_like(pkp))
        x = x + alpha[None, :] * p
        res_new = res - alpha[None, :] * kp
        z_new = minv(res_new)
        rz_new = torch.sum(res_new * z_new, dim=0)
        beta = torch.where(valid, rz_new / torch.where(rz > 0.0, rz, torch.ones_like(rz)), torch.zeros_like(rz))
        p_new = torch.where(valid[None, :], z_new + beta[None, :] * p, p)
        resnorm = torch.linalg.vector_norm(res_new, dim=0)
        done_next = done | (resnorm / safe_bnorm < tol)
        it = it + (~done).to(it.dtype)
        res = torch.where(valid[None, :], res_new, res)
        z = torch.where(valid[None, :], z_new, z)
        rz = torch.where(valid, rz_new, rz)
        return (x, res, z, p_new, rz, done_next, it, broke), (alpha, beta, resnorm)

    return step


def mbcg(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor, max_iters: int = 100,
         tol: float = 1e-6, precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
         stop_every: int = 0) -> CGResult:
    """Modified batched conjugate gradients: solves K x = b for all R
    columns of ``b`` at once and records the per-column CG coefficients
    (α, β) that define the Lanczos tridiagonal of the (preconditioned)
    operator.  ``matvec`` and ``precond`` (P⁻¹) map (N, R) → (N, R).
    Runs exactly ``max_iters`` iterations; converged columns are masked.

    ``stop_every`` > 0 reads the done flags every ``stop_every`` iterations
    and stops once every column has converged (one host read a chunk).  The
    iterations not run are those a full run would have masked, so the
    coefficients are padded as it pads them (α = β = 0, the residual
    unchanged) and the result is the full run's; ``ran`` counts the
    iterations run."""
    b, safe_bnorm, carry = mbcg_init(b, precond)
    parts, ran = [], 0
    while ran < max_iters:
        carry, out = mbcg_chunk(matvec, carry, min(stop_every or max_iters, max_iters - ran), tol, safe_bnorm,
                                precond)
        parts.append(out)
        ran += out[0].shape[0]
        if stop_every and bool(carry[5].all()):
            break
    alphas, betas, resnorms = (torch.cat(p) for p in zip(*parts))
    if ran < max_iters:
        pad = torch.zeros((max_iters - ran, alphas.shape[1]), dtype=alphas.dtype, device=alphas.device)
        alphas, betas = torch.cat([alphas, pad]), torch.cat([betas, pad])
        resnorms = torch.cat([resnorms, resnorms[-1:].expand(max_iters - ran, -1)])
    x, res, _, _, _, _, iters, broke = carry
    return CGResult(x=x, alphas=alphas, betas=betas,
                    residnorm=torch.linalg.vector_norm(res, dim=0) / safe_bnorm,
                    iters=iters, broke=broke, resnorm_hist=resnorms / safe_bnorm[None, :], ran=ran)


def mbcg_chunk(matvec: Callable[[torch.Tensor], torch.Tensor], carry: tuple, length: int, tol: float,
               safe_bnorm: torch.Tensor, precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """``length`` mBCG iterations from ``carry`` (``mbcg_init``'s or a
    previous chunk's): (carry', (alphas, betas, resnorms)), each (length, R).
    :func:`mbcg` is a sequence of these, so chunks run from its carry are
    its run, bit for bit (the JAX package's ``mbcg_chunk``)."""
    step = _make_mbcg_step(matvec, precond, tol, safe_bnorm, carry[0].dtype)
    hist = []
    for _ in range(length):
        carry, out = step(carry)
        hist.append(out)
    return carry, tuple(torch.stack(h) for h in zip(*hist))


def lanczos_tridiag(alphas: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """CG coefficients → Lanczos tridiagonals, (R, T, T):
    T[0,0] = 1/α₀, T[j,j] = 1/αⱼ + βⱼ₋₁/αⱼ₋₁, T[j,j−1] = √βⱼ₋₁/αⱼ₋₁.
    Iterations past convergence (α = 0) collapse to an identity pad."""
    t, r = alphas.shape
    a, bt = alphas.T, betas.T
    pos = a > 0.0
    inv_a = 1.0 / torch.where(pos, a, torch.ones_like(a))
    zero = torch.zeros((r, 1), dtype=a.dtype, device=a.device)
    prev_inv_a = torch.cat([zero, inv_a[:, :-1]], dim=1)
    prev_b = torch.cat([zero, bt[:, :-1]], dim=1)
    diag = torch.where(pos, inv_a + prev_b * prev_inv_a, torch.ones_like(a))
    off = torch.where(pos & (prev_b > 0.0), torch.sqrt(torch.clamp_min(prev_b, 0.0)) * prev_inv_a,
                      torch.zeros_like(a))[:, 1:]
    return torch.diag_embed(diag) + torch.diag_embed(off, offset=-1) + torch.diag_embed(off, offset=1)


def lanczos_logdet(alphas: torch.Tensor, betas: torch.Tensor, probe_sqnorms: torch.Tensor) -> torch.Tensor:
    """SLQ estimate of log det K from mBCG coefficients:
    mean_i ‖zᵢ‖² · e₁ᵀ log(Tᵢ) e₁.  Ritz values are floored at the rounding
    scale 8·eps·max|λ|; a Ritz value below −that (breakdown or an
    indefinite operator) turns the estimate into NaN (JAX package, :219-239)."""
    evals, evecs = torch.linalg.eigh(lanczos_tridiag(alphas, betas))
    w = evecs[:, 0, :] ** 2
    tol = 8.0 * torch.finfo(evals.dtype).eps * torch.amax(torch.abs(evals), dim=-1, keepdim=True)
    loge = torch.log(torch.maximum(evals, torch.clamp_min(tol, 1e-30)))
    est = torch.mean(probe_sqnorms * torch.sum(w * loge, dim=-1))
    return torch.where(torch.any(evals <= -tol), torch.full_like(est, math.nan), est)


def pivoted_cholesky(k: torch.Tensor, rank: int, jitter: float = 1e-8):
    """Rank-``rank`` greedy pivoted Cholesky factor L (N, rank) with
    LLᵀ ≈ K, and the pivot diagonal history; the dense oracle of
    ``ops/lazy_cg.lazy_pivoted_cholesky``."""
    n = k.shape[-1]
    d = torch.diagonal(k).clone()
    l = torch.zeros((n, rank), dtype=k.dtype, device=k.device)
    hist = []
    for j in range(rank):
        piv = torch.argmax(d).reshape(1)
        dmax = d.index_select(0, piv)[0]
        resid = k.index_select(0, piv)[0] - l @ l.index_select(0, piv)[0]
        col = resid / torch.sqrt(torch.clamp_min(dmax, jitter))
        col = torch.where(d > 0.0, col, torch.zeros_like(col))
        l[:, j] = col
        d = torch.clamp_min(d - col * col, 0.0)
        d = d.index_fill(0, piv, 0.0)
        hist.append(dmax)
    return l, torch.stack(hist)


def woodbury_precond(l: torch.Tensor, sigma2) -> Callable[[torch.Tensor], torch.Tensor]:
    """P⁻¹ for P = LLᵀ + σ²I by Woodbury:
    P⁻¹v = (v − L (σ²I + LᵀL)⁻¹ Lᵀ v) / σ², one k×k Cholesky up front.

    Computed in float64 whatever the operands' dtype (float64 operands
    unchanged), the result in v's dtype.  In float32 two things fail at the
    JAX flagship's N = 1,048,576 (Nyström rank 1024, shift 10; ROADMAP §3,
    F-P9, ``tools/probe_woodbury_f32.py``): LᵀL summed down the 2²⁰ rows in
    one product is off by more than σ², which diverged the training solves
    at the init pose, and the correction's cancellation against v,
    ε·λmax(P)/σ² (the JAX package's DESIGN §30), kept the serve's training
    solves near the relres gate.  Costs an (N, k) float64 copy of L a
    preconditioner."""
    l64 = l.double()
    s2 = torch.as_tensor(sigma2, dtype=torch.float64, device=l.device)
    kk = l.shape[-1]
    cf = torch.linalg.cholesky(s2 * torch.eye(kk, dtype=torch.float64, device=l.device) + l64.T @ l64)
    return lambda v: ((v.double() - l64 @ torch.cholesky_solve(l64.T @ v.double(), cf)) / s2).to(v.dtype)


def precond_logdet(l: torch.Tensor, sigma2, n: int) -> torch.Tensor:
    """log det(LLᵀ + σ²I) = Σ log(λᵢ(LᵀL) + σ²) + (n − k) log σ²."""
    kk = l.shape[-1]
    lam = torch.linalg.eigvalsh(l.T @ l)
    return torch.sum(torch.log(lam + sigma2)) + (n - kk) * torch.log(torch.as_tensor(sigma2, dtype=l.dtype))


def sample_precond_probes(l: torch.Tensor, sigma2, u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """z ~ N(0, P), P = LLᵀ + σ²I, from the caller's standard normal draws
    u1 (rank, R) and u2 (N, R): z = L u₁ + σ u₂."""
    return l @ u1 + torch.sqrt(torch.as_tensor(sigma2, dtype=l.dtype, device=l.device)) * u2


# ---------------------------------------------------------------------------
# CG-based exact-GP marginal log-likelihood on a dense Gram
# ---------------------------------------------------------------------------


class _CGMLL(torch.autograd.Function):
    """The JAX package's ``cg_mll`` custom VJP: forward ``_cg_mll_fwd``
    (:338-379), backward ``_cg_mll_bwd`` (:382-398)."""

    @staticmethod
    def forward(ctx, kmat, y, sigma2, probes, lpc, max_iters, tol):
        n = y.shape[-1]
        if lpc is not None:
            # the preconditioner parameterises the estimator, not the
            # estimand: σ² is frozen in it
            minv = woodbury_precond(lpc, sigma2)
            logdet_p = precond_logdet(lpc, sigma2, n)
            # z ~ N(0, P): the SLQ weight is zᵀP⁻¹z, and pairing K⁻¹z with
            # P⁻¹z keeps E[(K⁻¹z)(P⁻¹z)ᵀ] = K⁻¹ (pairing with z gives K⁻¹P)
            rights = minv(probes)
            probe_w = torch.sum(probes * rights, dim=0)
        else:
            minv = None
            logdet_p = torch.zeros((), dtype=y.dtype, device=y.device)
            rights = probes  # E[z zᵀ] = I for Rademacher probes
            probe_w = torch.sum(probes * probes, dim=0)
        res = mbcg(lambda v: kmat @ v, torch.cat([y[:, None], probes], dim=1), max_iters=max_iters, tol=tol,
                   precond=minv)
        alpha, solves = res.x[:, 0], res.x[:, 1:]
        logdet = logdet_p + lanczos_logdet(res.alphas[:, 1:], res.betas[:, 1:], probe_w)
        two_pi = torch.tensor(2.0 * math.pi, dtype=y.dtype, device=y.device)
        mll = -0.5 * torch.dot(y, alpha) - 0.5 * logdet - 0.5 * n * torch.log(two_pi)
        # a breakdown on any column invalidates the solve and the quadrature
        mll = torch.where(torch.any(res.broke), torch.full_like(mll, math.nan), mll)
        ctx.save_for_backward(alpha, solves, rights, sigma2)
        return mll

    @staticmethod
    def backward(ctx, g):
        alpha, solves, rights, sigma2 = ctx.saved_tensors
        kbar = 0.5 * torch.outer(alpha, alpha) - 0.5 * (solves @ rights.T) / rights.shape[-1]
        kbar = 0.5 * (kbar + kbar.T)
        # σ² enters only through the frozen preconditioner: an exact zero in
        # its own dtype
        return g * kbar, -g * alpha, torch.zeros_like(sigma2), None, None, None, None


def cg_mll(kmat: torch.Tensor, y: torch.Tensor, probe_noise, sigma2, *, max_iters: int = 100, tol: float = 1e-6,
           precond_rank: int = 0) -> torch.Tensor:
    """−½ yᵀK⁻¹y − ½ log det K − (n/2) log 2π by mBCG and SLQ, K =
    ``kmat`` (N, N) with the noise in it (K_f + σ²I).  Differentiable w.r.t.
    ``kmat`` and ``y``; ``sigma2`` only splits the preconditioner
    P = LLᵀ + σ²I (the pivoted Cholesky runs on K − σ²I) and gets a zero
    gradient.

    ``probe_noise``, as ``ops/lazy_cg.lazy_cg_mll`` takes it: with
    ``precond_rank > 0`` the standard normal draws (u1 (rank, R), u2 (N, R))
    of the probes z = L u₁ + σ u₂ ~ N(0, P); without, the (N, R) Rademacher
    probes themselves.  The probes, the factor and σ² in P carry no
    gradient.  A breakdown of CG on any column makes the value NaN."""
    n = y.shape[-1]
    sigma2 = torch.as_tensor(sigma2, dtype=kmat.dtype, device=kmat.device)
    with torch.no_grad():
        s2 = sigma2.detach()
        if precond_rank > 0:
            eye = torch.eye(n, dtype=kmat.dtype, device=kmat.device)
            lpc, _ = pivoted_cholesky(kmat.detach() - s2 * eye, precond_rank)
            u1, u2 = probe_noise
            probes = sample_precond_probes(lpc, s2, u1, u2)
        else:
            lpc, probes = None, probe_noise.detach()
    return _CGMLL.apply(kmat, y, sigma2, probes, lpc, max_iters, tol)
