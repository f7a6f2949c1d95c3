"""Log-normal latent process: D independent GPs on the log-lengthscale.

Counterpart of ``nonstationary_precip_tpu/priors/lognormal_process.py``:

  * ``conditional_mean`` — exp of the conditional mean only (no conditional
    covariance), with 1e-4 jitter on the conditioning Gram;
  * ``log_prob``         — joint MVN log-density of the log-field with 1e-4
    jitter, summed over dims and divided by N;
  * their matrix-free forms for large N under a frozen prior:
    ``gram_pre_lazy`` hoists per-dim pivoted-Cholesky preconditioners and
    the constant SLQ logdet once per fit, ``log_prob_matrixfree`` solves
    each dim's quadratic by CG (``ops/lazy_cg.lazy_cg_quad``), and
    ``conditional_pre_matrixfree`` / ``conditional_mean_from_pre`` split
    the conditional mean into its per-fit solves and its per-query panels
    (the solves host-chunked with ``chunk_iters``).
    Each dim's operator is a Scale(RBF-ARD) Gram that never exists: on a
    CUDA tensor K12 (``ops/matvec.make_se_f64_matvec``, its SE Gram·V in
    float64) takes every matvec of the four (the SLQ hoist's, the
    quadratic's, the conditioning solve's and the conditional mean's
    cross), and no (block, N) panel is built on the card; on the CPU its
    plain version, the row panels of ``_dim_cross`` that the JAX package
    leaves to XLA, bit for bit the panels these paths built before.  The
    pivoted-Cholesky factor's rows stay ``_dim_cross`` calls.  These take
    an unbatched prior and (N, D_in) inputs, and run their solves in
    ``SOLVE_DTYPE`` (float64) whatever the inputs' dtype, where the JAX
    package runs float32: the jittered prior Gram (ridge 1e-4, λmax ~ 3·10³
    at N = 16384 on the quickstart's data) is beyond float32, where these
    solves diverge (ROADMAP §3, F6).  Results come back in the inputs'
    dtype.

Layout: lengthscale fields are (..., N, D), row per point; each output dim d
has its own constant mean and its own Scale(RBF-ARD) kernel over the D_in
input dims.  Every parameter may carry leading batch dimensions (one prior
per split), matching leading dimensions of x.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from nonstationary_precip_tpu_torch.kernels.stationary import _sq_dist as sq_dist
from nonstationary_precip_tpu_torch.ops.bbmm import mbcg, woodbury_precond
from nonstationary_precip_tpu_torch.ops.lazy_cg import (
    check_divisible,
    lazy_cg_quad,
    lazy_pivoted_cholesky,
    lazy_slq_logdet,
)
from nonstationary_precip_tpu_torch.ops.matvec import make_se_f64_matvec, se_cross, se_f64_matvec_builder
from nonstationary_precip_tpu_torch.ops.linalg import (
    add_jitter,
    cho_solve,
    mvn_logpdf_from_chol,
    safe_cholesky,
)
from nonstationary_precip_tpu_torch.utils.transforms import positive, raw_init

_COND_JITTER = 1e-4  # reference: gibbs_kernels.py:88,107

#: dtype of the matrix-free prior's solves, float64 where the JAX package
#: runs float32: in float32 the same preconditioned CG on K_d + 1e-4 I
#: diverges at N = 16384 (relres 63 and 245 after 96 iterations on an H100,
#: at the quickstart's trained pose) where float64 reaches 3e-9; the
#: Woodbury apply P⁻¹v = (v − L(cI + LᵀL)⁻¹Lᵀv)/c cancels to
#: ε·λmax(P)/c ≈ 4 in float32 (ROADMAP §3, F6).
SOLVE_DTYPE = torch.float64


#: Scale(RBF-ARD) cross-Gram of one prior output dim, ``params`` =
#: (ℓ (D_in,), s²): the pivoted-Cholesky factor's rows (K12's plain
#: element, ``ops/matvec.se_cross``; K12 takes the matvecs).
_dim_cross = se_cross


class LogNormalProcess(nn.Module):
    """D independent GP priors on log-lengthscale fields.

    Parameters (after any leading batch dims):
      mean_const       (D,)        constant mean of each log-GP
      raw_outputscale  (D,)        Scale kernel outputscale (softplus raw)
      raw_lengthscale  (D, D_in)   RBF-ARD lengthscales    (softplus raw)
    """

    def __init__(self, mean_const, raw_outputscale, raw_lengthscale, active_dims: Optional[tuple] = None):
        super().__init__()
        self.mean_const = nn.Parameter(mean_const, requires_grad=False)
        self.raw_outputscale = nn.Parameter(raw_outputscale, requires_grad=False)
        self.raw_lengthscale = nn.Parameter(raw_lengthscale, requires_grad=False)
        self.active_dims = active_dims

    @classmethod
    def create(
        cls,
        input_dim: int,
        mean: float = 0.0,
        outputscale: float = None,
        lengthscale: float = None,
        active_dims: Optional[tuple] = None,
        dtype=torch.float32,
        device=None,
    ):
        """One log-GP per input dim.  Defaults mirror GPyTorch inits:
        constant mean 0, softplus(0) outputscale/lengthscale.
        ``active_dims`` selects the input columns the prior's Grams see."""
        d_out = input_dim
        kw = dict(dtype=dtype, device=device)
        mc = torch.full((d_out,), mean, **kw)
        ros = (
            torch.zeros((d_out,), **kw)
            if outputscale is None
            else raw_init(torch.full((d_out,), outputscale, **kw))
        )
        rls = (
            torch.zeros((d_out, input_dim), **kw)
            if lengthscale is None
            else raw_init(torch.full((d_out, input_dim), lengthscale, **kw))
        )
        return cls(mc, ros, rls, active_dims)

    # -- internals ---------------------------------------------------------

    def _slice(self, x):
        """The input columns of ``active_dims`` (all of them when None)."""
        if self.active_dims is None:
            return x
        return x[..., list(self.active_dims)]

    def _gram(self, x1, x2=None):
        """Batched Scale(RBF-ARD) Grams, one per output dim: (..., D, N1, N2)."""
        x1 = self._slice(x1)
        x2 = x1 if x2 is None else self._slice(x2)
        ell = positive(self.raw_lengthscale)[..., :, None, :]  # (..., D, 1, D_in)
        s2 = positive(self.raw_outputscale)[..., :, None, None]  # (..., D, 1, 1)
        return s2 * torch.exp(-0.5 * sq_dist(x1[..., None, :, :] / ell, x2[..., None, :, :] / ell))

    def mean(self, x) -> torch.Tensor:
        """Prior mean of the log-field at x: (..., N, D)."""
        n = x.shape[-2]
        mc = self.mean_const[..., None, :]
        return mc.expand(*mc.shape[:-2], n, mc.shape[-1])

    # -- reference API -----------------------------------------------------

    def conditional_mean(self, x: torch.Tensor, given: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        """exp of E[log ℓ(x) | log ℓ(x_g) = log ell_g]: (..., N, D) positive.

        The conditional covariance is dropped; jitter 1e-4 on the
        conditioning Gram; exp of the mean (not the log-normal mean)."""
        xg, ell_g = given
        k_xg = self._gram(x, xg)  # (..., D, N, Ng)
        k_gg = add_jitter(self._gram(xg), _COND_JITTER)  # (..., D, Ng, Ng)
        resid = torch.log(ell_g).mT - self.mean(xg).mT  # (..., D, Ng)
        alpha = cho_solve(safe_cholesky(k_gg), resid)  # (..., D, Ng)
        mu = self.mean(x).mT + (k_xg @ alpha[..., None])[..., 0]  # (..., D, N)
        return torch.exp(mu).mT

    def gram_chol(self, x: torch.Tensor) -> torch.Tensor:
        """chol(K_d + 1e-4 I) per output dim: (..., D, N, N).  Loop-invariant
        under a frozen prior: compute once per fit and pass to ``log_prob``."""
        return safe_cholesky(add_jitter(self._gram(x), _COND_JITTER))

    def gram_pre(self, x: torch.Tensor):
        """(K⁻¹ (..., D, N, N), logdet (..., D)) of K_d + 1e-4 I — the
        fully-hoisted form of ``gram_chol`` for a frozen prior: the per-step
        prior term becomes one batched matmul and a constant."""
        chols = self.gram_chol(x)
        eye = torch.eye(chols.shape[-1], dtype=chols.dtype, device=chols.device)
        linv = torch.linalg.solve_triangular(chols, eye.expand_as(chols), upper=False)
        kinv = linv.mT @ linv
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)), dim=-1)
        return kinv, logdet

    def log_prob(self, x: torch.Tensor, log_ell: torch.Tensor, chols=None) -> torch.Tensor:
        """Σ_d log N(log_ell[..., d]; mean_d, K_d + 1e-4 I) / N — the
        reference's per-N-normalised prior term.

        ``chols`` may be the (..., D, N, N) Cholesky stack from ``gram_chol``
        or the (K⁻¹, logdet) pair from ``gram_pre``."""
        n = x.shape[-2]
        if isinstance(chols, tuple):
            kinv, logdet = chols
            diff = log_ell.mT - self.mean(x).mT  # (..., D, N)
            quad = torch.sum(diff * (kinv @ diff[..., None])[..., 0], dim=-1)
            lp = -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))
            return torch.sum(lp, dim=-1) / n
        if chols is None:
            chols = self.gram_chol(x)
        lp = mvn_logpdf_from_chol(log_ell.mT, self.mean(x).mT, chols)  # (..., D)
        return torch.sum(lp, dim=-1) / n

    # -- matrix-free forms (large N, frozen prior) ---------------------------

    def _dim_params(self, dtype=SOLVE_DTYPE):
        """[(ℓ_d (D_in,), s²_d)] per output dim in ``dtype``, the
        ``_dim_cross`` operands."""
        ell = positive(self.raw_lengthscale).to(dtype)
        s2 = positive(self.raw_outputscale).to(dtype)
        return [(ell[d], s2[d]) for d in range(self.mean_const.shape[0])]

    @torch.no_grad()
    def gram_pre_lazy(self, x: torch.Tensor, probe_noise, *, rank: int = 50, block: int = 1024,
                      max_iters: int = 256, tol: float = 1e-10, precond_key=None, precond_shift: float = 1.0,
                      stop_every: int = 0, info: Optional[dict] = None):
        """Matrix-free counterpart of ``gram_pre`` for large N, where the D
        (N, N) prior Grams no longer fit: per-dim rank-``rank`` pivoted-
        Cholesky factors of K_d (the loop-invariant preconditioners of the
        per-step quadratic solves; the 1e-4 jitter makes plain CG stall) and
        an SLQ estimate of log det(K_d + 1e-4 I), a constant of training.

        ``probe_noise``: one pair (u1 (rank, R), u2 (N, R)) of standard
        normal draws per output dim, the SLQ probes' (the JAX package draws
        them from ``fold_in(key, d)``, R = 16 by default).  ``precond_key``:
        RPCholesky's (rank, N) Gumbel draws, the same for every dim as the
        JAX package passes one key to each, or a ``torch.Generator`` (which
        advances from dim to dim).  Returns
        ``(lpc (D, N, rank), logdet (D,))``, both in ``SOLVE_DTYPE``, for
        :meth:`log_prob_matrixfree`.  ``stop_every``: the SLQ solves' early
        stop, whose logdet is the full budget's bit for bit
        (``lazy_slq_logdet``); ``info``, a dict, receives a dim's
        ``lazy_slq_logdet`` evidence each under ``dims``."""
        xs = self._slice(x).to(SOLVE_DTYPE)
        jitter = torch.tensor(_COND_JITTER, dtype=SOLVE_DTYPE, device=x.device)
        lpcs, logdets, dims = [], [], []
        for params, (u1, u2) in zip(self._dim_params(), probe_noise, strict=True):
            lpc = lazy_pivoted_cholesky(params, xs, rank, cross_fn=_dim_cross, key=precond_key)
            dims.append({})
            logdets.append(lazy_slq_logdet(params, xs, (u1.to(SOLVE_DTYPE), u2.to(SOLVE_DTYPE)), jitter, lpc=lpc,
                                           block=block, max_iters=max_iters, tol=tol, precond_shift=precond_shift,
                                           matvec_builder=se_f64_matvec_builder(block), stop_every=stop_every,
                                           info=dims[-1]))
            lpcs.append(lpc)
        if info is not None:
            info["dims"] = dims
        return torch.stack(lpcs), torch.stack(logdets)

    def log_prob_matrixfree(self, x: torch.Tensor, log_ell: torch.Tensor, pre, *, block: int = 1024,
                            max_iters: int = 64, tol: float = 1e-6, precond_shift: float = 1.0,
                            stop_every: int = 0, info: Optional[dict] = None) -> torch.Tensor:
        """:meth:`log_prob` for large N under the frozen-prior contract: each
        dim's quadratic by one preconditioned matrix-free CG solve
        (``lazy_cg_quad``, whose gradient in ``log_ell`` is the exact
        2K⁻¹diff at convergence), its logdet the hoisted constant of
        :meth:`gram_pre_lazy`.  The prior's own parameters get no gradient.
        ``stop_every``: the solves' early stop; ``info``, a dict, receives
        ``relres``, the (D,) solves' final relative residuals, and
        ``iters``, the mBCG iterations each ran."""
        lpc, logdet = pre
        n = x.shape[-2]
        xs = self._slice(x).to(SOLVE_DTYPE)
        jitter = torch.tensor(_COND_JITTER, dtype=SOLVE_DTYPE, device=x.device)
        diff = (log_ell.mT - self.mean(x).mT).to(SOLVE_DTYPE)  # (D, N)
        lp, dims = 0.0, [{} for _ in range(diff.shape[0])]
        for d, params in enumerate(self._dim_params()):
            quad = lazy_cg_quad(params, xs, diff[d], jitter, lpc=lpc[d].to(SOLVE_DTYPE), block=block,
                                max_iters=max_iters, tol=tol, precond_shift=precond_shift,
                                matvec_builder=se_f64_matvec_builder(block), stop_every=stop_every, info=dims[d])
            lp = lp - 0.5 * (quad + logdet[d].to(SOLVE_DTYPE) + n * math.log(2.0 * math.pi))
        if info is not None:
            info["relres"] = torch.stack([dim["relres"] for dim in dims])
            info["iters"] = [dim["iters"] for dim in dims]
        return (lp / n).to(log_ell.dtype)

    @torch.no_grad()
    def conditional_pre_matrixfree(self, given, pre, *, block: int = 1024, max_iters: int = 256,
                                   tol: float = 1e-10, precond_shift: float = 1.0,
                                   chunk_iters: Optional[int] = None, info: Optional[dict] = None) -> torch.Tensor:
        """The query-independent half of :meth:`conditional_mean_matrixfree`:
        per-dim conditioning solves αᵈ = (Kᵈ(x_g, x_g) + 1e-4 I)⁻¹(log ℓ_g − μ)ᵈ,
        each one preconditioned single-RHS mBCG over lazy panels with
        ``pre``'s factors (:meth:`gram_pre_lazy` of the same x_g; its logdet
        is ignored).  A breakdown makes that dim's α NaN.  Hoist once per
        fit; returns (D, Ng) in ``SOLVE_DTYPE``.  ``chunk_iters`` runs each
        solve host-chunked, the JAX package's chunked route: ⌈max_iters /
        chunk_iters⌉ chunks at most, stopped early once converged
        (``bbmm.mbcg``'s ``stop_every``).  ``info``, a dict, receives
        ``relres``, the (D,) solves' final relative residuals, and
        ``iters``, the mBCG iterations each ran."""
        xg, ell_g = given
        lpc, _ = pre
        xgs = self._slice(xg).to(SOLVE_DTYPE)
        ng = xgs.shape[0]
        blk = min(block, ng)
        check_divisible(ng, blk, "x_g", "row-panel block")
        jitter = torch.tensor(_COND_JITTER, dtype=SOLVE_DTYPE, device=xg.device)
        resid = (torch.log(ell_g).mT - self.mean(xg).mT).to(SOLVE_DTYPE)  # (D, Ng)
        alphas, relres, iters = [], [], []
        if chunk_iters is not None:
            max_iters = -(-max_iters // chunk_iters) * chunk_iters
        for d, params in enumerate(self._dim_params()):
            matvec = make_se_f64_matvec(params, xgs, sigma2=jitter, block=blk)
            res = mbcg(matvec, resid[d][:, None], max_iters=max_iters, tol=tol,
                       precond=woodbury_precond(lpc[d].to(SOLVE_DTYPE), precond_shift * jitter),
                       stop_every=chunk_iters or 0)
            alphas.append(torch.where(torch.any(res.broke), torch.full_like(res.x[:, 0], math.nan), res.x[:, 0]))
            relres.append(res.residnorm[0])
            iters.append(res.ran)
        if info is not None:
            info.update(relres=torch.stack(relres), iters=iters)
        return torch.stack(alphas)

    @torch.no_grad()
    def conditional_mean_from_pre(self, x: torch.Tensor, given, cond_alphas: torch.Tensor, *,
                                  block: int = 1024) -> torch.Tensor:
        """The per-query half: ℓ(x) = exp(μ + k(x, x_g)·α), the cross Gram
        times α by K12 (on the CPU its plain version, row panels of x), no
        solve.  ``given`` is (x_g, anything); ``cond_alphas`` from
        :meth:`conditional_pre_matrixfree`.  (N, D)."""
        xg, _ = given
        xgs = self._slice(xg).to(SOLVE_DTYPE)
        xs = self._slice(x).to(SOLVE_DTYPE)
        tb = min(block, xs.shape[0])
        mus = []
        for d, params in enumerate(self._dim_params()):
            proj = make_se_f64_matvec(params, xs, xgs, block=tb)(cond_alphas[d].to(SOLVE_DTYPE))
            mus.append(self.mean_const[d] + proj)
        return torch.exp(torch.stack(mus)).mT.to(x.dtype)

    def conditional_mean_matrixfree(self, x: torch.Tensor, given, pre, *, block: int = 1024,
                                    max_iters: int = 256, tol: float = 1e-10,
                                    precond_shift: float = 1.0) -> torch.Tensor:
        """:meth:`conditional_mean` for large conditioning sets: the
        conditioning solves by :meth:`conditional_pre_matrixfree`, then
        :meth:`conditional_mean_from_pre`.  Deterministic, the same 1e-4
        jitter; re-solves every call (hoist the first half for repeated
        queries)."""
        alphas = self.conditional_pre_matrixfree(given, pre, block=block, max_iters=max_iters, tol=tol,
                                                 precond_shift=precond_shift)
        return self.conditional_mean_from_pre(x, given, alphas, block=block)

    def init_log_field(self, x: torch.Tensor) -> torch.Tensor:
        """Initial latent log-lengthscale field = prior mean at x: (..., N, D)."""
        return self.mean(x)
