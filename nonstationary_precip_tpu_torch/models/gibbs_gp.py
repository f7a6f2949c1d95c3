"""MAP inference for the diagonal-Gibbs nonstationary GP, exact and sparse.

Counterpart of ``nonstationary_precip_tpu/models/gibbs_gp.py``
(``GibbsExactGP``, ``gibbs_map_loss_batched`` and ``GibbsSparseGP``).  A
latent log-lengthscale field at the training inputs (exact) or at M
inducing inputs (sparse) is optimised under MLL + prior log-prob (both ÷N,
GPyTorch convention); prediction conditions the field at new points on the
trained one through the log-normal process's conditional mean.  The sparse
model's MLL is Titsias's collapsed bound on the Nyström root of the Gibbs
kernel (``models/sgpr.py``'s Woodbury algebra); ``gibbs_sparse_sharded_loss``
is the same bound with the training rows split over the ranks of a mesh
(``parallel/sharded_sgpr.py``).

Every parameter may carry a leading split axis: a stacked model holds the K
benchmark splits at once, and every method then works on all of them (the
JAX package's ``vmap`` written out as a batch dimension).

The matrix-free methods (``loss_matrixfree``, ``posterior_matrixfree``,
``posterior_state_matrixfree``, ``posterior_matrixfree_from_state``, with
the hoists ``prior_pre_matrixfree`` and ``precond_factor``) serve one
unbatched model at large N, where no N×N matrix, data Gram or prior Gram,
may exist; ``ChunkedMAPLoss`` (``make_chunked_map_loss``) and the
``chunk_iters`` routes of the posterior are their host-chunked forms, the
JAX package's product surface for N past its TPU's execution wall, here
the same methods with their solves stopped early.  The data term's mBCG matvec is K2
(``ops/matvec.scaled_packed_gibbs_matvec_builder``) and its backward K3
(``packed_gibbs_panel_vjp``) on the card, their plain versions on the CPU;
there is no switch to the panel paths.  The prior's per-dimension solves
are plain torch panels, as in the JAX package, run in float64, a
deliberate departure from its float32 (in float32 they diverge at
N = 16384; ROADMAP §3, F6).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from nonstationary_precip_tpu_torch.kernels.gibbs import gibbs_gram, packed_gibbs_cross
from nonstationary_precip_tpu_torch.kernels.inducing import nystrom_root
from nonstationary_precip_tpu_torch.models.distributions import MVN
from nonstationary_precip_tpu_torch.models.likelihoods import GaussianLikelihood
from nonstationary_precip_tpu_torch.models.sgpr import collapsed_bound_terms, sgpr_predict
from nonstationary_precip_tpu_torch.ops.chol_inv import MAX_N, chol_inv_batched_safe
from nonstationary_precip_tpu_torch.ops.gibbs_fused import gibbs_noisy_chol_alpha
from nonstationary_precip_tpu_torch.ops.lazy_cg import (
    build_precond_factor,
    lazy_cg_mll,
    lazy_cg_posterior,
    lazy_posterior_query,
    lazy_posterior_query_chunked,
    lazy_posterior_state,
    lazy_posterior_state_chunked,
)
from nonstationary_precip_tpu_torch.ops.matvec import packed_gibbs_panel_vjp, scaled_packed_gibbs_matvec_builder
from nonstationary_precip_tpu_torch.ops.linalg import cho_solve, diag_part, safe_cholesky, tri_solve
from nonstationary_precip_tpu_torch.priors.lognormal_process import LogNormalProcess
from nonstationary_precip_tpu_torch.utils.transforms import positive, raw_init


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


class GibbsExactGP(nn.Module):
    """Zero-mean exact GP with scaled diagonal-Gibbs covariance and a
    trainable latent log-lengthscale field at the N training inputs."""

    def __init__(self, prior: LogNormalProcess, likelihood: GaussianLikelihood,
                 raw_outputscale: torch.Tensor, log_ell: torch.Tensor):
        super().__init__()
        self.prior = prior
        self.likelihood = likelihood
        self.raw_outputscale = nn.Parameter(raw_outputscale)
        self.log_ell = nn.Parameter(log_ell)  # (..., N, D)
        self.trainable()

    @classmethod
    def create(cls, x_train, prior: LogNormalProcess, noise=None, outputscale=1.0,
               dtype=torch.float32, device=None):
        return cls(
            prior=prior,
            likelihood=GaussianLikelihood.create(noise, dtype=dtype, device=device),
            raw_outputscale=raw_init(torch.as_tensor(outputscale, dtype=dtype, device=device)),
            log_ell=prior.init_log_field(x_train).to(dtype).clone(),
        )

    @property
    def outputscale(self) -> torch.Tensor:
        return positive(self.raw_outputscale)

    def trainable(self, train_noise: bool = False, train_scale: bool = False) -> "GibbsExactGP":
        """Freeze parameters the way the reference does: the latent field
        always trains, the prior is always frozen, noise and outputscale
        train per flag.  Sets ``requires_grad`` in place; returns self."""
        for p in self.prior.parameters():
            p.requires_grad_(False)
        self.likelihood.raw_noise.requires_grad_(train_noise)
        self.raw_outputscale.requires_grad_(train_scale)
        self.log_ell.requires_grad_(True)
        return self

    # -- objective ----------------------------------------------------------

    def loss(self, x: torch.Tensor, y: torch.Tensor, prior_chols=None) -> torch.Tensor:
        """−(log N(y; 0, s²K_gibbs + σ²I) + prior_logprob) / N, per leading
        batch index.  ``prior_chols`` hoists the frozen prior's Gram algebra:
        ``prior.gram_pre(x)`` or ``prior.gram_chol(x)``.

        An unbatched model (x (N, D), the field (N, D)) takes the JAX
        package's dispatcher ``gibbs_noisy_chol_alpha``: K8 inside its gate on
        the card, else the composed Gram → ``safe_cholesky`` → ``tri_solve``,
        which a batched model always takes."""
        n = y.shape[-1]
        if x.ndim == 2 and self.log_ell.ndim == 2:
            chol, alpha = gibbs_noisy_chol_alpha(x, torch.exp(self.log_ell), y, self.outputscale,
                                                 self.likelihood.noise)
        else:
            chol = safe_cholesky(noisy_gibbs_gram(self, x))
            alpha = tri_solve(chol, y)
        quad = torch.sum(alpha * alpha, dim=-1)
        logdet = 2.0 * torch.sum(torch.log(diag_part(chol)), dim=-1)
        logp = -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))
        prior_term = self.prior.log_prob(x, self.log_ell, prior_chols)
        return -(logp + prior_term) / n

    def prior_pre_matrixfree(self, x, probe_noise, **kw):
        """Hoisted prior state for :meth:`loss_matrixfree`, the matrix-free
        analogue of ``prior.gram_pre(x)``: per-dim preconditioner factors and
        the frozen prior's constant SLQ logdet
        (``LogNormalProcess.gram_pre_lazy``, which ``probe_noise`` and ``kw``
        go to).  Once per fit; O(N·rank) memory."""
        return self.prior.gram_pre_lazy(x, probe_noise, **kw)

    @torch.no_grad()
    def precond_factor(self, x: torch.Tensor, *, rank: int = 150, precond: str = "pivchol",
                       key=None) -> torch.Tensor:
        """(N, rank) preconditioner factor (``precond``: pivoted Cholesky or
        Nyström) of the data Gram at the current pose, for the
        stale-preconditioner hoist: pass it to
        :meth:`loss_matrixfree` as ``precond_lpc`` and refresh it every k
        steps (the estimator is unbiased for any fixed SPD P)."""
        d = x.shape[-1]
        aug = torch.cat([x, self.log_ell], dim=1)
        return build_precond_factor(precond, self.raw_outputscale, aug, min(rank, x.shape[0]),
                                    packed_gibbs_cross(d), key)

    def loss_matrixfree(self, x: torch.Tensor, y: torch.Tensor, probe_noise, prior_pre, *, block: int = 2048,
                        max_iters: Optional[int] = None, tol: float = 1e-6, precond_rank: int = 150,
                        precond_key=None, precond: str = "pivchol", precond_shift: float = 1.0,
                        precond_lpc: Optional[torch.Tensor] = None, prior_max_iters: int = 64,
                        prior_precond_shift: float = 1.0, matvec_precision: str = "highest",
                        include_prior: bool = True, fused_matvec: bool = True, bwd_row_chunks: int = 1,
                        stop_every: int = 0, prior_stop_every: int = 0,
                        info: Optional[dict] = None) -> torch.Tensor:
        """:meth:`loss` for large N, the same MAP estimand with no N×N matrix:
        the data term is ``lazy_cg_mll``'s estimator (mBCG through K2, a
        rank-``precond_rank`` pivoted-Cholesky/Woodbury preconditioner unless
        ``precond_lpc`` is given, the backward through K3), the prior term
        ``log_prob_matrixfree`` against ``prior_pre``
        (:meth:`prior_pre_matrixfree`).  ``probe_noise`` = (u1 (rank, R),
        u2 (N, R)), the normal draws of the R probes.  ``max_iters`` defaults
        to 16 for N ≤ 32768, 32 above.  Gradients reach the field, the raw
        outputscale and the noise (those that require them).
        ``matvec_precision`` is K2's contraction mode ('highest', the
        default; 'vpu', 'high3' or 'default', ``ops/matvec.make_gibbs_matvec``);
        K3's backward is exact f32 whatever it is, as in the JAX package.

        The host-chunked loss (:class:`ChunkedMAPLoss`) is this one with:
        ``include_prior=False`` (the raw MLL ÷ N, ``prior_pre`` unused),
        ``fused_matvec=False`` (the panel paths through
        ``packed_gibbs_cross`` in place of K2 and K3), ``bwd_row_chunks``
        (K3's sweep in row blocks, ``packed_gibbs_panel_vjp(d, rows)``),
        ``stop_every`` / ``prior_stop_every`` (the solves' early stop,
        ``bbmm.mbcg``) and ``info``, a dict that receives the evidence:
        ``mll`` the raw MLL, ``relres_mll`` its (1 + R,) residuals,
        ``relres_prior`` a dim's, ``iters`` the MLL's mBCG iterations,
        ``iters_prior`` the prior's solves' (0 without the prior: one K12
        launch each on the card) and ``relres_max`` the worst."""
        n = y.shape[-1]
        d = x.shape[-1]
        if max_iters is None:
            max_iters = 16 if n <= 32768 else 32
        if bwd_row_chunks > 1 and not fused_matvec:
            raise ValueError("bwd_row_chunks > 1 needs the fused backward (K3's row entry): there is no panel "
                             "row-block sweep")
        aug = torch.cat([x, self.log_ell], dim=1)
        mll_info = {}
        logp = lazy_cg_mll(self.raw_outputscale, aug, y, probe_noise, self.likelihood.noise, block=block,
                           max_iters=max_iters, tol=tol, precond_rank=min(precond_rank, n), precond_key=precond_key,
                           precond=precond, precond_shift=precond_shift, precond_lpc=precond_lpc,
                           cross_fn=packed_gibbs_cross(d),
                           matvec_builder=scaled_packed_gibbs_matvec_builder(d, matvec_precision) if fused_matvec
                           else None,
                           panel_vjp=packed_gibbs_panel_vjp(d, bwd_row_chunks) if fused_matvec else None,
                           stop_every=stop_every, info=mll_info)
        prior_info = {"relres": torch.zeros((d,), dtype=x.dtype, device=x.device), "iters": []}
        prior_term = self.prior.log_prob_matrixfree(x, self.log_ell, prior_pre, block=block,
                                                    max_iters=prior_max_iters, tol=tol,
                                                    precond_shift=prior_precond_shift, stop_every=prior_stop_every,
                                                    info=prior_info) if include_prior else 0.0
        if info is not None:
            worst = torch.max(mll_info["relres"])
            info.update(mll=logp.detach(), relres_mll=mll_info["relres"], relres_prior=prior_info["relres"],
                        iters=mll_info["iters"], iters_prior=sum(prior_info["iters"]),
                        relres_max=torch.maximum(worst, torch.max(prior_info["relres"]).to(worst.dtype)))
        return -(logp + prior_term) / n

    # -- prediction ---------------------------------------------------------

    def posterior(self, x_train, y_train, x_new, *, noiseless: bool = True) -> MVN:
        """Manual GP conditioning as the reference's DiagonalExactGP.predict:
        lengthscales at x_new are the prior's conditional mean given the
        trained field; the covariance gets the reference's +1e-4 I."""
        n = y_train.shape[-1]
        ell1 = torch.exp(self.log_ell)
        s2 = self.outputscale[..., None, None]
        k_xx = s2 * gibbs_gram(x_train, ell1, x_train, ell1)
        ell2 = self.prior.conditional_mean(x_new, (x_train, ell1))
        k_ss = s2 * gibbs_gram(x_new, ell2, x_new, ell2)
        k_sx = s2 * gibbs_gram(x_new, ell2, x_train, ell1)

        noise = self.likelihood.noise[..., None, None]
        chol = safe_cholesky(k_xx + noise * _eye(n, k_xx))
        mu = (k_sx @ cho_solve(chol, y_train)[..., None])[..., 0]
        v = tri_solve(chol, k_sx.mT)
        eye_s = _eye(k_ss.shape[-1], k_ss)
        sigma = k_ss - v.mT @ v + 1e-4 * eye_s
        if not noiseless:
            sigma = sigma + noise * eye_s
        return MVN(mu, sigma)

    def predictive(self, x_train, y_train, x_new) -> MVN:
        return self.posterior(x_train, y_train, x_new, noiseless=False)

    def _stabilised(self, cov: torch.Tensor, noiseless: bool) -> torch.Tensor:
        """cov + 1e-4 I (the reference's stabiliser), + σ²I unless noiseless."""
        eye = _eye(cov.shape[-1], cov)
        cov = cov + 1e-4 * eye
        return cov if noiseless else cov + self.likelihood.noise * eye

    @torch.no_grad()
    def posterior_matrixfree(self, x_train, y_train, x_new, prior_pre, *, noiseless: bool = True,
                             block: int = 2048, max_iters: int = 64, tol: float = 1e-8, precond_rank: int = 150,
                             precond_key=None, precond: str = "pivchol", precond_shift: float = 1.0) -> MVN:
        """:meth:`posterior` for large N, no N×N matrix: the lengthscales at
        ``x_new`` from the prior's matrix-free conditional mean (with
        ``prior_pre``'s factors), then one preconditioned mBCG with 1 + N*
        right-hand sides through K2 (``lazy_cg_posterior``).  Deterministic;
        the reference's +1e-4 I on the covariance.  Not differentiable (the
        fused matvec has no backward); ``max_iters`` is paid in full."""
        d = x_train.shape[-1]
        ell2 = self.prior.conditional_mean_matrixfree(x_new, (x_train, torch.exp(self.log_ell)), prior_pre,
                                                      block=block, max_iters=max_iters, tol=tol)
        aug = torch.cat([x_train, self.log_ell], dim=1)
        aug_new = torch.cat([x_new, torch.log(ell2)], dim=1)
        mean, cov = lazy_cg_posterior(self.raw_outputscale, aug, y_train, aug_new, self.likelihood.noise,
                                      block=block, max_iters=max_iters, tol=tol,
                                      precond_rank=min(precond_rank, y_train.shape[-1]), precond_key=precond_key,
                                      precond=precond, precond_shift=precond_shift, cross_fn=packed_gibbs_cross(d),
                                      matvec_builder=scaled_packed_gibbs_matvec_builder(d))
        return MVN(mean, self._stabilised(cov, noiseless))

    @torch.no_grad()
    def posterior_state_matrixfree(self, x_train, y_train, prior_pre, *, block: int = 2048,
                                   max_iters: Optional[int] = None, tol: float = 1e-8, precond_rank: int = 150,
                                   precond: str = "pivchol", precond_key=None, precond_shift: float = 1.0,
                                   prior_max_iters: int = 64, chunk_iters: Optional[int] = None,
                                   n_chunks: int = 8, prior_info: Optional[dict] = None):
        """Once-per-fit serving state for :meth:`posterior_matrixfree_from_state`:
        α = (K + σ²I)⁻¹y with the rank-``precond_rank`` factor
        (``lazy_posterior_state``, through K2) and the prior's per-dim
        conditioning solves (``conditional_pre_matrixfree``).  Returns
        (state, cond).  ``chunk_iters`` (with ``n_chunks``) runs the α solve
        and the prior's solves host-chunked (``lazy_posterior_state_chunked``:
        at most ``chunk_iters``·``n_chunks`` iterations, stopped early).
        ``prior_info``, a dict, receives the prior's solves' evidence
        (``conditional_pre_matrixfree``'s ``info``)."""
        d = x_train.shape[-1]
        aug = torch.cat([x_train, self.log_ell], dim=1)
        kw = dict(block=block, tol=tol, precond_rank=min(precond_rank, y_train.shape[-1]), precond=precond,
                  precond_key=precond_key, precond_shift=precond_shift, cross_fn=packed_gibbs_cross(d),
                  matvec_builder=scaled_packed_gibbs_matvec_builder(d))
        if chunk_iters is not None:
            st = lazy_posterior_state_chunked(self.raw_outputscale, aug, y_train, self.likelihood.noise,
                                              chunk_iters=chunk_iters, n_chunks=n_chunks, **kw)
        else:
            st = lazy_posterior_state(self.raw_outputscale, aug, y_train, self.likelihood.noise, max_iters=max_iters,
                                      **kw)
        cond = self.prior.conditional_pre_matrixfree((x_train, torch.exp(self.log_ell)), prior_pre, block=block,
                                                     max_iters=prior_max_iters, tol=tol, chunk_iters=chunk_iters,
                                                     info=prior_info)
        return st, cond

    @torch.no_grad()
    def posterior_matrixfree_from_state(self, state, x_new, *, noiseless: bool = True, mean_only: bool = False,
                                        block: int = 2048, max_iters: Optional[int] = None, tol: float = 1e-6,
                                        precond_shift: float = 1.0, return_info: bool = False,
                                        chunk_iters: Optional[int] = None, n_chunks: int = 8):
        """:meth:`posterior_matrixfree` from a prebuilt state: per query batch
        one panel sweep for the lengthscales at ``x_new``, the cross build and
        one contraction for the mean, and, unless ``mean_only``, one
        preconditioned mBCG with N* right-hand sides at the auto budget
        (``lazy_posterior_query``; with ``chunk_iters``, host-chunked at
        most ``chunk_iters``·``n_chunks`` iterations,
        ``lazy_posterior_query_chunked``).  ``mean_only`` returns the (N*,)
        mean.  ``return_info`` appends the query's convergence evidence."""
        st, cond = state
        d = x_new.shape[-1]
        ell2 = self.prior.conditional_mean_from_pre(x_new, (st.x[:, :d], None), cond, block=block)
        aug_new = torch.cat([x_new, torch.log(ell2)], dim=1)
        kw = dict(mean_only=mean_only, block=block, tol=tol, precond_shift=precond_shift,
                  cross_fn=packed_gibbs_cross(d), matvec_builder=scaled_packed_gibbs_matvec_builder(d),
                  return_info=return_info)
        if chunk_iters is not None:
            mean, cov, *info = lazy_posterior_query_chunked(st, aug_new, chunk_iters=chunk_iters, n_chunks=n_chunks,
                                                            **kw)
        else:
            mean, cov, *info = lazy_posterior_query(st, aug_new, max_iters=max_iters, **kw)
        out = mean if mean_only else MVN(mean, self._stabilised(cov, noiseless))
        return (out, info[0]) if return_info else out

    def lengthscale_field(self, x_train, x_new=None) -> torch.Tensor:
        """Trained (or conditionally extended) lengthscale field, (..., N, D)."""
        ell = torch.exp(self.log_ell)
        if x_new is None:
            return ell
        return self.prior.conditional_mean(x_new, (x_train, ell))


# ---------------------------------------------------------------------------
# the host-chunked MAP loss (the JAX package's product surface past its wall)
# ---------------------------------------------------------------------------


_HEADS = ("raw_outputscale", "log_ell", "likelihood.raw_noise")


class ChunkedMAPLoss:
    """Host-chunked :meth:`GibbsExactGP.loss_matrixfree`, the JAX package's
    (``models/gibbs_gp.py:614-695``): that loss with its solves stopped
    early (``loss_kw``, :func:`make_chunked_map_loss`'s budget).
    ``value_and_grad(model, x, y, prior_pre, probe_noise)`` returns
    ``(loss, grads, info)``: ``grads`` by parameter name
    (``train/optim.fit_chunked`` applies them), those of the outputscale,
    the field and the noise whether or not they train, zero for the
    prior's, as JAX's phases give them; ``info`` the evidence
    (``loss_matrixfree``'s)."""

    def __init__(self, loss_kw: dict, include_prior: bool):
        self._kw = loss_kw
        self._include_prior = include_prior

    def value_and_grad(self, model: GibbsExactGP, x, y, prior_pre, probe_noise, pkey=None, early_stop: bool = True):
        """(loss, grads, info) at the model's pose.  ``prior_pre``: the
        hoisted prior state (None without the prior); ``probe_noise``: the
        MLL's probe draws, as ``lazy_cg_mll``'s; ``pkey``: the factor's keyed
        rule, ``loss_matrixfree``'s ``precond_key``."""
        if self._include_prior and prior_pre is None:
            raise ValueError("ChunkedMAPLoss was built with include_prior=True: pass prior_pre "
                             "(GibbsExactGP.prior_pre_matrixfree, hoisted once per fit)")
        kw = dict(self._kw) if early_stop else {**self._kw, "stop_every": 0, "prior_stop_every": 0}
        heads = [model.get_parameter(name) for name in _HEADS]
        trains = [p.requires_grad for p in heads]
        info = {}
        try:
            for p in heads:
                p.requires_grad_(True)
            with torch.enable_grad():
                loss = model.loss_matrixfree(x, y, probe_noise, prior_pre, precond_key=pkey,
                                             include_prior=self._include_prior, info=info, **kw)
                live = dict(zip(_HEADS, torch.autograd.grad(loss, heads)))
        finally:
            for p, t in zip(heads, trains):
                p.requires_grad_(t)
        grads = {name: live.get(name, torch.zeros_like(p)) for name, p in model.named_parameters()}
        return loss.detach(), grads, info


def make_chunked_map_loss(d: int, *, block: int = 2048, chunk_iters: int = 8, n_chunks: int = 4, tol: float = 1e-6,
                          precond_rank: int = 1024, precond: str = "nystrom", precond_shift: float = 10.0,
                          include_prior: bool = True, prior_chunk_iters: int = 8, prior_n_chunks: int = 8,
                          prior_precond_shift: float = 1.0, fused_matvec: bool = True,
                          matvec_precision: str = "highest", bwd_row_chunks: int = 1) -> ChunkedMAPLoss:
    """A :class:`ChunkedMAPLoss` for d-dimensional inputs, with the JAX
    package's defaults: its flagship large-N configuration (Nyström rank
    1024, shift 10, 8-iteration chunks, 4 of them).  ``chunk_iters ×
    n_chunks`` is the MLL's mBCG budget, stopped early every
    ``chunk_iters``; the prior's solves likewise.  ``fused_matvec=True``
    takes K2 (``matvec_precision`` its mode) and K3, their plain versions on
    the CPU; False the panel paths through ``packed_gibbs_cross``.
    ``bwd_row_chunks > 1`` splits K3's sweep into row blocks and needs the
    fused path, as in the JAX package.  ``d`` is JAX's signature's; the
    loss reads it from x."""
    if bwd_row_chunks > 1 and not fused_matvec:
        raise ValueError("bwd_row_chunks > 1 needs the fused backward (K3's row entry): there is no panel "
                         "row-block sweep")
    return ChunkedMAPLoss(dict(block=block, max_iters=chunk_iters * n_chunks, stop_every=chunk_iters, tol=tol,
                               precond_rank=precond_rank, precond=precond, precond_shift=precond_shift,
                               prior_max_iters=prior_chunk_iters * prior_n_chunks,
                               prior_stop_every=prior_chunk_iters, prior_precond_shift=prior_precond_shift,
                               fused_matvec=fused_matvec, matvec_precision=matvec_precision,
                               bwd_row_chunks=bwd_row_chunks), include_prior)


def gibbs_b_eligible(mats: torch.Tensor) -> bool:
    """Shape gate of the batched-(L, L⁻¹) MAP loss, the JAX package's
    ``gibbs_b_eligible``: a (T ≤ 16, 128 ≤ N ≤ 384) stack goes through K1.
    On the card K1 takes float32 only; on the CPU its plain version takes
    any dtype."""
    if mats.ndim != 3:
        return False
    t, n, _ = mats.shape
    dtype_ok = mats.device.type == "cpu" or mats.dtype == torch.float32
    return dtype_ok and t <= 16 and 128 <= n <= MAX_N


def noisy_gibbs_gram(models: GibbsExactGP, x: torch.Tensor) -> torch.Tensor:
    """s²·K_gibbs(x, ℓ) + σ²I at the model's current field, per leading
    batch index: the matrix the MAP loss factors."""
    ell = torch.exp(models.log_ell)
    k = gibbs_gram(x, ell, x, ell)
    return models.outputscale[..., None, None] * k + models.likelihood.noise[..., None, None] * _eye(x.shape[-2], k)


def gibbs_map_loss_batched(models: GibbsExactGP, x, y, prior_pre) -> torch.Tensor:
    """Per-split MAP losses (T,) of a stacked ``GibbsExactGP`` — the
    hand-batched form of the per-split ``loss``.

    For an eligible stack the (L, L⁻¹) pair comes from one K1 launch for all
    splits, and the exported L⁻¹ turns the solves into batched matmuls:
    α = L⁻¹y, and the MLL pullback runs through K1's matmul-only backward.
    Other shapes take the per-split ``loss`` over the split axis."""
    n = y.shape[-1]
    k = noisy_gibbs_gram(models, x)
    if not gibbs_b_eligible(k):
        return models.loss(x, y, prior_pre)
    l, li = chol_inv_batched_safe(k)
    alpha = (li @ y[..., None])[..., 0]
    quad = torch.sum(alpha * alpha, dim=-1)
    logdet = 2.0 * torch.sum(torch.log(diag_part(l)), dim=-1)
    logp = -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))
    prior_term = models.prior.log_prob(x, models.log_ell, prior_pre)
    return -(logp + prior_term) / n


def gibbs_sparse_sharded_loss(mesh):
    """The collapsed bound of an unbatched ``GibbsSparseGP`` with its
    training rows split over ``mesh``'s ranks: M-sized collectives only
    (``parallel/sharded_sgpr.sharded_sgpr_loss``).  Each rank's K_xz and
    the K_zz go through the dispatcher, so they reach K9 wherever its gate
    admits them, as on one device.  The Titsias trace residual follows the
    model's ``scale_correction`` as ``GibbsSparseGP.loss`` does (the Gibbs
    prior diagonal is 1 before scaling).  The latent field's prior term
    depends on the parameters only, so it stays outside the collectives.

    Returns ``loss(model, x_shard, y_shard)``, the same on every rank."""
    from nonstationary_precip_tpu_torch.parallel.sharded_sgpr import sharded_sgpr_loss

    def root_fn(model, x_s):
        return torch.sqrt(model.outputscale) * model._roots(x_s)[0]

    def trace_fn(model, x_s, root):
        q_scaled = torch.sum(root * root, dim=-1)
        if model.scale_correction:
            return model.outputscale - q_scaled  # s²·(1 − q_u)
        return 1.0 - q_scaled / model.outputscale  # the reference's quirk: 1 − q_u

    base = sharded_sgpr_loss(root_fn, trace_fn, mesh)

    def loss(model, x_s, y_s):
        n = y_s.shape[-1] * mesh.size
        return base(model, x_s, y_s) - model.prior.log_prob(model.z, model.log_ell_z) / n

    return loss


class GibbsSparseGP(nn.Module):
    """Sparse (SGPR, Titsias collapsed bound) Gibbs GP with the latent
    log-lengthscale field at M inducing inputs z.

    ``scale_correction=False`` keeps the reference's quirk: the trace term
    is taken on the unscaled base kernel (the Scale wrapper sits outside the
    inducing kernel, so GPyTorch's added-loss harvesting never sees the
    outputscale).  True gives the consistent bound.  Every parameter may
    carry a leading split axis, as ``GibbsExactGP``'s."""

    def __init__(self, prior: LogNormalProcess, likelihood: GaussianLikelihood, raw_outputscale: torch.Tensor,
                 z: torch.Tensor, log_ell_z: torch.Tensor, scale_correction: bool = False):
        super().__init__()
        self.prior = prior
        self.likelihood = likelihood
        self.raw_outputscale = nn.Parameter(raw_outputscale)
        self.z = nn.Parameter(z)  # (..., M, D)
        self.log_ell_z = nn.Parameter(log_ell_z)  # (..., M, D)
        self.scale_correction = scale_correction
        self.trainable()

    @classmethod
    def create(cls, z, prior: LogNormalProcess, noise=None, outputscale=1.0, dtype=torch.float32, device=None):
        z = torch.as_tensor(z, dtype=dtype, device=device).clone()
        return cls(
            prior=prior,
            likelihood=GaussianLikelihood.create(noise, dtype=dtype, device=device),
            raw_outputscale=raw_init(torch.as_tensor(outputscale, dtype=dtype, device=device)),
            z=z,
            log_ell_z=prior.init_log_field(z).to(dtype).clone(),
        )

    @property
    def outputscale(self) -> torch.Tensor:
        return positive(self.raw_outputscale)

    def trainable(self, train_noise: bool = False, train_scale: bool = False,
                  train_z: bool = True) -> "GibbsSparseGP":
        """The latent field always trains, the prior is always frozen; noise,
        outputscale and z per flag.  In place; returns self."""
        for p in self.prior.parameters():
            p.requires_grad_(False)
        self.likelihood.raw_noise.requires_grad_(train_noise)
        self.raw_outputscale.requires_grad_(train_scale)
        self.z.requires_grad_(train_z)
        self.log_ell_z.requires_grad_(True)
        return self

    def _roots(self, x):
        """Nyström root R (..., N, M) of the unscaled Gibbs kernel, and the
        conditioned lengthscales at x.  K_xz and K_zz go through the
        dispatcher, so a split-stacked model's reach K9 as one launch each."""
        ell_z = torch.exp(self.log_ell_z)
        ell_x = self.prior.conditional_mean(x, (self.z, ell_z))
        k_xz = gibbs_gram(x, ell_x, self.z, ell_z)
        k_zz = gibbs_gram(self.z, ell_z, self.z, ell_z)
        root, _ = nystrom_root(k_xz, k_zz)
        return root, ell_x

    # -- objective ----------------------------------------------------------

    def loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """−(log N(y; 0, s²RRᵀ + σ²I) + trace term + prior log-prob)/N, per
        leading batch index, by Woodbury: no N × N matrix."""
        n = y.shape[-1]
        noise = self.likelihood.noise
        s2 = self.outputscale
        root_u, _ = self._roots(x)
        logp, _, _ = collapsed_bound_terms(torch.sqrt(s2)[..., None, None] * root_u, y, noise)
        # Titsias trace term; the Gibbs diagonal is identically 1 (unscaled)
        resid = 1.0 - torch.sum(root_u * root_u, dim=-1)
        if self.scale_correction:
            resid = s2[..., None] * resid
        added = -0.5 * torch.sum(resid, dim=-1) / noise
        prior_term = self.prior.log_prob(self.z, self.log_ell_z)
        return -(logp + added + prior_term) / n

    # -- prediction ---------------------------------------------------------

    def posterior(self, x_train, y_train, x_new, *, noiseless: bool = True) -> MVN:
        """The SGPR predictive (exact marginals, low-rank joint) on the scaled
        roots, with the diagonal correction against s²."""
        s2 = self.outputscale
        s = torch.sqrt(s2)[..., None, None]
        root_x = s * self._roots(x_train)[0]
        root_s = s * self._roots(x_new)[0]
        k_ss_diag = s2[..., None] * torch.ones(root_s.shape[:-1], dtype=root_s.dtype, device=root_s.device)
        return sgpr_predict(root_x, root_s, k_ss_diag, y_train, self.likelihood.noise, noiseless=noiseless)

    def predictive(self, x_train, y_train, x_new) -> MVN:
        return self.posterior(x_train, y_train, x_new, noiseless=False)
