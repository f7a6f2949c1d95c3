"""Generic exact GP regression: MLL training and closed-form prediction.

Counterpart of ``nonstationary_precip_tpu/models/exact_gp.py``.  The MLL is
scaled by 1/N (GPyTorch's ``ExactMarginalLogLikelihood``), loss = −mll.

Two solvers are ported:
  * ``solver='chol'``: the dense Gram through ``safe_cholesky``, whose
    dispatch (``ops/linalg.cholesky``) takes K5, the streaming Cholesky, for
    one float32 matrix with 6144 ≤ N ≤ 8192, as on the TPU;
  * ``solver='cg', block=...``: matrix-free (``ops/lazy_cg``), the Gram
    never in memory, with ``matvec_builder`` swapping the panel matvec for
    a fused one (``ops/matvec.stationary_matvec_builder``: K6).  Probe draws
    come from the caller (``probe_noise``, as in ``lazy_cg_mll``), in place
    of the JAX package's key.
The dense ``solver='cg'`` (no ``block``; ``bbmm.cg_mll``) is not ported yet.

Every parameter may carry a leading split axis: a stacked model holds the K
benchmark splits at once, and ``mll``/``posterior`` (chol) then work on all
of them.  The matrix-free solver takes one model.
"""

from __future__ import annotations

import torch
from torch import nn

from nonstationary_precip_tpu_torch.models.distributions import MVN
from nonstationary_precip_tpu_torch.models.likelihoods import GaussianLikelihood
from nonstationary_precip_tpu_torch.ops.lazy_cg import lazy_cg_mll, lazy_cg_posterior
from nonstationary_precip_tpu_torch.ops.linalg import cho_solve, mvn_logpdf_from_chol, safe_cholesky, tri_solve

_DENSE_CG = "solver='cg' without block= (the dense bbmm.cg_mll path) is not yet ported"


def _check_solver(solver: str, block):
    if solver not in ("chol", "cg"):
        raise ValueError(f"solver must be 'chol' or 'cg', got {solver!r}")
    if block is not None and solver != "cg":
        raise ValueError("block= (matrix-free) requires solver='cg'")
    if solver == "cg" and block is None:
        raise NotImplementedError(_DENSE_CG)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


class ExactGP(nn.Module):
    """kernel + Gaussian likelihood (+ a constant mean).  ``mean_type`` is
    'zero' or 'constant'."""

    def __init__(self, kernel: nn.Module, likelihood: GaussianLikelihood, mean_const=None,
                 mean_type: str = "constant"):
        super().__init__()
        if mean_type not in ("zero", "constant"):
            raise ValueError(f"mean_type must be 'zero' or 'constant', got {mean_type!r}")
        self.kernel = kernel
        self.likelihood = likelihood
        self.mean_type = mean_type
        self.mean_const = nn.Parameter(mean_const) if mean_type == "constant" else None

    @classmethod
    def create(cls, kernel, noise: float = None, mean_type: str = "constant", dtype=torch.float32, device=None):
        mc = torch.zeros((), dtype=dtype, device=device) if mean_type == "constant" else None
        return cls(kernel, GaussianLikelihood.create(noise, dtype=dtype, device=device), mc, mean_type)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[-2]
        if self.mean_type == "constant":
            return self.mean_const[..., None].expand(*self.mean_const.shape, n)
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)

    # -- training objective --------------------------------------------------

    def mll(self, x, y, *, solver: str = "chol", probe_noise=None, max_iters: int = 1000, tol: float = 1e-6,
            precond_rank: int = 0, block=None, matvec_builder=None) -> torch.Tensor:
        """log N(y; m, K + σ²I) / N.  ``solver='cg'`` with ``block``
        (matrix-free) needs ``probe_noise``: with ``precond_rank > 0`` the
        standard normal draws (u1 (rank, R), u2 (N, R)) behind the N(0, P)
        probes, else the (N, R) Rademacher probes (``lazy_cg_mll``)."""
        _check_solver(solver, block)
        n = y.shape[-1]
        noise = self.likelihood.noise
        if solver == "cg":
            if probe_noise is None:
                raise ValueError("solver='cg' requires probe_noise")
            return lazy_cg_mll(self.kernel, x, y - self.mean(x), probe_noise, noise, block=block,
                               max_iters=max_iters, tol=tol, precond_rank=precond_rank,
                               matvec_builder=matvec_builder) / n
        k = self.kernel(x)
        chol = safe_cholesky(k + noise[..., None, None] * _eye(n, k))
        return mvn_logpdf_from_chol(y, self.mean(x), chol) / n

    def loss(self, x, y, **solver_kwargs) -> torch.Tensor:
        return -self.mll(x, y, **solver_kwargs)

    # -- prediction ------------------------------------------------------------

    def posterior(self, x_train, y_train, x_test, *, noiseless: bool = True, solver: str = "chol",
                  max_iters: int = 1000, tol: float = 1e-6, precond_rank: int = 0, block=None,
                  matvec_builder=None) -> MVN:
        """The exact posterior p(f* | y) (``noiseless=False`` adds σ²I).
        ``solver='cg'`` with ``block`` solves matrix-free: one mBCG run with
        1 + N* right-hand sides (``lazy_cg_posterior``), no probes."""
        _check_solver(solver, block)
        noise = self.likelihood.noise
        if solver == "cg":
            mean_f, cov = lazy_cg_posterior(self.kernel, x_train, y_train - self.mean(x_train), x_test, noise,
                                            block=block, max_iters=max_iters, tol=tol, precond_rank=precond_rank,
                                            matvec_builder=matvec_builder)
            mean = self.mean(x_test) + mean_f
        else:
            n = y_train.shape[-1]
            k_xx = self.kernel(x_train)
            k_xx = k_xx + noise[..., None, None] * _eye(n, k_xx)
            k_sx = self.kernel(x_test, x_train)
            chol = safe_cholesky(k_xx)
            alpha = cho_solve(chol, y_train - self.mean(x_train))
            mean = self.mean(x_test) + (k_sx @ alpha[..., None])[..., 0]
            v = tri_solve(chol, k_sx.mT)
            cov = self.kernel(x_test) - v.mT @ v
        if not noiseless:
            cov = cov + noise[..., None, None] * _eye(cov.shape[-1], cov)
        return MVN(mean, cov)

    def predictive(self, x_train, y_train, x_test, **solver_kwargs) -> MVN:
        """likelihood(posterior): what the metrics are computed on."""
        return self.posterior(x_train, y_train, x_test, noiseless=False, **solver_kwargs)
