"""Generic SGPR: Titsias (2009) collapsed-bound sparse GP regression.

Counterpart of ``nonstationary_precip_tpu/models/sgpr.py``, kernel-agnostic:
everything is Woodbury on the (N, M) Nyström root (no N × N matrix), with
the trace term added to the objective as GPyTorch's
``InducingPointKernelAddedLossTerm`` does.  Trainability is
``requires_grad``: ``trainable(train_z)`` freezes or frees the inducing
inputs, every other parameter trains.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from nonstationary_precip_tpu_torch.kernels.inducing import nystrom_root
from nonstationary_precip_tpu_torch.models.distributions import MVN
from nonstationary_precip_tpu_torch.models.likelihoods import GaussianLikelihood
from nonstationary_precip_tpu_torch.ops.linalg import cho_solve, diag_part, safe_cholesky, tri_solve


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def collapsed_bound_terms(root: torch.Tensor, y: torch.Tensor, noise):
    """(log N(y; 0, RRᵀ + σ²I), chol(B), A) via Woodbury, A = Rᵀ/σ and
    B = I + AAᵀ: root (..., N, M), y (..., N), noise (...,)."""
    n = y.shape[-1]
    sn = torch.sqrt(noise)[..., None, None]
    a = root.mT / sn  # (..., M, N)
    lb = safe_cholesky(_eye(a.shape[-2], a) + a @ a.mT)
    ay = (a @ y[..., None])[..., 0] / sn[..., 0]
    w = tri_solve(lb, ay)
    quad = torch.sum(y * y, dim=-1) / noise - torch.sum(w * w, dim=-1)
    logdet = n * torch.log(noise) + 2.0 * torch.sum(torch.log(diag_part(lb)), dim=-1)
    logp = -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))
    return logp, lb, a


def sgpr_predict(root_x, root_s, k_ss_diag, y, noise, *, noiseless: bool = True) -> MVN:
    """The SGPR predictive from the train and test Nyström roots: a low-rank
    joint with exact marginals (the diagonal correction)."""
    sn = torch.sqrt(noise)[..., None, None]
    a = root_x.mT / sn
    lb = safe_cholesky(_eye(a.shape[-2], a) + a @ a.mT)
    ay = (a @ y[..., None])[..., 0] / sn[..., 0]
    mean = (root_s @ cho_solve(lb, ay)[..., None])[..., 0]
    v = tri_solve(lb, root_s.mT)
    cov = v.mT @ v
    corr = torch.clamp(k_ss_diag - torch.sum(root_s * root_s, dim=-1), min=0.0)
    cov = cov + torch.diag_embed(corr)
    if not noiseless:
        cov = cov + noise[..., None, None] * _eye(cov.shape[-1], cov)
    return MVN(mean, cov)


class SGPR(nn.Module):
    """Sparse GP regression with a stationary (or any parametric) kernel and
    M inducing inputs z (M, D)."""

    def __init__(self, kernel: nn.Module, likelihood: GaussianLikelihood, z: torch.Tensor):
        super().__init__()
        self.kernel = kernel
        self.likelihood = likelihood
        self.z = nn.Parameter(z)

    @classmethod
    def create(cls, kernel, z, noise=None, dtype=torch.float32, device=None):
        return cls(kernel, GaussianLikelihood.create(noise, dtype=dtype, device=device),
                   torch.as_tensor(z, dtype=dtype, device=device).clone())

    def trainable(self, train_z: bool = True) -> "SGPR":
        """Every parameter trains; z per ``train_z``.  In place; returns self."""
        for p in self.parameters():
            p.requires_grad_(True)
        self.z.requires_grad_(train_z)
        return self

    def _root(self, x):
        root, _ = nystrom_root(self.kernel(x, self.z), self.kernel(self.z))
        return root

    def loss(self, x, y) -> torch.Tensor:
        """−(collapsed bound)/N: log N(y; 0, Q + σ²I) − ½Σ(diag K − diag Q)/σ²."""
        n = y.shape[-1]
        noise = self.likelihood.noise
        root = self._root(x)
        logp, _, _ = collapsed_bound_terms(root, y, noise)
        k_diag = self.kernel.diag(x)
        q_diag = torch.sum(root * root, dim=-1)
        added = -0.5 * torch.sum(k_diag - q_diag, dim=-1) / noise
        return -(logp + added) / n

    def posterior(self, x_train, y_train, x_new, *, noiseless: bool = True) -> MVN:
        return sgpr_predict(self._root(x_train), self._root(x_new), self.kernel.diag(x_new), y_train,
                            self.likelihood.noise, noiseless=noiseless)

    def predictive(self, x_train, y_train, x_new) -> MVN:
        return self.posterior(x_train, y_train, x_new, noiseless=False)
