"""Row-sharded SGPR: the Titsias collapsed bound over a mesh of ranks.

Counterpart of ``nonstationary_precip_tpu/parallel/sharded_sgpr.py``, the
scaling path of the sparse models past one device's memory.  The N
training rows are split over the ranks, and every cross-rank quantity of
the collapsed bound is an M-sized reduction:

    A Aᵀ = Σ_ranks A_s A_sᵀ   (M × M psum)
    A y  = Σ_ranks A_s y_s    (M psum)
    yᵀy, Σ trace residuals     (scalar psums)

so K_zz work is replicated and K_xz rows never leave their rank.  Each
rank's share (A_s A_sᵀ, A_s y_s, its trace residual) is computed from the
model through ``collectives.call_varying``, so the parameters' gradients
from the shares are summed over the ranks once; the replicated algebra
after the psums (the M × M Cholesky, σ² in the quadratic and the logdet)
gives every rank the same gradient, which is not summed.  The per-shard
math is the caller's ``root_fn`` and ``trace_fn``, so this works for any
kernel (stationary SGPR and the Gibbs variant alike).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from nonstationary_precip_tpu_torch.parallel.collectives import call_varying, psum
from nonstationary_precip_tpu_torch.parallel.mesh import Mesh


def sharded_sgpr_loss(root_fn: Callable, trace_fn: Callable, mesh: Mesh):
    """Build ``loss(model, x_shard, y_shard)`` = −(collapsed bound)/N with
    this rank's rows of x and y.

    ``root_fn(model, x_shard) -> (N_s, M)``: the Nyström root
    R_s = K_{x_s z} L_zz⁻ᵀ of the scaled kernel.
    ``trace_fn(model, x_shard, root_shard) -> (N_s,)``: the Titsias trace
    residual (prior diag minus Nyström diag, in whichever scaling the
    model's bound uses); the loss adds −½·Σ(residual)/σ².  The value and its
    gradients are the same on every rank."""

    def share(model, x_s, y_s):
        noise = model.likelihood.noise
        root = root_fn(model, x_s)
        a_s = root.mT / torch.sqrt(noise)  # (M, N_s)
        added = -0.5 * torch.sum(trace_fn(model, x_s, root)) / noise
        return a_s @ a_s.mT, a_s @ y_s, added

    def loss(model, x_s, y_s):
        aat_s, ay_s, added_s = call_varying(share, model, mesh, x_s, y_s)
        noise = model.likelihood.noise
        aat = psum(aat_s, mesh)
        ay = psum(ay_s, mesh) / torch.sqrt(noise)
        yty = psum(y_s @ y_s, mesh)
        n_total = psum(torch.tensor(float(y_s.shape[-1]), dtype=y_s.dtype, device=y_s.device), mesh)
        added = psum(added_s, mesh)

        b = torch.eye(aat.shape[-1], dtype=aat.dtype, device=aat.device) + aat
        lb = torch.linalg.cholesky(b)
        w = torch.linalg.solve_triangular(lb, ay[:, None], upper=False)[:, 0]
        quad = yty / noise - w @ w
        logdet = n_total * torch.log(noise) + 2.0 * torch.sum(torch.log(torch.diagonal(lb)))
        logp = -0.5 * (quad + logdet + n_total * math.log(2.0 * math.pi))
        return -(logp + added) / n_total

    return loss


def sharded_sgpr_value_and_grad(root_fn: Callable, trace_fn: Callable, mesh: Mesh):
    """``vag(model, x_shard, y_shard) -> (loss, grads)`` of
    :func:`sharded_sgpr_loss`, the gradients those of the model's trainable
    parameters in ``model.parameters()`` order, the same on every rank."""
    loss_fn = sharded_sgpr_loss(root_fn, trace_fn, mesh)

    def vag(model, x_s, y_s):
        params = [p for p in model.parameters() if p.requires_grad]
        with torch.enable_grad():
            loss = loss_fn(model, x_s, y_s)
            grads = torch.autograd.grad(loss, params)
        return loss.detach(), grads

    return vag
