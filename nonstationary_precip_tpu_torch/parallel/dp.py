"""Data-parallel ELBO gradients: each rank's shard, one gradient all-reduce.

Counterpart of ``nonstationary_precip_tpu/parallel/dp.py``.  The DSVI
minibatch ELBO is a mean over batch elements plus a KL that depends only
on the (replicated) parameters, so data parallelism is exact: each rank
evaluates the loss on its shard, the global loss is the ``pmean`` of the
shard losses, and each parameter's gradient is summed over the ranks once
(``collectives.call_varying``: the model enters the shard loss through
``pvary``, whose backward is that all-reduce).  Differentiating inside
each rank and all-reducing by hand on top of it would count the gradient
twice, the trap JAX's docstring warns of.

The DSVI noise comes from the caller, as everywhere in the port: each rank
passes its own slice of a (P, …) stack of draws, so a P-rank run and a
one-process replay of its P shards draw the same numbers (JAX folds
``axis_index`` into a key instead).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from nonstationary_precip_tpu_torch.parallel.collectives import call_varying, pmean
from nonstationary_precip_tpu_torch.parallel.mesh import Mesh


def pad_to_multiple(arr: torch.Tensor, multiple: int, axis: int = 0):
    """Pad ``axis`` with zeros to a multiple of ``multiple``; returns
    (padded, true_count)."""
    n = arr.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return arr, n
    widths = [0, 0] * (arr.ndim - 1 - axis % arr.ndim) + [0, pad]
    return F.pad(arr, widths), n


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of each batch array (leading axis split over the
    mesh), on the mesh's device."""
    return tuple(mesh.rows(a).to(mesh.device) for a in arrays)


def dp_value_and_grad(loss_fn: Callable, mesh: Mesh):
    """A mesh-parallel value-and-grad of a mean-over-batch loss.

    ``loss_fn(model, x_shard, y_shard, *rank_args)`` returns the mean loss
    over this rank's shard (parameter-only terms such as the KL already
    carry their global normalisation); ``rank_args`` are this rank's own
    (e.g. its slice of the ε stack).  Returns ``vag(model, x_shard,
    y_shard, *rank_args) -> (loss, grads)``: the global loss, the pmean of
    the shard losses, and the gradients of the model's trainable parameters
    (``model.parameters()`` order), summed over the ranks once.  Both come
    back the same on every rank."""

    def vag(model, x_shard, y_shard, *rank_args):
        params = [p for p in model.parameters() if p.requires_grad]
        with torch.enable_grad():
            loss = pmean(call_varying(loss_fn, model, mesh, x_shard, y_shard, *rank_args), mesh)
            grads = torch.autograd.grad(loss, params)
        return loss.detach(), grads

    return vag
