"""Mesh-sharded prediction: test points split over the ranks.

Counterpart of ``nonstationary_precip_tpu/parallel/sharded_predict.py``.
Full-field prediction is embarrassingly parallel over test rows: the
training set is replicated, each rank computes the predictive marginals of
its block of x*, and the blocks are gathered in rank order.
"""

from __future__ import annotations

from typing import Callable

from nonstationary_precip_tpu_torch.parallel.collectives import all_gather
from nonstationary_precip_tpu_torch.parallel.dp import pad_to_multiple
from nonstationary_precip_tpu_torch.parallel.mesh import Mesh


def sharded_marginals(predict_fn: Callable, mesh: Mesh):
    """Wrap ``predict_fn(model, x_test_shard) -> (mean, var)`` into a
    mesh-parallel ``fn(model, x_test) -> (mean, var)``: x_test (held whole
    by every rank) is padded with zero rows to a multiple of the mesh size,
    each rank predicts its block, and every rank gets the whole (mean, var),
    cut back to x_test's length."""

    def fn(model, x_test):
        x_pad, n = pad_to_multiple(x_test, mesh.size)
        mean, var = predict_fn(model, mesh.rows(x_pad))
        return all_gather(mean, mesh)[:n], all_gather(var, mesh)[:n]

    return fn
