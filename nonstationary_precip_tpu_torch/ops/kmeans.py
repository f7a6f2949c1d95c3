"""K-means for inducing-point initialisation.

Counterpart of ``nonstationary_precip_tpu/ops/kmeans.py``: whiten the data
by its per-column (population) deviation, a farthest-point initialisation
from one seed row, ``iters`` Lloyd steps, un-whiten.  The seed row comes
from the caller (``first``), where the JAX function draws it from a key
with ``jax.random.randint``: randomness comes from the caller, as
everywhere in the port.

Ties resolve as in the JAX package: ``argmax`` and ``argmin`` take the
first of equal values, so once every row is a centre (more centres than
distinct rows) the initialisation repeats row 0 of the farthest-point
order, and the duplicated centres stay empty through Lloyd and keep their
place.  The steps are device ops with no host read.
"""

from __future__ import annotations

import torch


def kmeans_inducing_points(first, x: torch.Tensor, num_inducing: int, iters: int = 30) -> torch.Tensor:
    """K-means centroids (num_inducing, D) of x (N, D) for use as inducing
    points, the farthest-point initialisation seeded at row ``first`` (an
    int or a 0-d integer tensor, 0 ≤ first < N)."""
    n, d = x.shape
    std = torch.std(x, dim=0, correction=0) + 1e-12
    xw = x / std
    x_sq = torch.sum(xw**2, dim=-1, keepdim=True)  # (N, 1)

    # farthest-point init: each new centre is the row farthest from every
    # centre so far (the first of equals)
    first = torch.as_tensor(first, device=x.device)
    rows = [first.reshape(())]
    min_d2 = torch.full((n,), float("inf"), dtype=xw.dtype, device=x.device)
    for _ in range(1, num_inducing):
        d2 = torch.sum((xw - xw[rows[-1]]) ** 2, dim=-1)
        min_d2 = torch.minimum(min_d2, d2)
        rows.append(torch.argmax(min_d2))
    centers = xw[torch.stack(rows)]

    for _ in range(iters):
        c_sq = torch.sum(centers**2, dim=-1)[None, :]  # (1, K)
        d2 = x_sq - 2.0 * xw @ centers.T + c_sq  # (N, K)
        assign = torch.argmin(d2, dim=-1)
        onehot = torch.nn.functional.one_hot(assign, num_inducing).to(xw.dtype)  # (N, K)
        counts = torch.sum(onehot, dim=0)
        sums = onehot.T @ xw
        centers = torch.where(counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], centers)
    return centers * std
