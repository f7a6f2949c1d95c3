#!/usr/bin/env python3
"""Quickstart: data-parallel DSVI over a group of ranks.

Counterpart of ``examples/quickstart_dataparallel.py``.  The DSVI ELBO is a
mean over minibatch elements plus a parameter-only KL, so data parallelism
is exact: each rank takes its shard of the batch, evaluates the loss there,
and each gradient is summed over the ranks once
(``parallel.dp.dp_value_and_grad``).  Five Adam steps on a 2-layer deep GP
(M = 32, S = 3), then the parity the JAX example asserts: the sharded loss
against a one-process replay of the P shards with the same ε.  The ε of
each rank is its slice of one (P, S, O, B/P) stack drawn from a numpy seed,
where the JAX example folds the rank into a key.  On the card each step
runs K4 (the layers' precompute) and K7 (the fused data term, forward and
backward) on each rank.

By default it runs on every card (one NCCL rank each); ``--device cpu
--world P`` spawns P gloo processes (JAX's 8 virtual CPU devices).  Called
from a process that already belongs to a group, it runs on that group
(``chip_smoke.py --world 4`` runs it so on four cards over NCCL).

Run: python -m nonstationary_precip_tpu_torch.examples.quickstart_dataparallel [--device cpu --world 4]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from nonstationary_precip_tpu_torch.experiments.deepgp_spatial import draw_eps
from nonstationary_precip_tpu_torch.models.deep_gp import DeepGP
from nonstationary_precip_tpu_torch.parallel.dp import dp_value_and_grad, shard_batch
from nonstationary_precip_tpu_torch.parallel.launch import run_ranks
from nonstationary_precip_tpu_torch.parallel.mesh import make_mesh

SEED, SAMPLES, M = 173, 3, 32


def data(n: int):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 2)).astype(np.float32)
    return x, (np.sin(x[:, 0]) + 0.1 * x[:, 1]).astype(np.float32)


def rank_main(n: int = 512, steps: int = 5) -> dict:
    """One rank's run, on the group this process belongs to."""
    mesh = make_mesh()
    dev, p = mesh.device, mesh.size
    if n % p:
        raise ValueError(f"quickstart_dataparallel: the batch {n} must divide over {p} ranks")
    lead = mesh.rank == 0
    if lead:
        print(f"mesh: {p} × {dev.type}")
    x, y = (torch.tensor(a, device=dev) for a in data(n))
    model = DeepGP.create(torch.Generator().manual_seed(SEED), input_dims=2, num_layers=2, num_inducing=M, device=dev)
    stack = draw_eps(np.random.default_rng(SEED), (p, SAMPLES), 2, n // p)  # per layer (P, S, O, B/P)
    eps = [torch.tensor(e[mesh.rank], device=dev) for e in stack]

    def loss_fn(m, xb, yb, e):
        return m.loss(xb, yb, num_data=n, eps=e)

    vag = dp_value_and_grad(loss_fn, mesh)
    xs, ys = shard_batch(mesh, x, y)
    params = [q for q in model.parameters() if q.requires_grad]
    opt = torch.optim.Adam(params, lr=0.01, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for step in range(steps):
        loss, grads = vag(model, xs, ys, eps)
        for q, g in zip(params, grads):
            q.grad = g
        opt.step()
        losses.append(float(loss))
        if lead:
            print(f"step {step}: loss {losses[-1]:.4f}")

    # parity: the sharded loss against the mean of the P shard losses,
    # replayed one shard at a time with the same ε
    b = n // p
    with torch.no_grad():
        per = [float(model.loss(x[s * b:(s + 1) * b], y[s * b:(s + 1) * b], num_data=n,
                                eps=[torch.tensor(e[s], device=dev) for e in stack])) for s in range(p)]
    ref = float(np.mean(per))
    got = float(vag(model, xs, ys, eps)[0])
    assert abs(ref - got) < 1e-4 * max(1.0, abs(ref)), (ref, got)
    if lead:
        print(f"sharded loss matches 1-device replay: {got:.6f} vs {ref:.6f}")
        print("ok")
    return {"losses": losses, "got": got, "ref": ref, "world": p}


def main(world=None, dev="cuda", n: int = 512, steps: int = 5) -> dict:
    """Rank 0's result: on the caller's group, or on ``world`` spawned ranks
    (default: every card)."""
    return run_ranks("nonstationary_precip_tpu_torch.examples.quickstart_dataparallel:rank_main", world, dev,
                     (n, steps))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=None, help="ranks to spawn (default: every card; 1 on the CPU)")
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    main(args.world, args.device, args.n, args.steps)
