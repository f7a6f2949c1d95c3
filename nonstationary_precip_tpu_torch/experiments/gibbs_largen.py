#!/usr/bin/env python3
"""Large-N matrix-free Gibbs-GP gate: convergence and dense parity.

Counterpart of ``nonstationary_precip_tpu/experiments/gibbs_largen.py``
(RESULTS row ``gibbs_largen_matrixfree_16384``).  On synthetic data it
trains the per-point lengthscale field, the outputscale and the noise of a
Gibbs exact GP by ``--steps`` Adam steps on the matrix-free MLL
(``ops/lazy_cg.lazy_cg_mll``: mBCG with the fused Gram·V, K2, a rank
``--rank`` greedy pivoted-Cholesky preconditioner, 8 probes, and the fused
backward sweep, K3).  At the trained pose it then reports
  * the final mBCG relative residual of the K⁻¹y solve
    (``lazy_cg_diagnostics``), band 1e-2;
  * |loss_lazy − loss_dense| / |loss_dense| against the dense Cholesky
    oracle at the same pose, band 5e-2 (SLQ noise at 8 probes);
  * the cosine between the lazy and dense gradients, asserted ≥ 0.98.

The experiment always passes the fused builder and panel VJP: on the card
they launch K2 and K3, on the CPU they run their plain versions.  The probe
draws (u1, u2) are made once from ``np.random.default_rng(seed)`` unless the
caller passes them, and serve every step and the diagnostics, as the JAX
run reuses one key.

Run: python -m nonstationary_precip_tpu_torch.experiments.gibbs_largen --n 16384 --device cuda
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from nonstationary_precip_tpu_torch.kernels.gibbs import gibbs_gram_reference, packed_gibbs_cross
from nonstationary_precip_tpu_torch.ops import matvec
from nonstationary_precip_tpu_torch.ops.lazy_cg import lazy_cg_diagnostics, lazy_cg_mll
from nonstationary_precip_tpu_torch.ops.linalg import mvn_logpdf_from_chol, safe_cholesky
from nonstationary_precip_tpu_torch.train.config import ExperimentConfig
from nonstationary_precip_tpu_torch.utils.config import device
from nonstationary_precip_tpu_torch.utils.transforms import positive

_D = 2
NUM_PROBES = 8
# row-panel height of the panel paths, as in JAX; the fused builder and
# panel VJP this experiment passes never form panels, so it only has to
# divide N (it is clamped to N first)
BLOCK = 2048


@dataclass
class LargeNConfig(ExperimentConfig):
    n: int = 16384
    steps: int = 20
    rank: int = 150
    iters: int = 0  # 0 = the shipped budget: 16 for N ≤ 32768, 32 above
    seed: int = 173


def _data(n, seed=0):
    """x ~ U(−3, 3)², y = sin(2x₀)·cos(x₁) + 0.1·ε, float32 (JAX :48-56)."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.uniform(-3, 3, size=(n, _D)), dtype=torch.float32)
    y = torch.sin(2 * x[:, 0]) * torch.cos(x[:, 1]) + 0.1 * torch.tensor(rng.normal(size=n), dtype=torch.float32)
    return x, y


def probe_draws(seed: int, rank: int, n: int):
    """The standard normal draws behind the N(0, P) probes: u1 (rank, 8),
    u2 (n, 8), float32."""
    rng = np.random.default_rng(seed)
    u1 = rng.standard_normal((rank, NUM_PROBES)).astype(np.float32)
    return u1, rng.standard_normal((n, NUM_PROBES)).astype(np.float32)


def _f32(a, dev) -> torch.Tensor:
    """A float32 tensor on ``dev`` from a tensor or an array (copied: a
    caller's array may be read-only)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=torch.float32)
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)


def _value_and_grad(f, params: dict):
    val = f(params)
    return val.detach(), torch.autograd.grad(val, list(params.values()))


def loss_dense(p: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The dense Cholesky oracle of the lazy loss at the parameters ``p``
    (``log_ell_pp``, ``raw_s2``, ``log_noise``): −log N(y; 0, s²K + σ²I)/N,
    the Gram built by the plain ``gibbs_gram_reference``, as the JAX
    experiment builds it (no kernel runs in the oracle)."""
    n = y.shape[-1]
    ell = torch.exp(p["log_ell_pp"])
    k = positive(p["raw_s2"]) * gibbs_gram_reference(x, ell, x, ell)
    k = k + torch.exp(p["log_noise"]) * torch.eye(n, dtype=x.dtype, device=x.device)
    return -mvn_logpdf_from_chol(y, torch.zeros_like(y), safe_cholesky(k)) / n


def run(cfg: LargeNConfig, probe_noise=None, data=None) -> dict:
    """The whole gate.  ``probe_noise`` = (u1, u2) and ``data`` = (x, y)
    replace the seeded draws and the synthetic data (a pinned run's, say).
    Returns the per-step losses, the trained parameters, the diagnostics,
    the dense-oracle comparison and the timings."""
    dev = device(cfg.device)
    if dev.type == "cuda":
        matvec.build()  # compile K2/K3 before the timed loop, not inside it
    t_wall = time.perf_counter()
    n, rank = cfg.n, cfg.rank
    iters = cfg.iters or (16 if n <= 32768 else 32)
    x, y = (_f32(a, dev) for a in (data if data is not None else _data(n)))
    noise = tuple(_f32(a, dev) for a in (probe_noise if probe_noise is not None else probe_draws(cfg.seed, rank, n)))
    cross = packed_gibbs_cross(_D)
    builder = matvec.scaled_packed_gibbs_matvec_builder(_D)
    pvjp = matvec.packed_gibbs_panel_vjp(_D)
    kw = dict(block=BLOCK, max_iters=iters, tol=1e-6, precond_rank=rank, cross_fn=cross,
              matvec_builder=builder)

    params = {
        "log_ell_pp": torch.zeros((n, _D), dtype=torch.float32, device=dev, requires_grad=True),
        "raw_s2": torch.tensor(0.5, dtype=torch.float32, device=dev, requires_grad=True),
        "log_noise": torch.tensor(-2.0, dtype=torch.float32, device=dev, requires_grad=True),
    }

    def loss(p):
        aug = torch.cat([x, p["log_ell_pp"]], dim=1)
        return -lazy_cg_mll(p["raw_s2"], aug, y, noise, torch.exp(p["log_noise"]), panel_vjp=pvjp, **kw) / n

    opt = torch.optim.Adam(list(params.values()), lr=cfg.lr)  # optax.adam's defaults
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    vals = []
    for _ in range(cfg.steps):
        opt.zero_grad(set_to_none=True)
        val = loss(params)
        val.backward()
        opt.step()
        vals.append(val.detach())
    losses = torch.stack(vals).cpu().numpy()  # one host read, after the loop
    train_s = time.perf_counter() - t0
    if not np.isfinite(losses).all():
        raise RuntimeError(f"training diverged: losses {losses}")
    print(f"[gibbs_largen] n={n} r{rank}-i{iters}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"over {cfg.steps} steps in {train_s:.2f} s", flush=True)

    with torch.no_grad():
        aug = torch.cat([x, params["log_ell_pp"]], dim=1)
        diag = lazy_cg_diagnostics(params["raw_s2"], aug, y, noise, torch.exp(params["log_noise"]), **kw)
    print(f"[gibbs_largen] trained-pose diagnostics: {diag}", flush=True)

    lv, lg = _value_and_grad(loss, params)
    dv, dg = _value_and_grad(lambda p: loss_dense(p, x, y), params)
    lf = torch.cat([g.reshape(-1) for g in lg]).double()
    df = torch.cat([g.reshape(-1) for g in dg]).double()
    cos = float(torch.dot(lf, df) / (torch.linalg.vector_norm(lf) * torch.linalg.vector_norm(df)))
    rel = float(torch.abs(lv - dv) / torch.abs(dv))
    print(f"[gibbs_largen] dense-oracle parity: loss rel diff {rel:.3e}  grad cosine {cos:.5f}", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t_wall
    if cos < 0.98:
        raise RuntimeError(f"gradient direction drifted from the dense oracle: cosine {cos}")
    if diag["broke"]:
        raise RuntimeError("mBCG flagged breakdown at the trained pose")
    return {
        "losses": losses,
        "params": {k: v.detach().cpu().numpy() for k, v in params.items()},
        "diag": diag,
        "relres_solve": diag["relres_solve"],
        "loss_lazy": float(lv),
        "loss_dense": float(dv),
        "loss_rel_diff": rel,
        "grad_cosine": cos,
        "iters": iters,
        "train_seconds": train_s,
        "wall_seconds": wall_s,
    }


def main(argv=None):
    cfg = LargeNConfig().parse_args(argv)
    out = run(cfg)
    print(f"relres_solve={out['relres_solve']:.3e}  loss_rel_diff={out['loss_rel_diff']:.3e}")
    return out["relres_solve"], out["loss_rel_diff"]


if __name__ == "__main__":
    main()
