#!/usr/bin/env python3
"""The exact GP at large N: bench_scaling.py's Gibbs MAP rows and dense
MLL loop, and the matrix-free gate.

The port's counterpart of three JAX entry points, with no new behaviour:
  * ``gibbs_dense`` is ``bench_scaling.py``'s Gibbs MAP rows (:33-88,
    ``gibbs_map_step_ms``), nothing cut: x ~ N(0, 1)² from the first
    1024 × 2, then 1280 × 2 normals of ``default_rng(0)``, y = sin x₀,
    the ``LogNormalProcess(2, mean=log 0.3, outputscale=1, lengthscale=1.3)``
    prior with its Cholesky stack hoisted, ``GibbsExactGP(noise=0.011,
    outputscale=0.644)`` training its latent field only, Adam lr 0.01 × 20;
    then the predictive at a 16 × 16 grid on [−2, 2]², as
    ``examples/quickstart_gibbs_spatial.py`` predicts after its fit (the
    RMSE of the mean against sin x₀ and the joint NLPD).  The loss runs K8
    (``ops/gibbs_fused``), the predictive K9, K10a and K11;
  * ``dense`` is ``bench_scaling.py``'s exact-GP loop (:90-145,
    ``exact_gp_mll_step_ms``): x ~ N(0, 1)² from ``default_rng(0)`` (drawn
    after the Gibbs rows' 1024 and 1280 points, as that script draws them),
    y = sin x₀, ExactGP(Scale(RBF(2))) with zero mean and the default noise,
    Adam lr 0.01 × 20 on the Cholesky MLL, at N ∈ {1024, 2048, 4096, 8192}.
    The N = 8192 row's factorisations run K5 (``ops/chol_stream``);
  * ``lazy`` is ``examples/quickstart_lazy_largen.py``'s model and data
    (x ~ U(−3, 3)² from ``default_rng(3)``, y = sin 2x₀ · cos x₁ + 0.15 ε,
    64 test points, Scale(RBF(2)), noise 0.05, zero mean), trained
    matrix-free through ``stationary_matvec_builder`` (K6): 8 probes, block
    2048, the rank-150 pivoted-Cholesky preconditioner, 32 mBCG
    iterations, 20 Adam steps at lr 0.01, at N = 16384.  At the trained
    pose it reports what the ``gibbs_largen_matrixfree_16384`` gate reads
    (relres of the K⁻¹y solve, the loss against the dense Cholesky oracle
    in float64, the gradient cosine) and the matrix-free predictive mean at
    the 64 test points against the dense posterior's.

Run: python -m nonstationary_precip_tpu_torch.experiments.exact_largen {gibbs,dense,lazy} [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import copy
import time

import numpy as np
import torch

from nonstationary_precip_tpu_torch import interop
from nonstationary_precip_tpu_torch.experiments.gibbs_largen import probe_draws
from nonstationary_precip_tpu_torch.kernels.base import Scale
from nonstationary_precip_tpu_torch.kernels.stationary import RBF
from nonstationary_precip_tpu_torch.models.exact_gp import ExactGP
from nonstationary_precip_tpu_torch.models.gibbs_gp import GibbsExactGP
from nonstationary_precip_tpu_torch.ops.lazy_cg import lazy_cg_diagnostics
from nonstationary_precip_tpu_torch.ops.matvec import stationary_matvec_builder
from nonstationary_precip_tpu_torch.priors.lognormal_process import LogNormalProcess
from nonstationary_precip_tpu_torch.train.metrics import nlpd_joint, rmse_raw
from nonstationary_precip_tpu_torch.train.optim import fit
from nonstationary_precip_tpu_torch.utils.config import device

GIBBS_NS = (1024, 1280)
DENSE_NS = (1024, 2048, 4096, 8192)
GRID = 16  # the Gibbs predictive's grid: GRID × GRID points on [−2, 2]²
NUM_TEST = 64
PROBE_SEED = 173


def _scaling_draws(gibbs_ns=GIBBS_NS, dense_ns=()):
    """The x of ``bench_scaling.py``'s rows, float64, in its draw order from
    one ``default_rng(0)``: ({n: x} of the Gibbs rows, {n: x} of the dense
    rows)."""
    rng = np.random.default_rng(0)
    gibbs = {n: rng.normal(size=(n, 2)) for n in gibbs_ns}
    return gibbs, {n: rng.normal(size=(n, 2)) for n in dense_ns}


def _sine_data(x: np.ndarray, dtype):
    x = torch.tensor(x, dtype=dtype)
    return x, torch.sin(x[:, 0])


def gibbs_data(ns=GIBBS_NS, dtype=torch.float32):
    """{n: (x, y)}, y = sin x₀, at the sizes ``ns``: ``bench_scaling.py``'s
    Gibbs rows at theirs, another size drawn after them from the same
    ``default_rng(0)``."""
    draws = _scaling_draws(GIBBS_NS + tuple(n for n in ns if n not in GIBBS_NS))[0]
    return {n: _sine_data(draws[n], dtype) for n in ns}


def dense_data(ns=DENSE_NS):
    """{n: (x, y)} float32, drawn as ``bench_scaling.py`` draws them, after
    the Gibbs rows' normals."""
    return {n: _sine_data(x, torch.float32) for n, x in _scaling_draws(GIBBS_NS, DENSE_NS)[1].items() if n in ns}


def gibbs_grid(dtype=torch.float32) -> torch.Tensor:
    """The predictive's GRID × GRID points on [−2, 2]², (GRID², 2)."""
    g = np.linspace(-2.0, 2.0, GRID)
    return torch.tensor(np.stack(np.meshgrid(g, g, indexing="ij"), axis=-1).reshape(-1, 2), dtype=dtype)


def gibbs_model(x: torch.Tensor, init=None) -> tuple:
    """(model, the prior's hoisted Cholesky stack): ``bench_scaling.py``'s
    prior and ``GibbsExactGP``, or the JAX model whose leaves ``init`` maps
    (``interop.GIBBS_EXACT_KEYS``), in x's dtype and on its device; only the
    latent field trains."""
    if init is None:
        prior = LogNormalProcess.create(2, mean=float(np.log(0.3)), outputscale=1.0, lengthscale=1.3,
                                        dtype=x.dtype, device=x.device)
        model = GibbsExactGP.create(x, prior, noise=0.011, outputscale=0.644, dtype=x.dtype, device=x.device)
    else:
        model = interop.gibbs_exact_from_jax(init, x.device, x.dtype)
    with torch.no_grad():
        pc = model.prior.gram_chol(x)
    return model, pc


def _gibbs_loss(m, x, y, pc):
    return m.loss(x, y, pc)


def gibbs_predict(model: GibbsExactGP, x, y) -> dict:
    """The predictive at the grid: its mean and variance, the RMSE of the
    mean against sin x₀ and the joint NLPD per point."""
    xq = gibbs_grid(x.dtype).to(x.device)
    yq = torch.sin(xq[:, 0])
    with torch.no_grad():
        pred = model.predictive(x, y, xq)
        rmse, nlpd = rmse_raw(pred.mean, yq), nlpd_joint(pred, yq, 1.0)
    return {"mean": pred.mean, "var": pred.var, "rmse": float(rmse), "nlpd": float(nlpd)}


def gibbs_dense(ns=GIBBS_NS, steps: int = 20, dev: str = "cuda", dtype=torch.float32, init=None) -> dict:
    """The Gibbs rows at each N: {n: {losses, ms_per_step, seconds, rmse,
    nlpd, mean, var, model}}, the step time from the clock of
    ``train/optim.fit`` (CUDA events on the card) over the steps after the
    first.  ``init`` carries a JAX model's leaves in place of the created
    model (the same for every N)."""
    dv = device(dev)
    out = {}
    for n, (x, y) in gibbs_data(ns, dtype).items():
        x, y = x.to(dv), y.to(dv)
        model, pc = gibbs_model(x, init)
        res = fit(model, _gibbs_loss, x, y, pc, lr=0.01, num_steps=steps)
        ms = 1e3 * res.seconds / (res.steps - 1) if res.steps > 1 else float("nan")
        pred = gibbs_predict(model, x, y)
        out[n] = {"losses": res.losses, "ms_per_step": ms, "seconds": res.seconds, "model": model, **pred}
        print(f"[exact_largen gibbs] n={n}: loss {res.losses[0]:.6f} -> {res.losses[-1]:.6f}, {ms:.3f} ms/step; "
              f"RMSE {pred['rmse']:.4f}, NLPD {pred['nlpd']:.4f} on {dv}", flush=True)
    return out


def dense_model(dev=None) -> ExactGP:
    """Scale(RBF(2)), zero mean, the default noise (softplus(0) + 1e-4), float32."""
    return ExactGP.create(Scale.create(RBF.create(2, device=dev), device=dev), mean_type="zero", device=dev)


def _loss(m, x, y):
    return m.loss(x, y)


def dense(ns=DENSE_NS, steps: int = 20, dev: str = "cuda") -> dict:
    """The dense loop at each N: {n: {losses, ms_per_step, seconds}}, the
    step time from the clock of ``train/optim.fit`` (CUDA events on the
    card) over the steps after the first."""
    dv = device(dev)
    out = {}
    for n, (x, y) in dense_data(ns).items():
        x, y = x.to(dv), y.to(dv)
        res = fit(dense_model(dev=dv), _loss, x, y, lr=0.01, num_steps=steps)
        ms = 1e3 * res.seconds / (res.steps - 1) if res.steps > 1 else float("nan")
        out[n] = {"losses": res.losses, "ms_per_step": ms, "seconds": res.seconds}
        print(f"[exact_largen dense] n={n}: loss {res.losses[0]:.6f} -> {res.losses[-1]:.6f}, {ms:.3f} ms/step "
              f"on {dv}", flush=True)
    return out


def lazy_data(n: int):
    """(x, y, x_test) float32, drawn as the quickstart draws them."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.uniform(-3, 3, size=(n, 2)), dtype=torch.float32)
    y = torch.sin(2 * x[:, 0]) * torch.cos(x[:, 1]) + 0.15 * torch.tensor(rng.normal(size=n), dtype=torch.float32)
    xs = torch.tensor(rng.uniform(-3, 3, size=(NUM_TEST, 2)), dtype=torch.float32)
    return x, y, xs


def lazy_model(dev=None) -> ExactGP:
    return ExactGP.create(Scale.create(RBF.create(2, device=dev), device=dev), noise=0.05, mean_type="zero",
                          device=dev)


def _grads(model, loss_fn) -> tuple:
    params = [p for p in model.parameters() if p.requires_grad]
    val = loss_fn(model)
    return val.detach(), torch.autograd.grad(val, params)


def lazy(n: int = 16384, steps: int = 20, rank: int = 150, iters: int = 32, block: int = 2048, lr: float = 0.01,
         dev: str = "cuda", data=None, probe_noise=None) -> dict:
    """The matrix-free run and its gate.  ``data`` = (x, y) and
    ``probe_noise`` = (u1, u2) replace the drawn data and the probe draws
    (a pinned run's); the probes are drawn from ``default_rng(PROBE_SEED)``
    otherwise, and serve every step and the diagnostics."""
    dv = device(dev)
    t_wall = time.perf_counter()
    x, y, xs = lazy_data(n)
    if data is not None:
        x, y = (torch.tensor(np.asarray(a), dtype=torch.float32) for a in data)
    x, y, xs = x.to(dv), y.to(dv), xs.to(dv)
    noise = tuple(torch.tensor(np.asarray(a), dtype=torch.float32, device=dv)
                  for a in (probe_noise if probe_noise is not None else probe_draws(PROBE_SEED, rank, n)))
    kw = dict(solver="cg", block=block, max_iters=iters, precond_rank=rank, matvec_builder=stationary_matvec_builder)
    model = lazy_model(dev=dv)

    def loss(m):
        return m.loss(x, y, probe_noise=noise, **kw)

    res = fit(model, loss, lr=lr, num_steps=steps)
    losses = res.losses
    if not np.isfinite(losses).all():
        raise RuntimeError(f"training diverged: losses {losses}")
    print(f"[exact_largen lazy] n={n} r{rank}-i{iters}: loss {losses[0]:.6f} -> {losses[-1]:.6f} over "
          f"{res.steps} steps, {1e3 * res.seconds / max(res.steps - 1, 1):.3f} ms/step", flush=True)

    with torch.no_grad():
        diag = lazy_cg_diagnostics(model.kernel, x, y - model.mean(x), noise, model.likelihood.noise, block=block,
                                   max_iters=iters, tol=1e-6, precond_rank=rank,
                                   matvec_builder=stationary_matvec_builder)
    lv, lg = _grads(model, loss)
    # the dense Cholesky oracle at the same pose, in float64
    m64 = copy.deepcopy(model).double()
    x64, y64, xs64 = x.double(), y.double(), xs.double()
    dv64, dg = _grads(m64, lambda m: m.loss(x64, y64))
    lf = torch.cat([g.reshape(-1) for g in lg]).double()
    df = torch.cat([g.reshape(-1) for g in dg])
    cos = float(torch.dot(lf, df) / (torch.linalg.vector_norm(lf) * torch.linalg.vector_norm(df)))
    rel = float(torch.abs(lv.double() - dv64) / torch.abs(dv64))
    names = [nm for nm, p in model.named_parameters() if p.requires_grad]
    with torch.no_grad():
        pred = model.predictive(x, y, xs, solver="cg", block=block, max_iters=iters, precond_rank=rank,
                                matvec_builder=stationary_matvec_builder)
        pred64 = m64.predictive(x64, y64, xs64)
    dmean = float(torch.max(torch.abs(pred.mean.double() - pred64.mean)))
    if dv.type == "cuda":
        torch.cuda.synchronize(dv)
    wall_s = time.perf_counter() - t_wall
    print(f"[exact_largen lazy] trained pose: {diag}; loss vs dense {rel:.3e}, grad cosine {cos:.6f}, "
          f"predictive max|Δmean| {dmean:.3e}", flush=True)
    if cos < 0.98:
        raise RuntimeError(f"gradient direction drifted from the dense oracle: cosine {cos}")
    if diag["broke"]:
        raise RuntimeError("mBCG flagged breakdown at the trained pose")
    return {
        "losses": losses, "iters": iters, "diag": diag, "relres_solve": diag["relres_solve"],
        "loss_lazy": float(lv), "loss_dense": float(dv64), "loss_rel_diff": rel, "grad_cosine": cos,
        "grads_lazy": {nm: g.detach().cpu().numpy() for nm, g in zip(names, lg)},
        "grads_dense": {nm: g.detach().cpu().numpy() for nm, g in zip(names, dg)},
        "pred_mean_max_abs_diff": dmean, "train_seconds": res.seconds,
        "ms_per_step": 1e3 * res.seconds / max(res.steps - 1, 1), "wall_seconds": wall_s,
        "params": {nm: p.detach().cpu().numpy() for nm, p in model.named_parameters()}, "model": model,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("which", choices=("gibbs", "dense", "lazy"))
    ap.add_argument("--n", type=int, default=16384, help="lazy: N")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.which == "gibbs":
        return gibbs_dense(steps=args.steps, dev=args.device)
    if args.which == "dense":
        return dense(steps=args.steps, dev=args.device)
    out = lazy(n=args.n, steps=args.steps, dev=args.device)
    print(f"relres_solve={out['relres_solve']:.3e}  loss_rel_diff={out['loss_rel_diff']:.3e}  "
          f"grad_cosine={out['grad_cosine']:.6f}")
    return out


if __name__ == "__main__":
    main()
