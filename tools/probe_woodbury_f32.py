#!/usr/bin/env python3
"""Where the float32 Woodbury apply loses the training solve at the JAX
flagship's N = 1,048,576, and what its repairs cost on the default path.

Part A, at ``--n`` rows (default 1,048,576) and the init pose of
``chip_smoke.py --octave``'s (i) (``tools/probe_chunked.py``'s data, log ℓ 0,
log σ² −2, Nyström rank 1024, shift 10, c = 10σ²): for each landmark set
(``torch``: the first 1024 of ``torch.Generator`` 17's permutation, as (i)
draws them; and each ``--landmarks`` file, e.g. JAX's own
``permutation(PRNGKey(17), n)[:1024]``) the kept Nyström directions,
λmax(LᵀL) in float64 and the margin ε₃₂·(λmax + c)/c.  For the ``torch``
set, P⁻¹V = (V − L(cI + LᵀL)⁻¹LᵀV)/c on V = [y, the 8 N(0, P) probes] is
computed in float32 with one stage at a time taken to float64:
  * ``f32``: every stage float32 (the JAX package's ``_woodbury``);
  * ``gram64``: G = LᵀL summed in float64, rounded to float32;
  * ``ltv64``: b = LᵀV summed in float64, rounded to float32;
  * ``solve64``: the k × k Cholesky and its solve in float64;
  * ``sub64``: V − L·y in float64 (y from float32 stages);
  * ``blocked32``: G and b as float32 sums of 64 row blocks' products;
  * ``f64``: all of it in float64 (:func:`woodbury_f64`);
each against ``f64``, and the training solve's relres and iterations with
that apply (``lazy_cg_diagnostics``: 32 iterations, tol 1e-6, K2 as the
matvec); ``f32`` and ``f64`` also with each ``--landmarks`` set.  The times
of one ``f32`` and one ``f64`` apply (CUDA events, interleaved).

Part B, at ``--gibbs_n`` (default 16384, ``chip_smoke.py``'s ``gibbs_mf``):
the quickstart's hoist, a training step (forward and backward, the mean of
``--reps``) and the serving state under each Woodbury of ``--modes`` in
turn, then again in the reverse order: ``gram64`` (:func:`woodbury_gram64`),
``f32`` (the JAX package's formula), ``f64`` (:func:`woodbury_f64`, the
apply ``ops/bbmm.woodbury_precond`` makes).

One JSON line a reading; the whole as ``chiprun_out/probe_woodbury_f32_<parts>.json``.

    python tools/probe_woodbury_f32.py [--landmarks jax=FILE.npy ...] [--parts ab]
    python tools/probe_woodbury_f32.py --device cpu --n 8192 --gibbs_n 1024   # a rehearsal

A landmark file holds (1024,) int64 row indices; JAX's come from
``numpy.save(FILE, jax.random.permutation(jax.random.PRNGKey(17), n)[:1024])``
run on the CPU (the permutation depends on ``jax_threefry_partitionable``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from nonstationary_precip_tpu_torch.examples import quickstart_gibbs_largen as qs  # noqa: E402
from nonstationary_precip_tpu_torch.kernels.gibbs import packed_gibbs_cross  # noqa: E402
from nonstationary_precip_tpu_torch.models import exact_gp  # noqa: E402
from nonstationary_precip_tpu_torch.ops import bbmm, lazy_cg, matvec  # noqa: E402
from nonstationary_precip_tpu_torch.priors import lognormal_process  # noqa: E402

RANK, SHIFT, PROBES, BLOCK, ITERS = 1024, 10.0, 8, 2048, 32
EPS32 = float(np.finfo(np.float32).eps)
#: the modules that call woodbury_precond by its own name
USERS = (bbmm, lazy_cg, exact_gp, lognormal_process)
WOODBURY = bbmm.woodbury_precond


def woodbury_gram64(l, sigma2):
    """The float32 apply on LᵀL summed in float64 and rounded (``gram64``);
    float64 operands by the plain formula."""
    if l.dtype == torch.float64:
        return woodbury_f32(l, sigma2)
    g = (l.double().T @ l.double()).to(l.dtype)
    cf = torch.linalg.cholesky(sigma2 * torch.eye(l.shape[-1], dtype=l.dtype, device=l.device) + g)
    return lambda v: (v - l @ torch.cholesky_solve(l.T @ v, cf)) / sigma2


def woodbury_f64(l, sigma2):
    """The apply in float64 whatever the operands' dtype, the result in v's."""
    l64 = l.double()
    s2 = torch.as_tensor(sigma2, dtype=torch.float64, device=l.device)
    cf = torch.linalg.cholesky(s2 * torch.eye(l.shape[-1], dtype=torch.float64, device=l.device) + l64.T @ l64)
    return lambda v: ((v.double() - l64 @ torch.cholesky_solve(l64.T @ v.double(), cf)) / s2).to(v.dtype)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def emit(out: dict, key: str, **row):
    out[key] = row
    print(json.dumps({"reading": key, **row}), flush=True)


def woodbury_f32(l, sigma2):
    """The JAX package's ``_woodbury`` (lazy_cg.py:129): every stage in l's dtype."""
    cf = torch.linalg.cholesky(sigma2 * torch.eye(l.shape[-1], dtype=l.dtype, device=l.device) + l.T @ l)
    return lambda v: (v - l @ torch.cholesky_solve(l.T @ v, cf)) / sigma2


def woodbury_stage(l, c, mode: str):
    """The float32 apply with the stage ``mode`` names in float64 (module doc)."""
    l64 = l.double()
    c32, c64 = torch.tensor(c, dtype=torch.float32, device=l.device), torch.tensor(c, dtype=torch.float64,
                                                                                  device=l.device)
    blocks = l.shape[0] // 64

    def tsum(a, b):  # aᵀb
        if mode == "blocked32":
            return sum(a[i:i + blocks].T @ b[i:i + blocks] for i in range(0, a.shape[0], blocks))
        return a.T @ b

    g = (l64.T @ l64).float() if mode == "gram64" else tsum(l, l)
    eye = torch.eye(l.shape[1], dtype=torch.float64, device=l.device)
    cf = torch.linalg.cholesky(c64 * eye + g.double()) if mode == "solve64" else torch.linalg.cholesky(
        c32 * eye.float() + g)

    def apply(v):
        b = (l64.T @ v.double()).float() if mode == "ltv64" else tsum(l, v)
        y = torch.cholesky_solve(b.double(), cf).float() if mode == "solve64" else torch.cholesky_solve(b, cf)
        if mode == "sub64":
            return ((v.double() - l64 @ y.double()) / c64).float()
        return (v - l @ y) / c32

    return apply


def swap(factory):
    for mod in USERS:
        mod.woodbury_precond = factory


def part_a(args, dev, out):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.uniform(-3, 3, size=(args.n, 2)), dtype=torch.float32, device=dev)
    eps = torch.tensor(rng.normal(size=args.n), dtype=torch.float32, device=dev)
    y = torch.sin(2 * x[:, 0]) * torch.cos(x[:, 1]) + 0.1 * eps
    aug = torch.cat([x, torch.zeros_like(x)], dim=1)
    s2 = torch.exp(torch.tensor(-2.0, device=dev))
    c = SHIFT * float(s2)
    prng = np.random.default_rng(5)
    u = tuple(torch.tensor(prng.standard_normal(s), dtype=torch.float32, device=dev)
              for s in ((RANK, PROBES), (args.n, PROBES)))
    cross = packed_gibbs_cross(2)
    sets = {"torch": torch.Generator().manual_seed(17)}
    for spec in args.landmarks:
        name, path = spec.split("=", 1)
        sets[name] = np.load(path)

    def solve(lpc, factory):
        swap(factory)
        try:
            t0 = time.perf_counter()
            d = lazy_cg.lazy_cg_diagnostics(None, aug, y, u, s2, block=BLOCK, max_iters=ITERS, tol=1e-6,
                                            precond_lpc=lpc, precond_shift=SHIFT, cross_fn=cross,
                                            matvec_builder=matvec.packed_gibbs_matvec_builder(2))
            sync(dev)
            return {**d, "seconds": time.perf_counter() - t0}
        finally:
            swap(WOODBURY)

    for name, key in sets.items():
        lpc = lazy_cg.build_precond_factor("nystrom", None, aug, RANK, cross, key)
        l64 = lpc.double()
        lam = torch.linalg.eigvalsh(l64.T @ l64)
        lmax = float(lam[-1])
        emit(out, f"factor_{name}", kept=int((lpc.abs().amax(0) > 0).sum()), lambda_max_ltl=lmax, c=c,
             margin=EPS32 * (lmax + c) / c)
        del l64
        modes = ("f32", "gram64", "ltv64", "solve64", "sub64", "blocked32") if name == "torch" else ("f32",)
        v = torch.cat([y[:, None], bbmm.sample_precond_probes(lpc, c, *u)], dim=1)
        ref = woodbury_f64(lpc, c)(v).double()
        for mode in modes:
            got = woodbury_stage(lpc, c, mode)(v).double()
            row = {"landmarks": name, "mode": mode,
                   "rel_err": float((got - ref).norm() / ref.norm()),
                   "rel_err_cols": ((got - ref).norm(dim=0) / ref.norm(dim=0)).tolist()}
            if mode in ("f32",) or args.all_solves:
                row["solve"] = solve(lpc, lambda l, s, m=mode: woodbury_stage(l, float(s), m))
            emit(out, f"apply_{name}_{mode}", **row)
        if name == "torch":
            emit(out, f"apply_{name}_f64", landmarks=name, mode="f64", solve=solve(lpc, woodbury_f64))
        if name == "torch" and dev.type == "cuda":
            times = {"f32": [], "f64": []}
            fns = {"f32": woodbury_f32(lpc, torch.tensor(c, device=dev)), "f64": woodbury_f64(lpc, c)}
            for mode in ("f32", "f64", "f64", "f32") * 3:
                fns[mode](v)
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                fns[mode](v)
                b.record()
                torch.cuda.synchronize()
                times[mode].append(a.elapsed_time(b))
            setup = {}
            for mode, fac in (("f32", lambda: woodbury_f32(lpc, torch.tensor(c, device=dev))),
                              ("f64", lambda: woodbury_f64(lpc, c))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fac()
                torch.cuda.synchronize()
                setup[mode] = 1e3 * (time.perf_counter() - t0)
            emit(out, "apply_ms", n=args.n, r=v.shape[1], rank=RANK, ms=times,
                 median={k: float(np.median(t)) for k, t in times.items()}, setup_ms=setup)
        del lpc, v, ref
        torch.cuda.empty_cache()


def part_b(args, dev, out):
    n = args.gibbs_n
    x, y, _ = (qs._t(a, dev) for a in qs.problem(n))
    rng = np.random.default_rng(qs.PROBE_SEED)
    prior_noise = [tuple(qs._t(a, dev) for a in qs.probe_draws(rng, 50, n, qs.SLQ_PROBES)) for _ in range(2)]
    noise = tuple(qs._t(a, dev) for a in qs.probe_draws(rng, 150, n, qs.NUM_PROBES))
    model = qs.build_model(x)
    kw = {"block": BLOCK, "max_iters": qs.PRIOR_ITERS}

    def timed(fn):
        sync(dev)
        t0 = time.perf_counter()
        r = fn()
        sync(dev)
        return r, 1e3 * (time.perf_counter() - t0)

    rows = []
    factories = {"gram64": woodbury_gram64, "f32": woodbury_f32, "f64": woodbury_f64}
    for mode in args.modes + args.modes[::-1]:
        swap(factories[mode])
        try:
            pre, hoist_ms = timed(lambda: model.prior_pre_matrixfree(x, prior_noise, rank=50, tol=1e-8, **kw))
            lpc = model.precond_factor(x, rank=150)

            def step():
                model.loss_matrixfree(x, y, noise, pre, block=BLOCK, max_iters=qs.ITERS, tol=1e-6,
                                      precond_lpc=lpc, prior_max_iters=qs.PRIOR_ITERS).backward()

            step()
            steps = [timed(step)[1] for _ in range(args.reps)]
            _, state_ms = timed(lambda: model.posterior_state_matrixfree(x, y, pre, tol=1e-8, precond_rank=150,
                                                                          **kw))
            model.zero_grad(set_to_none=True)
        finally:
            swap(WOODBURY)
        rows.append({"woodbury": mode, "hoist_ms": hoist_ms, "step_ms": float(np.mean(steps)), "steps_ms": steps,
                     "state_ms": state_ms})
        print(json.dumps({"reading": "gibbs_mf", **rows[-1]}), flush=True)
    out["gibbs_mf"] = {"n": n, "rows": rows}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--gibbs_n", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--landmarks", action="append", default=[], help="name=FILE.npy, (1024,) row indices")
    ap.add_argument("--all_solves", action="store_true", help="the training solve with every stage's apply")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--parts", default="ab", help="a: the 1M init pose; b: the gibbs_mf step")
    ap.add_argument("--modes", nargs="+", default=["gram64", "f32", "f64"], help="part B's Woodbury applies")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        matvec.build()
    out = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu", "torch": torch.__version__}
    if "b" in args.parts:
        part_b(args, dev, out)
    if "a" in args.parts:
        part_a(args, dev, out)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / f"probe_woodbury_f32_{args.parts}.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
