"""Second witnesses for the float32 readings of the sparse and spatio-temporal
models: where a run on the card parts from another run of the same model.

``--only gibbs``: the sparse Gibbs slice's 20 pinned steps
(tests/fixtures/jax_sparse_ref.npz, from tools/pin_jax_sparse.py) in the
port, from JAX's z, with z training and with z frozen, in float32 and
float64 on the card and in float32 on the host's CPU.  Per step: each run's
largest relative distance from the JAX run of its dtype, and the jitter
every ``safe_cholesky`` member took (the Nyström root's K_zz, B = I + AAᵀ
and the prior's Gram, sorted by ``classify_jitter``) beside the jitter
JAX's members took.

``--only sgpr``: ``sgpr_bench``'s fit (M = 1900, N = 4540, Adam lr 0.05, the
loop of ``train.optim.fit``) for 1000 iterations in float32 and float64 on
the card and in float32 on the host's CPU (as many steps as
``--cpu-seconds`` allows): test RMSE and NLPD at 100, 250, 500, 750 and
1000 iterations, the jitter each step's ``safe_cholesky`` calls took (the
first is L_zz's, the second B's), and the first step at each jitter of
L_zz's ladder.

``--only st_dgp``: ``spatiotemporal_dgp`` on the card as shipped, with K4's
call replaced by its plain version, in float64 (K4 takes float32 only, so
its plain version), and in float32 and float64 on the host's CPU; then
four other draw seeds (init and ε) on the card and on the CPU.  Per run:
RMSE, NLPD, and the first step at which its loss trace parts from the
shipped run's by more than 1e-6, 1e-4 and 1e-2 (relative).

Prints one JSON line a section and writes them all to
chiprun_out/witness_sparse.json.  Run from the repository root on a CUDA
card:
    python tools/witness_sparse.py [--only gibbs,sgpr,st_dgp] [--cpu-seconds 600]
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from nonstationary_precip_tpu_torch.ops import linalg, svgp_precompute  # noqa: E402

REF = ROOT / "tests" / "fixtures" / "jax_sparse_ref.npz"
SGPR_CHECKPOINTS = (100, 250, 500, 750, 1000)
PART = (1e-6, 1e-4, 1e-2)


def classify_jitter(jitter, diag_mean, steps: int) -> dict:
    """Each step's logged jitter split by the matrix it factored, told apart
    by the mean of its diagonal: the Nyström root's K_zz (the unscaled Gibbs
    Gram, whose diagonal is exactly 1), B = I + AAᵀ (far above 1), or the
    prior's Gram at z (1 + its 1e-4 jitter, once for the conditional mean
    and once for the log density, each dim a member).  Returns {"kzz",
    "b", "prior"}: (steps, members a step) arrays, members in call order.
    tools/pin_jax_sparse.py sorts the JAX runs' jitter with it."""
    jitter, diag_mean = np.asarray(jitter), np.asarray(diag_mean)
    kinds = np.where(diag_mean > 2.0, "b", np.where(np.abs(diag_mean - 1.0) < 5e-5, "kzz", "prior"))
    return {k: jitter[kinds == k].reshape(steps, -1) for k in ("kzz", "b", "prior")}


class JitterLog:
    """The jitter every ``safe_cholesky`` member took while active, with the
    mean of its matrix's diagonal, in call order (``linalg.escalating_jitter``
    wrapped; each call syncs to read them)."""

    def __enter__(self):
        self._orig, self.jitter, self.diag_mean = linalg.escalating_jitter, [], []

        def wrapped(mat, factor, jitter, max_tries):
            out, j = self._orig(mat, factor, jitter, max_tries)
            self.jitter.extend(j.detach().double().cpu().numpy().ravel().tolist())
            self.diag_mean.extend(torch.diagonal(mat.detach(), dim1=-2, dim2=-1).double().mean(-1).cpu().numpy()
                                  .ravel().tolist())
            return out, j

        linalg.escalating_jitter = wrapped
        return self

    def __exit__(self, *exc):
        linalg.escalating_jitter = self._orig


def first_parting(a: np.ndarray, b: np.ndarray) -> dict:
    """The first step at which traces a and b part by more than each of PART
    (relative to b; the largest over a split axis), or None."""
    rel = np.abs(a - b) / np.abs(b)
    rel = rel.reshape(rel.shape[0], -1).max(axis=1)
    return {f"{t:g}": next((int(i) for i in np.nonzero(rel > t)[0]), None) for t in PART}


def section_gibbs(dev) -> dict:
    from nonstationary_precip_tpu_torch.data.datasets import load_uib_spatial
    from nonstationary_precip_tpu_torch.experiments import spatial_gibbs
    from nonstationary_precip_tpu_torch.train.config import ExperimentConfig
    from nonstationary_precip_tpu_torch.train.vmapped import fit_splits

    ref = np.load(REF)
    steps = int(ref["steps"])
    _, x, y = load_uib_spatial()
    xn, yn = (x - x.mean(0)) / x.std(0, ddof=1), (y - y.mean()) / y.std(ddof=1)
    cfg = ExperimentConfig(inference="sparse", device="cuda")
    out = {}
    for where, dtype in ((dev, torch.float32), (dev, torch.float64), (torch.device("cpu"), torch.float32)):
        for train_z in (True, False):
            models, xs, ys = [], [], []
            for s in range(cfg.num_splits):
                model, (x_tr, y_tr, _, _) = spatial_gibbs.make_split(xn, yn, s, cfg, dtype, where)
                with torch.no_grad():
                    model.z.copy_(torch.as_tensor(ref["gibbs.z"][s], dtype=dtype, device=where))
                    model.log_ell_z.copy_(model.prior.init_log_field(model.z))
                models.append(model.trainable(train_noise=cfg.noise == 0, train_scale=cfg.scale == 0,
                                              train_z=train_z))
                xs.append(x_tr)
                ys.append(y_tr)
            with JitterLog() as log:
                res = fit_splits(models, lambda m, xx, yy: m.loss(xx, yy), xs, ys, lr=0.01, num_steps=steps)
            key = "gibbs" if train_z else "gibbs.frozen"
            suffix = "_f64" if dtype == torch.float64 else ""
            jax_losses = ref[f"{key}.losses{suffix}"]
            jitter = classify_jitter(log.jitter, log.diag_mean, steps)
            rel = np.abs(res.losses - jax_losses) / np.abs(jax_losses)
            row = {"rel_gap_to_jax_a_step": rel.max(axis=1).tolist(),
                   "parts_from_jax_at": first_parting(res.losses, jax_losses)}
            for kind, arr in jitter.items():
                theirs = ref[f"{key}.jitter.{kind}{suffix}"]
                row[kind] = {"jittered_a_step": (arr > 0).sum(axis=1).tolist(),
                             "jax_jittered_a_step": (theirs > 0).sum(axis=1).tolist(),
                             "largest": float(arr.max()), "jax_largest": float(theirs.max()),
                             "steps_differing": [int(i) for i in np.nonzero((arr != theirs).any(axis=1))[0]]}
            out[f"{where.type}_{str(dtype)[6:]}_{'z_trains' if train_z else 'z_frozen'}"] = row
    out["jax_f32_vs_f64"] = {"z_trains": first_parting(ref["gibbs.losses"], ref["gibbs.losses_f64"]),
                             "z_frozen": first_parting(ref["gibbs.frozen.losses"], ref["gibbs.frozen.losses_f64"])}
    return out


def sgpr_run(sgpr_bench, dev, dtype, seconds=None) -> dict:
    """``train.optim.fit``'s Adam loop over ``sgpr_bench``'s model, scored
    at SGPR_CHECKPOINTS; stops early once ``seconds`` have passed."""
    from nonstationary_precip_tpu_torch.models.sgpr import SGPR
    from nonstationary_precip_tpu_torch.train.metrics import nlpd_joint, rmse_rescaled

    cfg = sgpr_bench.default_config()
    train_x, train_y, test_x, test_y, z = sgpr_bench.prepare(cfg, dtype, dev)
    model = SGPR.create(sgpr_bench.make_kernel(dtype, dev), z, dtype=dtype, device=dev)
    opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=cfg.lr, betas=(0.9, 0.999),
                           eps=1e-8)
    scores, jitter, t0 = {}, [], time.perf_counter()
    with JitterLog() as log:
        for step in range(1, SGPR_CHECKPOINTS[-1] + 1):
            opt.zero_grad(set_to_none=True)
            start = len(log.jitter)
            model.loss(train_x, train_y).backward()
            opt.step()
            jitter.append(log.jitter[start:])
            if step in SGPR_CHECKPOINTS:
                with torch.no_grad():
                    p = model.predictive(train_x, train_y, test_x)
                    scores[step] = [float(rmse_rescaled(p.mean, test_y, 1.0)), float(nlpd_joint(p, test_y, 1.0))]
            if seconds is not None and time.perf_counter() - t0 > seconds:
                break
    jit = np.asarray(jitter)
    return {"steps": step, "seconds": time.perf_counter() - t0, "rmse_nlpd_at": scores,
            "steps_with_jitter_by_call": (jit > 0).sum(axis=0).tolist(),
            "largest_jitter_by_call": jit.max(axis=0).tolist(),
            "first_step_with_jitter": next((int(i) + 1 for i in np.nonzero((jit > 0).any(axis=1))[0]), None),
            "first_step_at_jitter_of_first_call": {f"{v:g}": int(np.nonzero(jit[:, 0] >= v)[0][0]) + 1
                                                   for v in sorted(set(jit[:, 0].tolist())) if v > 0}}


def section_sgpr(dev, cpu_seconds: float) -> dict:
    from nonstationary_precip_tpu_torch.experiments import sgpr_bench
    from nonstationary_precip_tpu_torch.ops import chol_blocked

    chol_blocked.build()
    return {"cuda_float32": sgpr_run(sgpr_bench, dev, torch.float32),
            "cuda_float64": sgpr_run(sgpr_bench, dev, torch.float64),
            "cpu_float32": sgpr_run(sgpr_bench, torch.device("cpu"), torch.float32, cpu_seconds)}


def section_st_dgp(dev) -> dict:
    from nonstationary_precip_tpu_torch.experiments import spatiotemporal_dgp
    from nonstationary_precip_tpu_torch.utils.config import BASE_SEED

    svgp_precompute.build()
    cfg = spatiotemporal_dgp.default_config()
    cpu = torch.device("cpu")
    kernel = svgp_precompute.svgp_precompute_cuda

    def run(where, dtype=torch.float32, plain_k4=False, seed=BASE_SEED):
        svgp_precompute.svgp_precompute_cuda = svgp_precompute.svgp_precompute_plain if plain_k4 else kernel
        try:
            r, nl, _, res = spatiotemporal_dgp.fit_score(cfg, where, dtype, seed)
        finally:
            svgp_precompute.svgp_precompute_cuda = kernel
        return r, nl, res.losses

    base = run(dev)
    out = {}
    for name, args in (("cuda_float32", (dev,)), ("cuda_float32_plain_k4", (dev, torch.float32, True)),
                       ("cuda_float64_plain_k4", (dev, torch.float64, True)), ("cpu_float32", (cpu,)),
                       ("cpu_float64", (cpu, torch.float64))):
        r, nl, losses = base if name == "cuda_float32" else run(*args)
        out[name] = {"rmse": r, "nlpd": nl, "parts_from_shipped_at": first_parting(losses, base[2])}
    for seed in range(BASE_SEED + 1, BASE_SEED + 5):
        for name, where in (("cuda", dev), ("cpu", cpu)):
            r, nl, _ = run(where, seed=seed)
            out.setdefault(f"seeds_{name}_float32", {})[seed] = [r, nl]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="gibbs,sgpr,st_dgp")
    ap.add_argument("--cpu-seconds", type=float, default=600.0,
                    help="wall-clock budget of the CPU SGPR run (it stops at the first step past it)")
    args = ap.parse_args()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    results = {"nvidia_smi": smi, "torch": torch.__version__, "cpu_threads": torch.get_num_threads()}
    sections = {"gibbs": lambda: section_gibbs(dev), "sgpr": lambda: section_sgpr(dev, args.cpu_seconds),
                "st_dgp": lambda: section_st_dgp(dev)}
    for name in args.only.split(","):
        t0 = time.perf_counter()
        results[name] = sections[name]()
        results[name]["seconds"] = time.perf_counter() - t0
        print(json.dumps({name: results[name]}), flush=True)
        (out_dir / "witness_sparse.json").write_text(json.dumps(results, indent=1))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
