#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Drives the port's main path — the 10-split exact Gibbs MAP experiment of
``nonstationary_precip_tpu_torch.experiments.spatial_gibbs`` on the real UIB
data (10 splits × 316 training points) — and checks every hand-written
kernel on it against its plain PyTorch version.  Phases, one JSON line each:

  1. device  — the card's name; nvidia-smi's name and power limit;
  2. build   — K1 (csrc/chol_inv_batched.cu) compiled with nvcc, in seconds;
  3. k1      — K1 against its plain version at the slice's shape (10, 316)
               on the real stacked Gibbs Gram and on random SPD stacks, a
               rank-deficient member through the jitter retry, then the
               median time of each;
  4. slice   — the experiment on the card (300 Adam steps by default): K1's
               launch count over the run, finite and falling losses, the
               per-split losses at steps 0 and 50 against the JAX package's
               pinned float32 values (tests/fixtures/jax_spatial_gibbs_ref.npz),
               steps/s, mean RMSE/NLPD, the field CSV's shape.

Any failed check raises, and the script exits non-zero without printing a
result.  The last lines are nvidia-smi's line, the kernels' JSON line and
the result line.  Needs a CUDA card and nvcc; imports no JAX.

Run from the repository root: python3 chip_smoke.py [--steps N]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# K1 against its plain version on the card, both float32 (ops/chol_inv.py
# and tests/test_torch_chol_inv.py state the reasons): L within 5e-6 of the
# float64 factor relative to its largest entry, ‖L⁻¹L − I‖∞ ≤ 5e-5, kernel
# and plain within 1e-5 relative of each other.
TOL_L_F64 = 5e-6
TOL_LINV_RESIDUAL = 5e-5
TOL_KERNEL_PLAIN = 1e-5
# The slice against the pinned JAX float32 losses (the same tolerances as
# tests/test_torch_jax_reference.py, which explains them).
RTOL_STEP0 = 1e-4
RTOL_STEP50 = 1e-2
N_TIMED = 60  # calls per timed block; blocks run plain, kernel, kernel, plain


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def block_times_ms(fn, calls: int) -> list:
    """Per-call device times of ``fn`` over ``calls`` back-to-back calls: one
    CUDA-event pair around each block of 10, one entry per block, warm-up
    excluded."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(calls // 10):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        stop.record()
        stop.synchronize()
        per.append(start.elapsed_time(stop) / 10)
    return per


def k1_errors(chol_inv, k, well_conditioned: bool):
    """K1 and its plain version on the same stack, both against the float64
    factor.  Every stack: finite output, the same jitter ladder, L within
    TOL_L_F64 of float64 and ‖L⁻¹L − I‖∞ ≤ TOL_LINV_RESIDUAL.  A well-
    conditioned stack (the kind tests/test_torch_chol_inv.py uses): kernel
    and plain within TOL_KERNEL_PLAIN of each other.  An ill-conditioned one
    (the slice's Gram, cond ~ 1e3) leaves L⁻¹ with f32 error that grows with
    the condition number in both versions, so there the kernel's L⁻¹ must be
    as close to float64 as the plain version's, within a factor of two."""
    l, li, jit = chol_inv.chol_inv_batched_cuda(k)
    pl, pli, pjit = chol_inv.chol_inv_batched_safe_plain(k)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(l).all() and torch.isfinite(li).all()), "K1 output finite")
    check(torch.equal(jit, pjit), f"jitter ladder matches the plain version ({jit.tolist()} vs {pjit.tolist()})")
    l64 = torch.linalg.cholesky(k.double())
    eye = torch.eye(k.shape[-1], dtype=torch.float64, device=k.device)
    li64 = torch.linalg.solve_triangular(l64, eye.expand_as(l64), upper=False)

    def rel(a, ref):
        return float((a.double() - ref).abs().max() / ref.abs().max())

    err = {
        "l_vs_f64": rel(l, l64),
        "plain_l_vs_f64": rel(pl, l64),
        "linv_vs_f64": rel(li, li64),
        "plain_linv_vs_f64": rel(pli, li64),
        "linv_residual": float((li.double() @ l.double() - eye).abs().max()),
        "l_vs_plain": rel(l, pl.double()),
        "linv_vs_plain": rel(li, pli.double()),
        "max_abs_err": float(max((l - pl).abs().max(), (li - pli).abs().max())),
    }
    check(err["l_vs_f64"] <= TOL_L_F64, f"L vs float64 {err['l_vs_f64']:.3g} <= {TOL_L_F64}")
    check(err["linv_residual"] <= TOL_LINV_RESIDUAL, f"L⁻¹L − I {err['linv_residual']:.3g} <= {TOL_LINV_RESIDUAL}")
    if well_conditioned:
        check(err["l_vs_plain"] <= TOL_KERNEL_PLAIN, f"L vs plain {err['l_vs_plain']:.3g} <= {TOL_KERNEL_PLAIN}")
        check(err["linv_vs_plain"] <= TOL_KERNEL_PLAIN,
              f"L⁻¹ vs plain {err['linv_vs_plain']:.3g} <= {TOL_KERNEL_PLAIN}")
    else:
        check(err["linv_vs_f64"] <= 2 * err["plain_linv_vs_f64"] + TOL_KERNEL_PLAIN,
              f"L⁻¹ vs float64 {err['linv_vs_f64']:.3g} within 2x the plain version's "
              f"{err['plain_linv_vs_f64']:.3g} (+{TOL_KERNEL_PLAIN})")
    return err


def phase_k1(chol_inv, spatial_gibbs, dev):
    from nonstationary_precip_tpu_torch.data.datasets import load_uib_spatial
    from nonstationary_precip_tpu_torch.models.gibbs_gp import noisy_gibbs_gram
    from nonstationary_precip_tpu_torch.train.config import ExperimentConfig
    from nonstationary_precip_tpu_torch.train.vmapped import stack_modules

    cfg = ExperimentConfig(device="cuda")
    _, x, y = load_uib_spatial()
    x_norm = (x - x.mean(0)) / x.std(0, ddof=1)
    y_norm = (y - y.mean()) / y.std(ddof=1)
    splits = [spatial_gibbs.make_split(x_norm, y_norm, s, cfg, torch.float32, dev) for s in range(10)]
    with torch.no_grad():
        gram = noisy_gibbs_gram(stack_modules([s[0] for s in splits]), torch.stack([s[1][0] for s in splits]))
    check(tuple(gram.shape) == (10, 316, 316), f"slice Gram shape {tuple(gram.shape)}")

    gen = torch.Generator().manual_seed(173)
    b = torch.randn(10, 316, 316, generator=gen, dtype=torch.float64)
    spd = (b @ b.mT / 316 + 0.5 * torch.eye(316, dtype=torch.float64)).float().to(dev)
    errs = {"gibbs_gram": k1_errors(chol_inv, gram.contiguous(), well_conditioned=False),
            "random_spd": k1_errors(chol_inv, spd, well_conditioned=True)}
    # N = 384, the kernel's largest: its working triangle no longer fits in
    # shared memory, so this exercises the global-scratch variant
    b384 = torch.randn(2, 384, 384, generator=gen, dtype=torch.float64)
    spd384 = (b384 @ b384.mT / 384 + 0.5 * torch.eye(384, dtype=torch.float64)).float().to(dev)
    check(not chol_inv.uses_smem(384, dev), "N = 384 takes the global-scratch variant")
    errs["random_spd_384"] = k1_errors(chol_inv, spd384, well_conditioned=True)

    # a rank-30 member: plain f32 Cholesky fails; per-member retry
    sb = torch.randn(316, 30, generator=gen, dtype=torch.float64)
    bad = spd.clone()
    bad[3] = (sb @ sb.T).float().to(dev)
    l_a, li_a, j_a = chol_inv.chol_inv_batched_cuda(spd)
    l_b, li_b, j_b = chol_inv.chol_inv_batched_cuda(bad)
    _, _, pj_b = chol_inv.chol_inv_batched_safe_plain(bad)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(l_b).all() and torch.isfinite(li_b).all()), "retried member finite")
    check(float(j_b[3]) > 0 and int((j_b != 0).sum()) == 1, f"only the bad member jittered: {j_b.tolist()}")
    check(torch.equal(j_b, pj_b), f"retry ladder matches the plain version ({j_b.tolist()} vs {pj_b.tolist()})")
    healthy = [i for i in range(10) if i != 3]
    check(torch.equal(l_a[healthy], l_b[healthy]) and torch.equal(li_a[healthy], li_b[healthy]),
          "healthy members bit-identical to the all-healthy run")
    check(torch.equal(j_a, torch.zeros_like(j_a)), "all-healthy run used no jitter")

    # times at the slice's shape, on the real Gram: plain, kernel, kernel, plain
    g = gram.contiguous()
    plain = lambda: chol_inv.chol_inv_batched_safe_plain(g)  # noqa: E731
    kernel = lambda: chol_inv.chol_inv_batched_cuda(g)  # noqa: E731
    p1, k1, k2, p2 = (block_times_ms(f, N_TIMED) for f in (plain, kernel, kernel, plain))
    ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
    emit("k1", shape=[10, 316], errors=errs, retry_jitter=j_b.tolist(), ms=ms, plain_ms=plain_ms,
         timed_calls=len(k1 + k2) * 10, blocks_ms={"plain": [statistics.median(p1), statistics.median(p2)],
                                                    "kernel": [statistics.median(k1), statistics.median(k2)]})
    return errs, ms, plain_ms


def phase_slice(chol_inv, spatial_gibbs, steps: int, dev_name: str):
    from nonstationary_precip_tpu_torch.train.config import ExperimentConfig

    ref = np.load(Path(__file__).resolve().parent / "tests" / "fixtures" / "jax_spatial_gibbs_ref.npz")
    check(steps > int(ref["steps"]), f"--steps must exceed {int(ref['steps'])} to compare with the pinned losses")
    cfg = ExperimentConfig(lr=0.01, max_iters=5000).parse_args(["--max_iters", str(steps), "--device", "cuda"])
    with tempfile.TemporaryDirectory() as out_dir:
        os.environ["NSGP_RESULTS_DIR"] = out_dir
        chol_inv.LAUNCHES = 0
        out = spatial_gibbs.run(cfg)
        launches = chol_inv.LAUNCHES
        field = np.loadtxt(out["csv"], delimiter=",", skiprows=1)
    losses = out["losses"]
    check(launches >= steps, f"K1 launched {launches} times over {steps} steps")
    check(losses.shape == (steps, 10), f"loss trace shape {losses.shape}")
    check(bool(np.isfinite(losses).all()), "every loss finite")
    check(bool((losses[-1] < losses[0]).all()), "every split's final loss below its step-0 loss")
    rel0 = np.abs(losses[0] - ref["loss_step0"]) / np.abs(ref["loss_step0"])
    rel50 = np.abs(losses[50] - ref["loss_step50"]) / np.abs(ref["loss_step50"])
    check(float(rel0.max()) <= RTOL_STEP0, f"step-0 losses vs JAX: {rel0.max():.3g} <= {RTOL_STEP0}")
    check(float(rel50.max()) <= RTOL_STEP50, f"step-50 losses vs JAX: {rel50.max():.3g} <= {RTOL_STEP50}")
    check(field.shape == (394, 6) and bool(np.isfinite(field).all()), f"field CSV {field.shape}, finite")
    check(np.isfinite(out["rmse"]) and np.isfinite(out["nlpd"]), "metrics finite")
    emit("slice", steps=steps, launches=launches, steps_per_s=out["steps_per_s"],
         train_seconds=out["train_seconds"], wall_seconds=out["wall_seconds"], rmse=out["rmse"],
         nlpd=out["nlpd"], step0_rel_err=float(rel0.max()), step50_rel_err=float(rel50.max()),
         final_loss=losses[-1].tolist(), device=dev_name)
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300, help="Adam steps of the slice run")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this smoke test runs only on a CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit("device", kind=name, count=torch.cuda.device_count(), nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    from nonstationary_precip_tpu_torch.experiments import spatial_gibbs
    from nonstationary_precip_tpu_torch.ops import chol_inv
    from nonstationary_precip_tpu_torch.utils import config

    dev = config.device("cuda")

    t0 = time.perf_counter()
    log = chol_inv.build(force=True)
    emit("build", kernel="chol_inv_batched", seconds=time.perf_counter() - t0,
         ptxas=[ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln])

    errs, ms, plain_ms = phase_k1(chol_inv, spatial_gibbs, dev)
    launches = phase_slice(chol_inv, spatial_gibbs, args.steps, name)

    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": [{
        "name": "chol_inv_batched_safe",
        "route": "cuda",
        "source": "nonstationary_precip_tpu_torch/csrc/chol_inv_batched.cu",
        "replaces": "nonstationary_precip_tpu/ops/pallas_chol.py:1054",
        "launches": launches,
        "max_abs_err": errs["gibbs_gram"]["max_abs_err"],
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
