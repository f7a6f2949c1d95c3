"""Where a training step of the port's exact GPs goes, on the card.

Three steps of ``nonstationary_precip_tpu_torch.experiments.exact_largen``,
f32, Adam lr 0.01:
  * ``gibbs``: bench_scaling.py's Gibbs MAP step at N = 1024 and 1280
    (``gibbs_dense``: the field trains, the prior's Cholesky stack is
    hoisted), whose loss runs K8; the same step with K8's gate closed (the
    composed Gram → Cholesky → solve, through K9 and K10a) and with K8's,
    K9's and K10a's gates closed (torch ops and cuSOLVER's potrf);
  * ``dense``: the Cholesky MLL of Scale(RBF(2)) at N = 8192 (the
    bench_scaling loop's last row), whose factorisation runs K5;
  * ``lazy``: the matrix-free MLL at N = 16384 (rank-150 pivoted-Cholesky
    preconditioner, 8 probes, 32 mBCG iterations, block 2048), whose mBCG
    matvec runs K6.
For each it warms up, times ``--steps`` untraced steps with CUDA events and
the host clock (and, for ``lazy``, the pivoted-Cholesky build alone; for
``gibbs``, K8's call alone and the composed step), then
traces ``--steps`` more with ``torch.profiler`` (CPU and CUDA activities)
and sums device kernel time by kernel.  Prints the top device kernels and
one JSON line per step kind: the untraced step time, K8's kernels (gibbs),
K5's update-and-panel and diagonal-tile kernels (dense; the diagonal tiles
run on a second stream beside the updates) or K6 and the pivoted-Cholesky
build (lazy), the rest, the traced wall time, the device's busy time (the
union of the device kernels' intervals in the trace, so kernels that
overlap on two streams count once), its idle share against the untraced
step (1 − busy time / untraced step time) and against the traced wall time
(which the profiler's own cost inflates when a step launches thousands of
kernels), and kernels per step.  The gzipped
Chrome traces go to ``build/profiles/profile_torch_exact_{gibbs*,dense,lazy}.json.gz``.

Run from the repository root on a CUDA card:
    python tools/profile_torch_exact.py [--steps 5] [--only gibbs|dense|lazy]
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from nonstationary_precip_tpu_torch.experiments import exact_largen  # noqa: E402
from nonstationary_precip_tpu_torch.experiments.gibbs_largen import probe_draws  # noqa: E402
from nonstationary_precip_tpu_torch.ops import chol_blocked, chol_stream, gibbs_fused, gibbs_gram, matvec  # noqa: E402
from nonstationary_precip_tpu_torch.ops.lazy_cg import build_precond_factor, default_cross  # noqa: E402
from nonstationary_precip_tpu_torch.utils.config import device  # noqa: E402

# K5's kernels (csrc/chol_rl.cuh): the trailing updates and panels, and the
# diagonal tiles, which run on a second stream beside the updates
K5_UPDATE, K5_DIAG = ("syrk_kernel", "panel_kernel"), ("diag_kernel",)
# K8's kernels: its build and commit, and chol_rl.cuh's diagonal, panel and
# update kernels with K8's hooks (on the Gibbs training step only K8 runs
# chol_rl.cuh)
K8_NAMES = ("build_kernel", "diag_kernel", "panel_kernel", "syrk_kernel", "commit_kernel")
K6_NAMES = ("gibbs_rows_kernel", "sum_splits_kernel")  # K6's walk and its sum; no K2 on this path


def event_ms(fn, reps):
    """Per-call device-timeline ms (CUDA events) and host ms of ``fn``."""
    dev_ms, host_ms = [], []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
        dev_ms.append(start.elapsed_time(stop))
    return statistics.median(dev_ms), statistics.median(host_ms)


def traced(step, steps: int, name: str):
    """Kernels of ``steps`` traced steps: (sorted key averages, busy µs,
    wall s)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out_dir = ROOT / "build" / "profiles"
    out_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_dir / f"profile_torch_exact_{name}.json.gz"))
    kernels = [e for e in prof.key_averages() if _device_kernel(e)]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = busy_union_us([e for e in prof.events() if _device_kernel(e)])
    print(f"[{name}] {'kernel':<90} {'calls':>6} {'us/step':>10} {'share':>6}")
    for e in kernels[:25]:
        print(f"[{name}] {e.key[:90]:<90} {e.count / steps:>6.0f} {e.self_device_time_total / steps:>10.1f} "
              f"{e.self_device_time_total / busy_us:>6.1%}")
    return kernels, busy_us, wall


def _device_kernel(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer."))


def busy_union_us(events) -> float:
    """µs of the union of the events' [start, end) intervals: the time the
    device ran at least one of them."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        if stop <= end:
            continue
        total += stop - max(start, end)
        end = stop
    return total


def ms_of(kernels, names, steps):
    return sum(e.self_device_time_total for e in kernels if any(nm in e.key for nm in names)) / steps / 1e3


def _shares(busy_us, wall_s, step_ms, steps) -> dict:
    busy_ms = busy_us / 1e3 / steps
    return {"traced_wall_ms_per_step": 1e3 * wall_s / steps, "device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1.0 - busy_ms / step_ms, "device_idle_share_traced": 1.0 - busy_us / 1e6 / wall_s}


def adam_step(model, loss_fn):
    opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=0.01)

    def step():
        opt.zero_grad(set_to_none=True)
        loss_fn(model).backward()
        opt.step()

    return step


def profile_gibbs(args, dev):
    out = []
    for n in exact_largen.GIBBS_NS:
        x, y = (t.to(dev) for t in exact_largen.gibbs_data((n,))[n])
        model, pc = exact_largen.gibbs_model(x)
        step = adam_step(model, lambda m: m.loss(x, y, pc))
        for _ in range(args.warmup):
            step()
        step_ms, step_host_ms = event_ms(step, args.steps)
        with torch.no_grad():
            ell, s2, noise = torch.exp(model.log_ell), model.outputscale, model.likelihood.noise
        k8_ms, k8_host_ms = event_ms(lambda: gibbs_fused.gibbs_chol_solve_cuda(x, ell, y, s2, noise), args.steps)
        kernels, busy_us, wall = traced(step, args.steps, f"gibbs{n}")
        k8 = ms_of(kernels, K8_NAMES, args.steps)
        # K8's gate closed: the composed path (K9's Gram, K10a's factor, the
        # library's solve); then K9's and K10a's gates closed too (torch ops
        # and potrf)
        composed = {}
        for name, mods in (("composed", (gibbs_fused,)), ("library", (gibbs_fused, gibbs_gram, chol_blocked))):
            gates = [m.eligible for m in mods]
            for m in mods:
                m.eligible = lambda *a, **k: False
            try:
                for _ in range(args.warmup):
                    step()
                composed[f"{name}_step_ms"], composed[f"{name}_step_host_ms"] = event_ms(step, args.steps)
            finally:
                for m, g in zip(mods, gates):
                    m.eligible = g
        out.append({"path": "gibbs", "n": n, "steps": args.steps, "step_ms": step_ms, "step_host_ms": step_host_ms,
                    "k8_call_ms": k8_ms, "k8_call_host_ms": k8_host_ms, "k8_ms_per_step": k8,
                    "rest_device_ms_per_step": busy_us / 1e3 / args.steps - k8,
                    **_shares(busy_us, wall, step_ms, args.steps),
                    "kernels_per_step": sum(e.count for e in kernels) / args.steps, **composed})
    return out


def profile_dense(args, dev):
    n = chol_stream.MAX_N
    x, y = (t.to(dev) for t in exact_largen.dense_data((n,))[n])
    step = adam_step(exact_largen.dense_model(dev=dev), lambda m: m.loss(x, y))
    for _ in range(args.warmup):
        step()
    step_ms, step_host_ms = event_ms(step, args.steps)
    kernels, busy_us, wall = traced(step, args.steps, "dense")
    update, diag = ms_of(kernels, K5_UPDATE, args.steps), ms_of(kernels, K5_DIAG, args.steps)
    return {"path": "dense", "n": n, "steps": args.steps, "step_ms": step_ms, "step_host_ms": step_host_ms,
            "k5_update_ms_per_step": update, "k5_diag_ms_per_step": diag,
            "rest_device_ms_per_step": busy_us / 1e3 / args.steps - update - diag,
            **_shares(busy_us, wall, step_ms, args.steps), "kernels_per_step": sum(e.count for e in kernels) / args.steps}


def profile_lazy(args, dev):
    n, rank, iters, block = 16384, 150, 32, 2048
    x, y, _ = (t.to(dev) for t in exact_largen.lazy_data(n))
    noise = tuple(torch.as_tensor(u).to(dev) for u in probe_draws(exact_largen.PROBE_SEED, rank, n))
    model = exact_largen.lazy_model(dev=dev)
    step = adam_step(model, lambda m: m.loss(x, y, solver="cg", probe_noise=noise, block=block, max_iters=iters,
                                             precond_rank=rank, matvec_builder=matvec.stationary_matvec_builder))

    def pivchol():
        with torch.no_grad():
            build_precond_factor("pivchol", model.kernel, x, rank, default_cross)

    for _ in range(args.warmup):
        step()
    step_ms, step_host_ms = event_ms(step, args.steps)
    piv_ms, piv_host_ms = event_ms(pivchol, args.steps)
    kernels, busy_us, wall = traced(step, args.steps, "lazy")
    k6 = ms_of(kernels, K6_NAMES, args.steps)
    return {"path": "lazy", "n": n, "steps": args.steps, "step_ms": step_ms, "step_host_ms": step_host_ms,
            "k6_ms_per_step": k6, "pivchol_ms_per_step": piv_ms, "pivchol_host_ms": piv_host_ms,
            "rest_ms_per_step": step_ms - k6 - piv_ms, **_shares(busy_us, wall, step_ms, args.steps),
            "kernels_per_step": sum(e.count for e in kernels) / args.steps}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--only", choices=("gibbs", "dense", "lazy"))
    args = ap.parse_args()
    dev = device("cuda")
    chol_stream.build()
    matvec.build()
    for m in (gibbs_fused, gibbs_gram, chol_blocked):
        m.build()
    for path, fn in (("gibbs", profile_gibbs), ("dense", profile_dense), ("lazy", profile_lazy)):
        if args.only in (None, path):
            results = fn(args, dev)
            for r in results if isinstance(results, list) else [results]:
                print(json.dumps({"device": torch.cuda.get_device_name(0), **r}), flush=True)


if __name__ == "__main__":
    main()
