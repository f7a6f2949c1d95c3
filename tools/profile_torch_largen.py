"""Where a training step of the port's large-N matrix-free gate goes, on the
card.

Builds the problem of ``nonstationary_precip_tpu_torch.experiments.
gibbs_largen`` (N = 16384 by default, rank-150 preconditioner, 8 probes, 16
mBCG iterations, f32), warms up, then
  * times ``--steps`` untraced Adam steps with CUDA events and the host
    clock, and the pivoted-Cholesky build alone the same way;
  * traces ``--steps`` more with ``torch.profiler`` (CPU and CUDA
    activities) and sums device kernel time by kernel: K2 (the Gram·V and
    its reduction pass), K3 (the backward sweep and its finishing pass) and
    everything else.
Prints the top device kernels and one JSON line: per step, the untraced
wall time, K2, K3, the pivoted-Cholesky build, the rest, and the device's
idle share (1 − traced kernel time / traced wall time).  The Chrome trace
goes to ``chiprun_out/profile_torch_largen.json``.

Run from the repository root on a CUDA card:
    python tools/profile_torch_largen.py [--n 16384] [--steps 5]
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

from nonstationary_precip_tpu_torch.experiments.gibbs_largen import _data, probe_draws  # noqa: E402
from nonstationary_precip_tpu_torch.kernels.gibbs import packed_gibbs_cross  # noqa: E402
from nonstationary_precip_tpu_torch.ops import matvec  # noqa: E402
from nonstationary_precip_tpu_torch.ops.lazy_cg import build_precond_factor, lazy_cg_mll  # noqa: E402
from nonstationary_precip_tpu_torch.utils.config import device  # noqa: E402

K2_NAMES = ("GibbsElem", "sum_splits_kernel")  # the walk's K2 instantiations and their sum
K3_NAMES = ("PanelElem", "panel_grads_finish_kernel")  # the walk's K3 instantiations and their finish


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
    args = ap.parse_args()
    dev = device("cuda")
    matvec.build()
    n, rank, iters, block = args.n, 150, 16, 2048
    x, y = (t.to(dev) for t in _data(n))
    noise = tuple(torch.as_tensor(u).to(dev) for u in probe_draws(173, rank, n))
    cross = packed_gibbs_cross(2)
    builder, pvjp = matvec.scaled_packed_gibbs_matvec_builder(2), matvec.packed_gibbs_panel_vjp(2)
    params = [torch.zeros((n, 2), device=dev, requires_grad=True),
              torch.tensor(0.5, device=dev, requires_grad=True), torch.tensor(-2.0, device=dev, requires_grad=True)]
    opt = torch.optim.Adam(params, lr=1e-2)

    def step():
        opt.zero_grad(set_to_none=True)
        aug = torch.cat([x, params[0]], dim=1)
        loss = -lazy_cg_mll(params[1], aug, y, noise, torch.exp(params[2]), block=block, max_iters=iters, tol=1e-6,
                            precond_rank=rank, cross_fn=cross, matvec_builder=builder, panel_vjp=pvjp) / n
        loss.backward()
        opt.step()

    def pivchol():
        with torch.no_grad():
            build_precond_factor("pivchol", params[1], torch.cat([x, params[0]], dim=1), rank, cross)

    for _ in range(args.warmup):
        step()
    step_dev_ms, step_host_ms = event_ms(step, args.steps)
    piv_dev_ms, piv_host_ms = event_ms(pivchol, args.steps)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out_dir / "profile_torch_largen.json"))
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and not e.key.startswith("Optimizer.")]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in kernels)

    def us_of(names):
        return sum(e.self_device_time_total for e in kernels if any(nm in e.key for nm in names)) / args.steps

    print(f"{'kernel':<90} {'calls':>6} {'us/step':>10} {'share':>6}")
    for e in kernels[:25]:
        print(f"{e.key[:90]:<90} {e.count:>6} {e.self_device_time_total / args.steps:>10.1f} "
              f"{e.self_device_time_total / busy_us:>6.1%}")
    k2_ms, k3_ms = us_of(K2_NAMES) / 1e3, us_of(K3_NAMES) / 1e3
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "n": n, "steps": args.steps,
        "step_ms": step_dev_ms, "step_host_ms": step_host_ms,
        "k2_ms_per_step": k2_ms, "k3_ms_per_step": k3_ms,
        "pivchol_ms_per_step": piv_dev_ms, "pivchol_host_ms": piv_host_ms,
        "rest_ms_per_step": step_dev_ms - k2_ms - k3_ms - piv_dev_ms,
        "traced_wall_ms_per_step": 1e3 * wall / args.steps,
        "device_busy_ms_per_step": busy_us / 1e3 / args.steps,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "kernels_per_step": sum(e.count for e in kernels) / args.steps,
    }))


if __name__ == "__main__":
    main()
