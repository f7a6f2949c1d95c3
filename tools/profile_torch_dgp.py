"""Where a training step of the port's DSVI deep GP goes, on the card.

Builds the 10-split problem of ``nonstationary_precip_tpu_torch.experiments.
deepgp_spatial`` at its full configuration (real UIB data, 10 splits × 315
points, 2 hidden layers + head, M = 250, S = 3, f32) as one stacked model,
and profiles its step twice: with the fused data term (K7, the default) and
with the composed one (``fused_elbo=False``).  For each it warms up, times
``--steps`` Adam steps with CUDA events (untraced), then traces as many with
``torch.profiler`` (CPU and CUDA activities).  Prints the top device kernels
by time, and one JSON line per path: the untraced step time, the device's
busy time per step (the sum of kernel time on the one stream), the idle
share of an untraced step that this leaves, K4's and K7's time per step and
share of the device time (K4: its one cluster kernel, factor and W
together, split by ``tools/bench_k4.py``; K7: its forward, backward and
reduction kernels), and the kernels launched per step.  The
gzipped Chrome traces go to ``build/profiles/profile_torch_dgp_{fused,composed}.json.gz``.

Run from the repository root on a CUDA card:
    python tools/profile_torch_dgp.py [--steps 50]
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from nonstationary_precip_tpu_torch.data.dataprep import load_csv  # noqa: E402
from nonstationary_precip_tpu_torch.experiments import deepgp_spatial  # noqa: E402
from nonstationary_precip_tpu_torch.ops import elbo_fused, svgp_precompute  # noqa: E402
from nonstationary_precip_tpu_torch.train.vmapped import stack_modules  # noqa: E402
from nonstationary_precip_tpu_torch.utils.config import DATASET_DIR, device  # noqa: E402


K4_KERNELS = ("svgp_cluster_kernel",)
# the marginals' elbo_k_kernel and elbo_out_kernel run in both passes
K7_KERNELS = ("elbo_k_kernel", "elbo_out_kernel", "elbo_fwd_layer1_kernel", "elbo_fwd_layer2_kernel",
              "elbo_fwd_head_kernel", "elbo_sum_kernel", "elbo_bwd_head_kernel", "elbo_bwd_pull_kernel",
              "elbo_bwd_layer2_kernel", "elbo_bwd_layer1_kernel", "elbo_wbar_kernel", "elbo_bwd_reduce_kernel")


def profile(label, model, loss_fn, xs, ys, eps, lr, warmup, steps, smi):
    """Time ``steps`` untraced steps, trace as many; print the top kernels
    and return the path's JSON record."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    it = iter(range(warmup + 2 * steps))

    def step():
        t = next(it)
        opt.zero_grad(set_to_none=True)
        torch.sum(loss_fn(model, tuple(e[t] for e in eps), xs, ys)).backward()
        opt.step()

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        step()
    stop.record()
    stop.synchronize()
    step_ms = start.elapsed_time(stop) / steps

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    out_dir = ROOT / "build" / "profiles"
    out_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_dir / f"profile_torch_dgp_{label}.json.gz"))
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and not e.key.startswith("Optimizer.")]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in kernels)

    def per_step(names):
        return {n: sum(e.self_device_time_total for e in kernels if n in e.key) / 1e3 / steps for n in names}

    k4, k7 = per_step(K4_KERNELS), per_step(K7_KERNELS)
    print(f"--- {label}")
    print(f"{'kernel':<90} {'calls':>6} {'us/step':>9} {'share':>6}")
    for e in kernels[:25]:
        print(f"{e.key[:90]:<90} {e.count:>6} {e.self_device_time_total / steps:>9.1f} "
              f"{e.self_device_time_total / busy_us:>6.1%}")
    busy_ms = busy_us / 1e3 / steps
    return {
        "path": label,
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi,
        "steps": steps,
        "step_ms_untraced": step_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / step_ms,
        "k4_ms_per_step": k4,
        "k4_share_of_device_time": sum(k4.values()) / busy_ms,
        "k7_ms_per_step": k7,
        "k7_share_of_device_time": sum(k7.values()) / busy_ms,
        "kernels_per_step": sum(e.count for e in kernels) / steps,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=20)
    args = ap.parse_args()
    dev = device("cuda")
    total = args.warmup + 2 * args.steps
    cfg = deepgp_spatial.default_config().parse_args(["--num_epochs", str(total), "--device", "cuda"])
    svgp_precompute.build()
    elbo_fused.build()
    data = load_csv(DATASET_DIR / "uib_spatial.csv")
    preps = [deepgp_spatial.prep_split(data, s, cfg, torch.float32, dev) for s in range(cfg.num_splits)]
    # one epoch is one full batch: every step sees all 315 rows of each split
    xs = torch.stack([p[1][0] for p in preps])
    ys = torch.stack([p[1][1] for p in preps])
    eps = [torch.stack([p[3][i] for p in preps], dim=1) for i in range(cfg.num_layers)]  # (T, K, S, O, B)
    n = xs.shape[1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    paths = {"fused": lambda m, e, xb, yb: m.loss(xb, yb, num_data=n, eps=e, fused_elbo=True),
             "composed": lambda m, e, xb, yb: m.loss(xb, yb, num_data=n, eps=e, fused_elbo=False)}
    records = []
    for label, loss_fn in paths.items():
        model = stack_modules([deepgp_spatial.prep_split(data, s, cfg, torch.float32, dev)[0]
                               for s in range(cfg.num_splits)])
        records.append(profile(label, model, loss_fn, xs, ys, eps, cfg.lr, args.warmup, args.steps, smi))
    for rec in records:
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
