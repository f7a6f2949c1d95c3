"""Where a training step of the port's DSVI deep GP goes, on the card.

Builds the 10-split problem of ``nonstationary_precip_tpu_torch.experiments.
deepgp_spatial`` at its full configuration (real UIB data, 10 splits × 315
points, 2 hidden layers + head, M = 250, S = 3, f32) as one stacked model,
warms up, times ``--steps`` Adam steps with CUDA events (untraced), then
traces as many with ``torch.profiler`` (CPU and CUDA activities).  Prints the
top device kernels by time, and one JSON line: the untraced step time, the
device's busy time per step (the sum of kernel time on the one stream), the
idle share of an untraced step that this leaves, K4's share of the device
time (its factor and W kernels), its own time per step, and the kernels
launched per step.  The Chrome trace goes to
``chiprun_out/profile_torch_dgp.json``.

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
from nonstationary_precip_tpu_torch.ops import svgp_precompute  # noqa: E402
from nonstationary_precip_tpu_torch.train.vmapped import stack_modules  # noqa: E402
from nonstationary_precip_tpu_torch.utils.config import DATASET_DIR, device  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=20)
    args = ap.parse_args()
    dev = device("cuda")
    total = args.warmup + 2 * args.steps
    cfg = deepgp_spatial.default_config().parse_args(["--num_epochs", str(total), "--device", "cuda"])
    svgp_precompute.build()
    data = load_csv(DATASET_DIR / "uib_spatial.csv")
    preps = [deepgp_spatial.prep_split(data, s, cfg, torch.float32, dev) for s in range(cfg.num_splits)]
    model = stack_modules([p[0] for p in preps])
    # one epoch is one full batch: every step sees all 315 rows of each split
    xs = torch.stack([p[1][0] for p in preps])
    ys = torch.stack([p[1][1] for p in preps])
    eps = [torch.stack([p[3][i] for p in preps], dim=1) for i in range(cfg.num_layers)]  # (T, K, S, O, B)
    loss_fn = deepgp_spatial._loss_fn(xs.shape[1])
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    it = iter(range(total))

    def step():
        t = next(it)
        opt.zero_grad(set_to_none=True)
        torch.sum(loss_fn(model, tuple(e[t] for e in eps), xs, ys)).backward()
        opt.step()

    for _ in range(args.warmup):
        step()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.steps):
        step()
    stop.record()
    stop.synchronize()
    step_ms = start.elapsed_time(stop) / args.steps

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out_dir / "profile_torch_dgp.json"))
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and not e.key.startswith("Optimizer.")]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in kernels)
    k4 = {name: sum(e.self_device_time_total for e in kernels if name in e.key)
          for name in ("svgp_factor_kernel", "svgp_w_kernel")}
    print(f"{'kernel':<90} {'calls':>6} {'us/step':>9} {'share':>6}")
    for e in kernels[:25]:
        print(f"{e.key[:90]:<90} {e.count:>6} {e.self_device_time_total / args.steps:>9.1f} "
              f"{e.self_device_time_total / busy_us:>6.1%}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    busy_ms = busy_us / 1e3 / args.steps
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi,
        "steps": args.steps,
        "step_ms_untraced": step_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / step_ms,
        "k4_ms_per_step": {k: v / 1e3 / args.steps for k, v in k4.items()},
        "k4_share_of_device_time": sum(k4.values()) / busy_us,
        "kernels_per_step": sum(e.count for e in kernels) / args.steps,
    }))


if __name__ == "__main__":
    main()
