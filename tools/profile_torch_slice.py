"""Where a training step of the PyTorch port goes, on the card.

Builds the 10-split exact Gibbs MAP problem of
``nonstationary_precip_tpu_torch.experiments.spatial_gibbs`` (real UIB data,
10 splits × 316 points, f32), warms up, times ``--steps`` Adam steps with
CUDA events (untraced), then traces as many with ``torch.profiler`` (CPU
and CUDA activities).  Prints the top device kernels by time, and one JSON
line: the untraced step time, the device's busy time per step (sum of
kernel time; one stream, so kernels do not overlap), the idle share of an
untraced step that this leaves, K1's time per step and share of the device
time, and the traced window's wall time per step (the profiler's own cost
included).  The Chrome trace goes to ``chiprun_out/profile_torch_slice.json``.

``--inference sparse`` takes the sparse Gibbs slice instead (GibbsSparseGP,
M = 250 k-means inducing inputs, z and the field training; its step is the
stacked ``loss``, with K9 twice).  ``--gates`` also times the untraced step
with K9's gate as shipped (stacks admitted, one launch a stack) and cut to
2-D pairs (each stacked Gram the plain Gram, as before F-P5), in turns
2-D, stacks, stacks, 2-D, each over ``--steps`` steps after the warm-up.
``--segment N`` times the warm-up in blocks of N steps (CUDA events) and
counts, for each block and for the traced window, ``safe_cholesky``'s
calls, its factorisations (the first try and every jitter retry) and the
members that ended with jitter; ``--warmup 1500 --segment 250`` profiles
steps 1500 onwards of a run.

Run from the repository root on a CUDA card:
    python tools/profile_torch_slice.py [--steps 50] [--warmup 20] [--inference exact|sparse] [--gates]
        [--segment N]
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from nonstationary_precip_tpu_torch.data.datasets import load_uib_spatial  # noqa: E402
from nonstationary_precip_tpu_torch.experiments.spatial_gibbs import build_prior, make_split  # noqa: E402
from nonstationary_precip_tpu_torch.models.gibbs_gp import gibbs_map_loss_batched  # noqa: E402
from nonstationary_precip_tpu_torch.ops import chol_inv, gibbs_gram, linalg  # noqa: E402
from nonstationary_precip_tpu_torch.train.config import ExperimentConfig  # noqa: E402
from nonstationary_precip_tpu_torch.train.vmapped import stack_modules  # noqa: E402
from nonstationary_precip_tpu_torch.utils.config import device  # noqa: E402


class Tries:
    """Counts ``safe_cholesky``'s calls, factorisations and jittered members
    (``linalg.escalating_jitter`` wrapped; the jitter vectors are read only
    in ``per_step``, so counting adds no sync to a step)."""

    def __init__(self):
        orig = linalg.escalating_jitter

        def wrapped(mat, factor, jitter, max_tries):
            def counted(mats):
                self.factorisations += 1
                return factor(mats)

            self.calls += 1
            out, j = orig(mat, counted, jitter, max_tries)
            self.jitter.append(j.detach())
            return out, j

        linalg.escalating_jitter = wrapped
        self.reset()

    def reset(self):
        self.calls, self.factorisations, self.jitter = 0, 0, []

    def per_step(self, steps: int) -> dict:
        jittered = sum(int((j > 0).sum()) for j in self.jitter)
        return {"safe_cholesky_calls_a_step": self.calls / steps,
                "retries_a_step": (self.factorisations - self.calls) / steps,
                "jittered_members_a_step": jittered / steps}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--inference", choices=("exact", "sparse"), default="exact")
    ap.add_argument("--gates", action="store_true", help="time the step with K9's gate for stacks and for 2-D pairs")
    ap.add_argument("--segment", type=int, default=0, help="time the warm-up in blocks of this many steps")
    args = ap.parse_args()
    tries = Tries()
    dev = device("cuda")
    cfg = ExperimentConfig(device="cuda", inference=args.inference)
    chol_inv.build()
    gibbs_gram.build()
    _, x, y = load_uib_spatial()
    x_norm = (x - x.mean(0)) / x.std(0, ddof=1)
    y_norm = (y - y.mean()) / y.std(ddof=1)
    splits = [make_split(x_norm, y_norm, s, cfg, torch.float32, dev) for s in range(cfg.num_splits)]
    model = stack_modules([s[0] for s in splits])
    xs = torch.stack([s[1][0] for s in splits])
    ys = torch.stack([s[1][1] for s in splits])
    opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=cfg.lr)
    if args.inference == "sparse":
        def loss():
            return model.loss(xs, ys)
    else:
        pre = build_prior(cfg, torch.float32, dev).gram_pre(xs)

        def loss():
            return gibbs_map_loss_batched(model, xs, ys, pre)

    def step():
        opt.zero_grad(set_to_none=True)
        loss().sum().backward()
        opt.step()

    def timed_ms():
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.steps):
            step()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / args.steps

    segments = []
    if args.segment:
        for first in range(0, args.warmup, args.segment):
            n = min(args.segment, args.warmup - first)
            tries.reset()
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                step()
            stop.record()
            stop.synchronize()
            segments.append({"first_step": first, "steps": n, "ms_a_step": start.elapsed_time(stop) / n,
                             **tries.per_step(n)})
    else:
        for _ in range(args.warmup):
            step()
    torch.cuda.synchronize()
    gates = {}
    if args.gates:
        shipped = gibbs_gram.eligible

        def two_d(x1, x2):
            return x1.ndim == 2 and shipped(x1, x2)

        for name in ("2d", "stacks", "stacks", "2d"):
            gibbs_gram.eligible = two_d if name == "2d" else shipped
            for _ in range(args.warmup):
                step()
            gates.setdefault(name, []).append(timed_ms())
        gibbs_gram.eligible = shipped
    step_ms = timed_ms()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    tries.reset()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out_dir / "profile_torch_slice.json"))
    # device-side rows, less the ranges that user annotations (the optimizer's
    # record_function) put on the device timeline around the kernels
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and not e.key.startswith("Optimizer.")]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in kernels)
    k1_us = sum(e.self_device_time_total for e in kernels if "chol_inv_cluster_kernel" in e.key)
    print(f"{'kernel':<90} {'calls':>6} {'us/step':>9} {'share':>6}")
    for e in kernels[:25]:
        print(f"{e.key[:90]:<90} {e.count:>6} {e.self_device_time_total / args.steps:>9.1f} "
              f"{e.self_device_time_total / busy_us:>6.1%}")
    busy_ms = busy_us / 1e3 / args.steps
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi,
        "steps": args.steps,
        "step_ms_untraced": step_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / step_ms,
        "k1_ms_per_step": k1_us / 1e3 / args.steps,
        "k1_share_of_device_time": k1_us / busy_us,
        "traced_wall_ms_per_step": 1e3 * wall / args.steps,
        "kernels_per_step": sum(e.count for e in kernels) / args.steps,
        "inference": args.inference,
        "k9_ms_per_step": sum(e.self_device_time_total for e in kernels if "gibbs_gram_kernel" in e.key) / 1e3
        / args.steps,
        "step_ms_by_k9_gate": gates,
        "safe_cholesky_in_traced_window": tries.per_step(args.steps),
        "warmup_segments": segments,
    }))


if __name__ == "__main__":
    main()
