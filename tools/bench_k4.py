"""K4's cluster size and CTAs an SM, measured: ``csrc/svgp_precompute.cu``
built with each cluster size 1, 2, 4 and 8 (``-DK4_CLUSTER=c``) and with
its registers left free or capped for two CTAs an SM
(``-DK4_MIN_BLOCKS=1|2``), all nvcc runs at once, and each variant timed
and checked on the deep GP's K_zz stack at init (the path's 50 members of
M = 250, D 2, P 501, from ``deepgp_spatial.prep_split`` on the card).

For each variant it prints one JSON line: the dynamic shared memory a CTA
takes, the card's opt-in limit, the clusters that fit at once
(``cudaOccupancyMaxActiveClusters``), nvcc's registers and spills, the
median ms a call (CUDA events around blocks of 10 calls; blocks run in
turns over the variants, twice), and the largest difference of L, W and
L⁻¹ from the plain version (and whether the jitter matches).  A variant
whose CTA needs more shared memory than the card allows, or that does not
fit on an SM, reports that and is not timed.  Two more variants are the
shipped size with one choice turned back, built from rewritten copies of
the source and the cluster header: the leaf's IEEE sqrtf and division in
place of rsqrtf, and the substitutions' IEEE division in place of the
diagonal's reciprocal.
``--baseline PATH`` adds
another source of the same C interface, timed in the same turns (for
example the parent commit's ``svgp_precompute.cu``, compiled with its own
directory's headers).  The shipped variant is the one the source defaults
to (``K4_CLUSTER``, ``K4_MIN_BLOCKS``); this probe is how it was chosen.
The last line is the card's name and power limit.

Run from the repository root on a CUDA card:
    python tools/bench_k4.py [--calls 60] [--baseline PATH]
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from nonstationary_precip_tpu_torch.ops import cuda_build, svgp_precompute  # noqa: E402
from nonstationary_precip_tpu_torch.utils.config import EPSILON  # noqa: E402

VARIANTS = {f"c{c}_min{b}": (c, b) for c in (1, 2, 4, 8) for b in (1, 2)}
# the shipped size with one choice turned back, from rewritten copies of
# the source and of the cluster header: the leaf with IEEE sqrtf and
# division (the column sweep's rounding) in place of rsqrtf, and the
# substitutions' IEEE division in place of the reciprocal
LEAF_RSQRT = """    const float rs = rsqrtf(d);
    const float l = lane == k ? d * rs : (lane > k ? a[k] * rs : 0.f);
    const float xk = x[k] * rs;
"""
LEAF_IEEE = """    const float sd = sqrtf(d);
    const float l = lane == k ? sd : (lane > k ? a[k] / sd : 0.f);
    const float xk = x[k] / sd;
"""
REWRITES = {"ieee_leaf": ("chol_inv_cluster.cuh", LEAF_RSQRT, LEAF_IEEE),
            "div_substitution": ("svgp_precompute.cu", "static constexpr bool kRecip = true;",
                                 "static constexpr bool kRecip = false;")}


def build(name: str, source: Path, flags: list) -> tuple:
    """nvcc of one variant; (library, ptxas summary of its kernels)."""
    out_dir = ROOT / "build" / "bench_k4"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"libk4_{name}.so"
    proc = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-I", str(source.parent), "-o",
                           str(out), str(source)], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{log}")
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.svgp_precompute.argtypes = [p] * 8 + [i] * 4 + [ctypes.c_float, p]
    lib.svgp_precompute.restype = i
    for fn, args in (("svgp_smem_bytes", [i, i]), ("svgp_max_smem", [i]), ("svgp_max_clusters", [i, i])):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = args
    return lib, cs.ptxas_summary(log)


def call(lib, args):
    z, ell, s2, packed = args
    t, m, d = z.shape
    p = packed.shape[-1]
    l = torch.empty((t, m, m), device=z.device)
    li = torch.empty_like(l)
    w = torch.empty((t, m, p), device=z.device)
    jit = torch.empty(t, device=z.device)
    err = lib.svgp_precompute(z.data_ptr(), ell.data_ptr(), s2.data_ptr(), packed.data_ptr(), l.data_ptr(),
                              w.data_ptr(), li.data_ptr(), jit.data_ptr(), t, m, d, p, EPSILON,
                              torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return l, w, li, jit


def block_ms(fn, calls: int) -> list:
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


def kzz_at_init(dev):
    from nonstationary_precip_tpu_torch.data.dataprep import load_csv
    from nonstationary_precip_tpu_torch.experiments import deepgp_spatial
    from nonstationary_precip_tpu_torch.utils.config import DATASET_DIR
    from nonstationary_precip_tpu_torch.train.vmapped import stack_modules

    cfg = deepgp_spatial.default_config().parse_args(["--num_epochs", "1", "--device", "cuda"])
    data = load_csv(DATASET_DIR / "uib_spatial.csv")
    model = stack_modules([deepgp_spatial.prep_split(data, s, cfg, torch.float32, dev)[0]
                           for s in range(cfg.num_splits)])
    return cs.k4_payload(model)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=60)
    ap.add_argument("--baseline", type=Path, help="another svgp_precompute.cu of the same C interface")
    args = ap.parse_args()
    dev = torch.device("cuda")
    jobs = {name: (svgp_precompute.SOURCE, [f"-DK4_CLUSTER={c}", f"-DK4_MIN_BLOCKS={b}"])
            for name, (c, b) in VARIANTS.items()}
    for name, (file, old, new) in REWRITES.items():
        copies = ROOT / "build" / "bench_k4" / name
        copies.mkdir(parents=True, exist_ok=True)
        for f in ("svgp_precompute.cu", "chol_inv_cluster.cuh"):
            text = (svgp_precompute.SOURCE.parent / f).read_text()
            if f == file:
                if text.count(old) != 1:
                    raise ValueError(f"csrc/{f} changed: {old!r} not found once")
                text = text.replace(old, new)
            (copies / f).write_text(text)
        jobs[name] = (copies / "svgp_precompute.cu", [])
    if args.baseline:
        jobs["baseline"] = (args.baseline.resolve(), [])
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda kv: build(kv[0], *kv[1]), jobs.items())))
    payload = kzz_at_init(dev)
    t, m, d = payload[0].shape
    plain = svgp_precompute.svgp_precompute_plain(*payload)
    rows, fits = {}, []
    for name, (lib, ptxas) in libs.items():
        row = {"variant": name, "shape": [t, m, d, payload[3].shape[-1]], "ptxas": ptxas}
        if name in VARIANTS:
            row["cluster"], row["min_blocks"] = VARIANTS[name]
        if name in VARIANTS or name in REWRITES:
            row["smem_bytes"], row["smem_limit"] = lib.svgp_smem_bytes(m, d), lib.svgp_max_smem(0)
            if row["smem_bytes"] > row["smem_limit"]:
                rows[name] = {**row, "fits": False}
                continue
            row["max_active_clusters"] = lib.svgp_max_clusters(m, d)
            if row["max_active_clusters"] <= 0:
                rows[name] = {**row, "fits": False}
                continue
        out = call(lib, payload)
        torch.cuda.synchronize()
        row["max_abs_diff_plain"] = {k: float((a - b).abs().max()) for k, a, b in zip(("L", "W", "Linv"), out, plain)}
        row["jitter_matches_plain"] = bool(torch.equal(out[3], plain[3]))
        row["fits"], row["blocks_ms"] = True, []
        rows[name] = row
        fits.append(name)
    for _ in range(2):  # rounds in turns over the variants
        for name in fits:
            lib = libs[name][0]
            for _ in range(3):
                call(lib, payload)
            rows[name]["blocks_ms"].append(statistics.median(block_ms(lambda: call(lib, payload), args.calls)))
    plain_ms = statistics.median(block_ms(lambda: svgp_precompute.svgp_precompute_plain(*payload), args.calls))
    for name, row in rows.items():
        if row["fits"]:
            row["ms"] = statistics.median(row["blocks_ms"])
        print(json.dumps({**row, "plain_ms": plain_ms}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
