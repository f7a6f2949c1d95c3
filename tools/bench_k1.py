"""K1's cluster size, measured: ``csrc/chol_inv_cluster.cu`` built with each
cluster size 1, 2, 4 and 8 (``-DK1_CLUSTER=c``), four nvcc runs at once,
and each variant timed and checked at the slice's shape (10, 316) and at
the kernel's largest N, (2, 384), on random SPD stacks (B Bᵀ / N + ½ I, as
``chip_smoke.py``'s k1 phase makes them).

For each variant and shape it prints one JSON line: the dynamic shared
memory a CTA takes, the card's opt-in limit, the clusters that fit at once
(``cudaOccupancyMaxActiveClusters``), the median ms a call (CUDA events
around blocks of 10 calls; blocks run in turns over the variants, twice),
and L's and L⁻¹'s largest error from float64 relative to the largest
entry.  A variant whose CTA needs more shared memory than the card allows
reports that and is not timed.  ``--baseline PATH`` adds another source of
the same C interface at its own default size (for example the parent
commit's ``chol_inv_cluster.cu``, compiled with its own directory's
headers), timed in the same turns.  The shipped size is the one the source
defaults to (``K1_CLUSTER``); this probe is how it was chosen.

Run from the repository root on a CUDA card:
    python tools/bench_k1.py [--calls 60] [--baseline PATH]
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

from nonstationary_precip_tpu_torch.ops import chol_inv, cuda_build  # noqa: E402

SIZES = (1, 2, 4, 8)
SHAPES = ((10, 316), (2, 384))


def build(c, source=None) -> tuple:
    """nvcc of the K1 source at cluster size c, or of ``source`` as it is;
    (library, ptxas lines)."""
    out_dir = ROOT / "build" / "bench_k1"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"libk1_c{c}.so"
    src = source or chol_inv.SOURCE
    flags = [] if source else [f"-DK1_CLUSTER={c}"]
    proc = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-I", str(src.parent), "-o", str(out),
                           str(src)], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed at cluster size {c}:\n{log}")
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.chol_inv_cluster.argtypes = [p] * 4 + [i, i, ctypes.c_float, i, p]
    for name in ("chol_inv_cluster_smem", "chol_inv_max_smem", "chol_inv_max_clusters"):
        getattr(lib, name).argtypes = [i]
    return lib, [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]


def spd(t: int, n: int, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    b = torch.randn(t, n, n, generator=gen, dtype=torch.float64)
    return (b @ b.mT / n + 0.5 * torch.eye(n, dtype=torch.float64)).float().cuda()


def call(lib, a: torch.Tensor):
    t, n, _ = a.shape
    l, li = torch.empty_like(a), torch.empty_like(a)
    jit = torch.empty(t, device=a.device)
    err = lib.chol_inv_cluster(a.data_ptr(), l.data_ptr(), li.data_ptr(), jit.data_ptr(), t, n, 1e-5, 6,
                               torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return l, li


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=60)
    ap.add_argument("--baseline", type=Path, help="another chol_inv_cluster.cu of the same C interface")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    jobs = {c: None for c in SIZES}
    if args.baseline:
        jobs["baseline"] = args.baseline.resolve()
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda kv: build(*kv), jobs.items())))
    for c, (_, ptxas) in libs.items():
        print(json.dumps({"cluster": c, "ptxas": ptxas}))
    for t, n in SHAPES:
        a = spd(t, n, 173 + n)
        l64 = torch.linalg.cholesky(a.double())
        eye = torch.eye(n, dtype=torch.float64, device=a.device)
        li64 = torch.linalg.solve_triangular(l64, eye.expand_as(l64), upper=False)
        rows, fits = {}, []
        for c, (lib, _) in libs.items():
            smem, limit = lib.chol_inv_cluster_smem(n), lib.chol_inv_max_smem(0)
            rows[c] = {"cluster": c, "shape": [t, n], "smem_bytes": smem, "smem_limit": limit,
                       "max_active_clusters": lib.chol_inv_max_clusters(n) if smem <= limit else None}
            if smem > limit:
                rows[c]["fits"] = False
                continue
            l, li = call(lib, a)
            torch.cuda.synchronize()
            rows[c]["l_vs_f64"] = float((l.double() - l64).abs().max() / l64.abs().max())
            rows[c]["linv_vs_f64"] = float((li.double() - li64).abs().max() / li64.abs().max())
            rows[c]["fits"] = True
            rows[c]["blocks_ms"] = []
            fits.append(c)
            for _ in range(3):
                call(lib, a)
        for _ in range(2):  # rounds in turns over the variants
            for c in fits:
                rows[c]["blocks_ms"].append(statistics.median(block_ms(lambda: call(libs[c][0], a), args.calls)))
        plain = statistics.median(block_ms(lambda: chol_inv.chol_inv_batched_safe_plain(a), args.calls))
        for c in libs:
            if rows[c]["fits"]:
                rows[c]["ms"] = statistics.median(rows[c]["blocks_ms"])
            print(json.dumps({**rows[c], "plain_ms": plain, "nvidia_smi": smi}))


if __name__ == "__main__":
    main()
