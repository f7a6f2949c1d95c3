"""K3 (the fused backward panel sweep, csrc/gibbs_matvec.cu: the Gram·V walk
``gibbs_rows_kernel`` with the ``PanelElem`` policy) built with other
register tiles and occupancies, timed side by side on the card.

Each variant is the shipped source with ``kK3RowsPerThread`` (rows a thread
owns) and ``kK3MinBlocks`` (blocks an SM the compiler must fit at d = 2,
1 + 2R ≤ 17; 1 leaves it free) replaced, compiled with nvcc at once, and
launched through its own ``gibbs_panel_grads`` at the gate's shape (16384
rows and columns, D 2, R 8 probes: 17 cotangent factors; a trained-like ℓ)
with the column splits that ``matvec.column_splits`` gives for 4, 8 and 16
blocks an SM.  Prints one JSON line per (variant, blocks an SM): the median
ms of 40 calls (CUDA events), the splits, nvcc's registers and spills for
the walk's <PanelElem, 2, 17>, and the largest difference from the plain
version relative to each output's largest entry; then the card's name and
power limit.  ``--baseline PATH`` adds another source of the same C
interface (for example the parent commit's ``gibbs_matvec.cu``, whose K3
walked a row a thread in 128-row blocks: ``--baseline-rows 128``), timed
the same way.  This is how the shipped choice was made.

Run from the repository root on a CUDA card:
    python tools/bench_k3.py [--baseline PATH [--baseline-rows N]]
"""

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from nonstationary_precip_tpu_torch.experiments.gibbs_largen import _data  # noqa: E402
from nonstationary_precip_tpu_torch.ops import matvec  # noqa: E402
from nonstationary_precip_tpu_torch.ops.cuda_build import BUILD_DIR, NVCC_FLAGS, nvcc  # noqa: E402

VARIANTS = {"rows1_free": (1, 1), "rows2_free": (2, 1), "rows2_min2": (2, 2), "rows2_min3": (2, 3),
            "rows4_free": (4, 1), "rows4_min2": (4, 2)}
N, R = 16384, 8
BASELINE_ROWS = 128  # a row a thread, 128-thread blocks: K3's walk before it moved onto K2's


def build(name: str, rows: int, min_blocks: int, source=None):
    """Compile the variant into build/torch_kernels/k3var/; returns (library
    path, nvcc's register report of K3's kernels at d = 2)."""
    if source is None:
        src = matvec.SOURCE.read_text()
        src = re.sub(r"constexpr int kK3RowsPerThread = \d+;", f"constexpr int kK3RowsPerThread = {rows};", src)
        src = re.sub(r"constexpr int kK3MinBlocks = \d+;", f"constexpr int kK3MinBlocks = {min_blocks};", src)
        include = matvec.SOURCE.parent
    else:
        src, include = source.read_text(), source.parent
    out = BUILD_DIR / "k3var"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-I", str(include), "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-3000:]}")
    summary = cs.ptxas_summary(proc.stdout + proc.stderr)
    return so, {k: v for k, v in summary.items()
                if k in ("gibbs_rows_kernel<PanelElem,2,17>", "gibbs_panel_grads_kernel<2,17>")}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, help="another gibbs_matvec.cu of the same C interface")
    ap.add_argument("--baseline-rows", type=int, default=BASELINE_ROWS,
                    help="rows a block of the baseline's K3 owns (its column splits follow)")
    args = ap.parse_args()
    dev = torch.device("cuda")
    jobs = {name: (rows, mb, None) for name, (rows, mb) in VARIANTS.items()}
    if args.baseline:
        jobs["baseline"] = (0, 0, args.baseline.resolve())
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda kv: build(kv[0], *kv[1]), jobs.items())))
    gen = torch.Generator().manual_seed(3)
    x, _ = _data(N)
    x = x.to(dev).contiguous()
    ell = torch.exp(0.3 * torch.randn(N, 2, generator=gen)).to(dev).contiguous()
    a, s, z = (torch.randn(*shape, generator=gen).to(dev) for shape in ((N,), (N, R), (N, R)))
    f1, f2 = matvec.cotangent_factors(a, s, z)
    fw = f2.shape[1]
    ref = matvec._panel_grads_plain(x, ell, f1, x, ell, f2)
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, (so, regs) in built.items():
        lib = ctypes.CDLL(str(so))
        lib.gibbs_panel_grads.argtypes = [p, p, p, i, p, p, p, i, i, i, p, p, p, p, i, i, p]
        lib.gibbs_panel_grads.restype = i
        rows = 256 * VARIANTS[name][0] if name in VARIANTS else args.baseline_rows
        for per_sm in (4, 8, 16):
            splits, per = matvec.column_splits(N, N, 1, sms, rows, per_sm)
            outs = [torch.empty(N, 2, device=dev), torch.empty(N, 2, device=dev), torch.empty(N, device=dev)]
            part = torch.empty(splits * N * 5, device=dev)

            def call():
                err = lib.gibbs_panel_grads(x.data_ptr(), ell.data_ptr(), f1.data_ptr(), N, x.data_ptr(),
                                            ell.data_ptr(), f2.data_ptr(), N, 2, fw, *(o.data_ptr() for o in outs),
                                            part.data_ptr(), splits, per, stream)
                if err != 0:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            ms = statistics.median(cs.block_times_ms(call, 40))
            print(json.dumps({"variant": name, "rows_a_thread": VARIANTS[name][0] if name in VARIANTS else None,
                              "min_blocks": VARIANTS[name][1] if name in VARIANTS else None, "rows_a_block": rows,
                              "blocks_per_sm": per_sm, "splits": splits, "ms": ms, "ptxas": regs,
                              "rel_diff_plain": [float((o - q).abs().max() / q.abs().max())
                                                 for o, q in zip(outs, ref)]}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
