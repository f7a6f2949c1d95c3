"""K2 and K6 (the Gibbs and the RBF Gram·V, csrc/gibbs_matvec.cu: one walk,
``gibbs_rows_kernel``, with two element policies) built with other register
tiles and occupancies, timed side by side on the card.

Each variant is the shipped source with ``kK2RowsPerThread`` and
``kK6RowsPerThread`` (rows a thread owns) and ``kK2MinBlocks`` and
``kK6MinBlocks`` (blocks an SM the compiler must fit at d = 2, R ≤ 9; 1
leaves it free) replaced, both kernels alike, compiled with nvcc at once, and
launched through its own ``gibbs_matvec`` (K2) and ``rbf_matvec`` (K6) at
the gate's shape (16384², D 2, R 9; K2 on a trained-like pose, K6 on
z = x/ℓ at a trained-like ℓ) with the column splits that
``matvec.column_splits`` gives for 4, 8 and 16 blocks an SM.  Prints one
JSON line per (kernel, variant, blocks an SM): the median ms of 40 calls
(CUDA events), the splits, nvcc's registers and spills, and the largest
difference from the plain version; then the card's name and power limit.
``--baseline PATH`` adds another source of the same C interface (for
example the parent commit's ``gibbs_matvec.cu``, whose K6 walked a row a
thread in 128-row blocks: ``--baseline-k6-rows 128``), timed the same way.
This is how the shipped choices were made: K2 2 rows a thread, its
registers capped for 4 blocks an SM, columns split for 8 blocks an SM; K6
4 rows a thread, its registers free, columns split for 4 blocks an SM.

Run from the repository root on a CUDA card:
    python tools/bench_k2.py [--baseline PATH [--baseline-k6-rows N]]
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

VARIANTS = {"rows2_min4": (2, 4), "rows2_free": (2, 1), "rows4_min3": (4, 3), "rows4_free": (4, 1),
            "rows8_free": (8, 1)}
N, R = 16384, 9
K6_ROWS_DEFAULT = 128  # a row a thread, 128-thread blocks: K6's walk before it moved onto K2's


def build(name: str, rows: int, min_blocks: int, source=None):
    """Compile the variant into build/torch_kernels/k2var/; returns (library
    path, its walk's <2,9> register reports).  ``source``: another file of
    the same C interface, built as it is."""
    if source is None:
        src = matvec.SOURCE.read_text()
        for kernel in ("K2", "K6"):
            src = re.sub(rf"constexpr int k{kernel}RowsPerThread = \d+;",
                         f"constexpr int k{kernel}RowsPerThread = {rows};", src)
            src = re.sub(rf"constexpr int k{kernel}MinBlocks = \d+;",
                         f"constexpr int k{kernel}MinBlocks = {min_blocks};", src)
        include = matvec.SOURCE.parent
    else:
        src, include = source.read_text(), source.parent
    out = BUILD_DIR / "k2var"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-I", str(include), "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    summary = cs.ptxas_summary(proc.stdout + proc.stderr)
    return so, {k: v for k, v in summary.items() if k.startswith("gibbs_rows_kernel") and k.endswith(",2,9>")}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, help="another gibbs_matvec.cu of the same C interface")
    ap.add_argument("--baseline-k6-rows", type=int, default=K6_ROWS_DEFAULT,
                    help="rows a block of the baseline's K6 owns (its column splits follow)")
    args = ap.parse_args()
    dev = torch.device("cuda")
    jobs = {name: (rows, mb, None) for name, (rows, mb) in VARIANTS.items()}
    if args.baseline:
        jobs["baseline"] = (0, 0, args.baseline.resolve())
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda kv: build(kv[0], *kv[1]), jobs.items())))
    gen = torch.Generator().manual_seed(3)
    x, _ = _data(N)
    x = x.to(dev)
    ell = torch.exp(0.3 * torch.randn(N, 2, generator=gen)).to(dev).contiguous()
    v = torch.randn(N, R, generator=gen).to(dev)
    z = (x / torch.exp(0.3 * torch.randn(2, generator=gen)).to(dev)).contiguous()
    refs = {"gibbs_matvec": matvec.gibbs_gram_matvec_plain(x, ell, x, ell, v),
            "rbf_matvec": matvec.rbf_gram_matvec_plain(z, z, v)}
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, (so, regs) in built.items():
        lib = ctypes.CDLL(str(so))
        lib.gibbs_matvec.argtypes = [p, p, i, p, p, i, i, p, i, i, p, i, p, i, i, p]
        lib.gibbs_matvec.restype = i
        lib.rbf_matvec.argtypes = [p, i, p, i, i, p, i, i, p, i, p, i, i, p]
        lib.rbf_matvec.restype = i
        k2_rows = 256 * VARIANTS[name][0] if name in VARIANTS else matvec.K2_ROWS
        for kernel, rows in (("gibbs_matvec", k2_rows),
                             ("rbf_matvec", k2_rows if name in VARIANTS else args.baseline_k6_rows)):
            for per_sm in (4, 8, 16):
                matvec.BLOCKS_PER_SM = per_sm
                splits, per = matvec.column_splits(N, N, 1, sms, rows)
                out = torch.empty(N, R, device=dev)
                part = torch.empty(splits * N * R, device=dev)

                def call():
                    if kernel == "gibbs_matvec":
                        err = lib.gibbs_matvec(x.data_ptr(), ell.data_ptr(), N, x.data_ptr(), ell.data_ptr(), N, 2,
                                               v.data_ptr(), R, R, out.data_ptr(), R, part.data_ptr(), splits, per,
                                               stream)
                    else:
                        err = lib.rbf_matvec(z.data_ptr(), N, z.data_ptr(), N, 2, v.data_ptr(), R, R, out.data_ptr(),
                                             R, part.data_ptr(), splits, per, stream)
                    if err != 0:
                        raise RuntimeError(f"{name} {kernel}: CUDA error {err}")

                call()
                torch.cuda.synchronize()
                ms = statistics.median(cs.block_times_ms(call, 40))
                print(json.dumps({"kernel": kernel, "variant": name,
                                  "rows_a_thread": VARIANTS[name][0] if name in VARIANTS else None,
                                  "min_blocks": VARIANTS[name][1] if name in VARIANTS else None,
                                  "rows_a_block": rows, "blocks_per_sm": per_sm, "splits": splits, "ms": ms,
                                  "ptxas": regs, "max_abs_diff_plain": float((out - refs[kernel]).abs().max())}),
                      flush=True)
    print(cs.nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
