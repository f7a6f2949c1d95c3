"""K2 (the Gibbs Gram·V, csrc/gibbs_matvec.cu) built with other register
tiles and occupancies, timed side by side on the card.

Each variant is the shipped source with ``kK2RowsPerThread`` (rows a
thread owns) and ``kK2MinBlocks`` (blocks an SM the compiler must fit at
d = 2, R ≤ 9; 1 leaves it free) replaced, compiled with nvcc at once, and
launched through its own ``gibbs_matvec`` at the gate's shape (16384²,
D 2, R 9, a trained-like pose) with the column splits that
``matvec.column_splits`` gives for 4, 8 and 16 blocks an SM.  Prints one
JSON line per (variant, blocks an SM): the median ms of 40 calls (CUDA
events), the splits, nvcc's registers and spills, and the largest
difference from the plain version; then the card's name and power limit.
This is how the shipped 2 rows a thread and 4 blocks an SM were chosen.

Run from the repository root on a CUDA card:
    python tools/bench_k2.py
"""

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


def build(name: str, rows: int, min_blocks: int):
    """Compile the variant into build/torch_kernels/k2var/; returns (library
    path, its gibbs_rows_kernel<2,9> register report)."""
    src = matvec.SOURCE.read_text()
    src = re.sub(r"constexpr int kK2RowsPerThread = \d+;", f"constexpr int kK2RowsPerThread = {rows};", src)
    src = re.sub(r"constexpr int kK2MinBlocks = \d+;", f"constexpr int kK2MinBlocks = {min_blocks};", src)
    out = BUILD_DIR / "k2var"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-I", str(matvec.SOURCE.parent), "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    return so, cs.ptxas_summary(proc.stdout + proc.stderr)["gibbs_rows_kernel<2,9>"]


def main():
    dev = torch.device("cuda")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(lambda kv: build(kv[0], *kv[1]), VARIANTS.items())))
    gen = torch.Generator().manual_seed(3)
    x, _ = _data(N)
    x = x.to(dev)
    ell = torch.exp(0.3 * torch.randn(N, 2, generator=gen)).to(dev).contiguous()
    v = torch.randn(N, R, generator=gen).to(dev)
    ref = matvec.gibbs_gram_matvec_plain(x, ell, x, ell, v)
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, (so, regs) in built.items():
        lib = ctypes.CDLL(str(so))
        lib.gibbs_matvec.argtypes = [p, p, i, p, p, i, i, p, i, i, p, i, p, i, i, p]
        lib.gibbs_matvec.restype = i
        rows = 256 * VARIANTS[name][0]
        for per_sm in (4, 8, 16):
            matvec.BLOCKS_PER_SM = per_sm
            splits, per = matvec.column_splits(N, N, 1, sms, rows)
            out = torch.empty(N, R, device=dev)
            part = torch.empty(splits * N * R, device=dev)

            def call():
                err = lib.gibbs_matvec(x.data_ptr(), ell.data_ptr(), N, x.data_ptr(), ell.data_ptr(), N, 2,
                                       v.data_ptr(), R, R, out.data_ptr(), R, part.data_ptr(), splits, per, stream)
                if err != 0:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            ms = statistics.median(cs.block_times_ms(call, 40))
            print(json.dumps({"variant": name, "rows_a_thread": VARIANTS[name][0], "min_blocks": VARIANTS[name][1],
                              "blocks_per_sm": per_sm, "splits": splits, "ms": ms, "ptxas": regs,
                              "max_abs_diff_plain": float((out - ref).abs().max())}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
