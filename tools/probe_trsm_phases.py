"""Where a K11 launch spends its time: ``csrc/trsm.cu`` built with
``%globaltimer`` stamps at its phase boundaries, read back after a call.

The copy of the source under ``build/trsm_phases/`` records, for CTA (0, 0)
(the one that writes X_i) and CTA (0, 1) (one that updates W_{i+1}) of
every launch, the device clock in ns at: the CTA's start, the end of the
programmatic-dependency wait, the tiles and the pivots' reciprocals ready,
the end of each 32-row block's substitution and of its update of the rows
below, the tile solved, and the end of the CTA.  The timed call is the
fifth of five back-to-back calls at N = 1280 on a random SPD factor, at
K = 256 and 70.  One JSON line per launch and K, in µs from the CTA's
start (``start`` from the first launch's start).

Run from the repository root on a CUDA card:
    python tools/probe_trsm_phases.py
"""

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from nonstationary_precip_tpu_torch.ops import cuda_build, trsm  # noqa: E402

SLOTS = 16  # start, waited, tiles_in, 4 x (block_solved, block_applied), tile_solved, end


def instrumented(src: str) -> str:
    """``src`` with the stamps in; raises if the source no longer has a
    place this probe expects."""
    def put(text, old, new):
        if text.count(old) != 1:
            raise ValueError(f"csrc/trsm.cu changed: {old!r} not found once")
        return text.replace(old, new)

    src = put(src, "namespace {\n\nconstexpr int kB",
              "namespace {\n__device__ long long g_t[16][2][16];\n"
              "#define STAMP(q) if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y < 2) { long long v; "
              "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(v)); g_t[i0 / kB][blockIdx.y][q] = v; }\n"
              "constexpr int kB")
    start = "  // The next block row's launch may start now"
    src = put(src, start, "  STAMP(0)\n" + start)
    waited = '  asm volatile("griddepcontrol.wait;\\n" ::: "memory");\n'
    src = put(src, waited, waited + "  STAMP(1)\n")
    tiles_in = "  if (tid < kB) rinv[tid] = 1.f / Ld[tid * kLds + tid];\n  __syncthreads();\n"
    src = put(src, tiles_in, tiles_in + "  STAMP(2)\n")
    src = put(src, "    __syncthreads();\n    const int below",
              "    __syncthreads();\n    STAMP(3 + 2 * (r0 / 32))\n    const int below")
    src = put(src, "      __syncthreads();\n    }\n  }\n\n  if (solver)",
              "      __syncthreads();\n    }\n    STAMP(4 + 2 * (r0 / 32))\n  }\n\n  if (solver)")
    src = put(src, "  if (solver) {  // X_i's tile out", "  STAMP(11)\n  if (solver) {  // X_i's tile out")
    src = put(src, "= w[a];\n  }\n}", "= w[a];\n  }\n  __syncthreads();\n  STAMP(12)\n}")
    src = put(src, "    return;\n  }\n\n  // W_j's tile", "    __syncthreads();\n    STAMP(12)\n    return;\n  }\n\n  // W_j's tile")
    tail = '}  // extern "C"'
    src = src.rstrip()
    if not src.endswith(tail):
        raise ValueError("csrc/trsm.cu changed: no extern \"C\" block at its end")
    return (src[:-len(tail)] + "int trsm_stamps(long long* out) "
            "{ return (int)cudaMemcpyFromSymbol(out, g_t, sizeof(g_t)); }\n" + tail + "\n")


def main():
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi_line()}), flush=True)
    d = ROOT / "build" / "trsm_phases"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    (d / "trsm.cu").write_text(instrumented((cuda_build.CSRC / "trsm.cu").read_text()))
    proc = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(d / "libtrsm.so"), str(d / "trsm.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(d / "libtrsm.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.trsm.argtypes, lib.trsm.restype = [p, p, p, i, i, p], i
    lib.trsm_stamps.argtypes, lib.trsm_stamps.restype = [p], i
    trsm._lib = lib
    names = ["waited", "tiles_in", *(f"{w}_{b}" for b in range(4) for w in ("block_solved", "block_applied")),
             "tile_solved", "end"]
    gen = torch.Generator().manual_seed(2)
    n = 1280
    a = torch.randn(n, n, generator=gen, dtype=torch.float64)
    l = torch.linalg.cholesky(a @ a.T / n + 0.01 * torch.eye(n, dtype=torch.float64)).float().cuda()
    for k in (256, 70):
        b = torch.randn(n, k, generator=gen).cuda()
        for _ in range(5):
            trsm.trsm_cuda(l, b)
        torch.cuda.synchronize()
        out = (ctypes.c_longlong * (16 * 2 * SLOTS))()
        if lib.trsm_stamps(out):
            raise RuntimeError("cudaMemcpyFromSymbol failed")
        t = [[out[(r * 2 + c) * SLOTS:(r * 2 + c + 1) * SLOTS] for c in range(2)] for r in range(n // trsm.BLOCK)]
        first = t[0][0][0]
        for r, row in enumerate(t):
            rec = {"k": k, "launch": r}
            for c, v in enumerate(row):
                if v[0] == 0:  # the last launch has no updating CTA
                    continue
                rec["solver" if c == 0 else "updater"] = {
                    "start": (v[0] - first) / 1e3,
                    **{nm: (v[q + 1] - v[0]) / 1e3 for q, nm in enumerate(names) if v[q + 1] >= v[0]}}
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
