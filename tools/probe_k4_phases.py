"""Where a K4 launch spends its time: ``csrc/svgp_precompute.cu`` and the
cluster header ``csrc/chol_inv_cluster.cuh`` built with ``%globaltimer``
stamps at their phase boundaries, read back after a call.

The copies under ``build/k4_phases/`` record, for thread 0 of the first CTA
of the first member and of the last member, the device clock in ns at: the
CTA's start, z/ℓ and the norms staged, the first try's tiles built (after
the cluster barrier), then for each block step k the leaf done, the panel
and row of L⁻¹ done, the operands copied and the update done (each after
its cluster barrier), the factor returned, the W tail done and the CTA's
end, and in the tail's first chunk and first pass, for each block k of
P, the row of L⁻¹ copied in, the barrier passed and the products done.  The timed call is the fifth of five back-to-back calls on the deep
GP's K_zz stack at init (50 members of M = 250, D 2, P 501).  Prints one
JSON line per member with the phase times in µs from the CTA's start, the
factor's and the tail's spans, and the shipped build's median ms beside
it (the stamps cost a few global stores); then the card's name and power
limit.

Run from the repository root on a CUDA card:
    python tools/probe_k4_phases.py
"""

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from nonstationary_precip_tpu_torch.ops import cuda_build, svgp_precompute  # noqa: E402

SLOTS = 64
STEPS = 8  # block steps at M = 250


def put(text, old, new, count=1):
    if text.count(old) != count:
        raise ValueError(f"source changed: {old!r} found {text.count(old)} times, expected {count}")
    return text.replace(old, new)


def instrumented(header: str, source: str) -> tuple:
    """(header, source) with the stamps in; raises if either no longer has
    a place this probe expects."""
    stamp = ("__device__ long long g_t[2][{n}];\n"
             "#define STAMP(q) if (threadIdx.x == 0 && (blockIdx.x == 0 || blockIdx.x == gridDim.x - "
             "static_cast<unsigned>(cluster.dim_blocks().x))) {{ long long v; "
             "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(v)); g_t[blockIdx.x == 0 ? 0 : 1][q] = v; }}\n")
    header = put(header, "namespace chol_cluster {\n", "namespace chol_cluster {\n" + stamp.format(n=SLOTS))
    header = put(header, "    if (tid == 0) flags[0] = 0;\n    cluster.sync();\n",
                 "    if (tid == 0) flags[0] = 0;\n    cluster.sync();\n    STAMP(2)\n")
    header = put(header, "      __syncthreads();\n      if (flags[1]) {",
                 "      __syncthreads();\n      if (k < 8) STAMP(3 + 4 * k)\n      if (flags[1]) {")
    sync = "      __syncthreads();\n      cluster.sync();\n"
    parts = header.split(sync)
    if len(parts) != 4:
        raise ValueError("chol_inv_cluster.cuh changed: three step barriers expected")
    header = "".join(p + sync + (f"      if (k < 8) STAMP({4 + i} + 4 * k)\n" if i < 3 else "")
                     for i, p in enumerate(parts[:3])) + parts[3]
    # the tail's first chunk: per block k of P, the L^-1 row copied, the
    # barrier passed (P's block in), the products done
    source = put(source, "  const int rank = static_cast<int>(cluster.block_rank());\n  const int tid = threadIdx.x;\n"
                 "  const int nb = chol_cluster::num_blocks(m);\n  const int nchunks",
                 "  const int rank = static_cast<int>(cluster.block_rank());\n  const int tid = threadIdx.x;\n"
                 "  const int nb = chol_cluster::num_blocks(m);\n  using chol_cluster::g_t;\n  const int nchunks")
    copied = "            if (g0 + g <= kb) *reinterpret_cast<float4*>(tb + g * kTile + r * kLd + 4 * c4) = v[g];\n        }\n"
    source = put(source, copied, copied + "        if (q == rank && g0 == 0) STAMP(38 + 3 * kb)\n")
    waited = "        __syncthreads();  // row kb's tiles and P's block kb are in\n"
    source = put(source, waited, waited + "        if (q == rank && g0 == 0) STAMP(39 + 3 * kb)\n")
    done = "        __syncthreads();  // every thread is done with tb and block kb's stage\n"
    source = put(source, done, done + "        if (q == rank && g0 == 0) STAMP(40 + 3 * kb)\n")
    source = put(source, "  const size_t mp = static_cast<size_t>(m) * p;\n",
                 "  const size_t mp = static_cast<size_t>(m) * p;\n  using chol_cluster::g_t;\n  STAMP(0)\n")
    source = put(source, "    sq[i] = acc;\n  }\n  __syncthreads();\n", "    sq[i] = acc;\n  }\n  __syncthreads();\n  STAMP(1)\n")
    source = put(source, "jit_out + b);\n", "jit_out + b);\n  STAMP(35)\n")
    source = put(source, "      w[b * mp + e] = nan;\n  }\n", "      w[b * mp + e] = nan;\n  }\n  __syncthreads();\n  STAMP(36)\n")
    source = put(source, "  cluster.sync();  // no CTA leaves", "  STAMP(37)\n  cluster.sync();  // no CTA leaves")
    tail = '}  // extern "C"'
    source = source.rstrip()
    if not source.endswith(tail):
        raise ValueError("csrc/svgp_precompute.cu changed: no extern \"C\" block at its end")
    source = (source[:-len(tail)] + "int k4_stamps(long long* out) "
              "{ return (int)cudaMemcpyFromSymbol(out, chol_cluster::g_t, sizeof(chol_cluster::g_t)); }\n"
              + tail + "\n")
    return header, source


def names() -> list:
    out = ["start", "staged", "tiles_built"]
    for k in range(STEPS):
        out += [f"step{k}_leaf", f"step{k}_substituted", f"step{k}_copied", f"step{k}_updated"]
    out += ["factored", "tail_done", "end"]
    for k in range(STEPS):
        out += [f"tail{k}_copied", f"tail{k}_waited", f"tail{k}_multiplied"]
    return out


def main():
    out_dir = ROOT / "build" / "k4_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    header, source = instrumented((cuda_build.CSRC / "chol_inv_cluster.cuh").read_text(),
                                  svgp_precompute.SOURCE.read_text())
    (out_dir / "chol_inv_cluster.cuh").write_text(header)
    (out_dir / "svgp_precompute.cu").write_text(source)
    so = out_dir / "libk4_phases.so"
    proc = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(out_dir), "-o", str(so),
                           str(out_dir / "svgp_precompute.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.svgp_precompute.argtypes = [p] * 8 + [i] * 4 + [ctypes.c_float, p]
    lib.svgp_precompute.restype = i
    lib.k4_stamps.argtypes, lib.k4_stamps.restype = [p], i

    import bench_k4  # noqa: E402  (tools/ is on the path: this file's directory)

    dev = torch.device("cuda")
    payload = bench_k4.kzz_at_init(dev)
    for _ in range(5):
        bench_k4.call(lib, payload)
    torch.cuda.synchronize()
    out = (ctypes.c_longlong * (2 * SLOTS))()
    if lib.k4_stamps(out):
        raise RuntimeError("cudaMemcpyFromSymbol failed")
    stamped = statistics.median(cs.block_times_ms(lambda: bench_k4.call(lib, payload), 40))
    shipped = statistics.median(cs.block_times_ms(lambda: svgp_precompute.svgp_precompute_cuda(*payload), 40))
    first = out[0]
    for member, base in ((0, 0), (payload[0].shape[0] - 1, SLOTS)):
        v = out[base:base + SLOTS]
        rec = {"member": member, "start_us": (v[0] - first) / 1e3,
               **{nm: (v[q] - v[0]) / 1e3 for q, nm in enumerate(names()) if q and v[q] >= v[0]}}
        rec["factor_us"] = rec["factored"]
        rec["tail_us"] = rec["tail_done"] - rec["factored"]
        rec["step_us"] = [rec[f"step{k}_updated"] - (rec[f"step{k - 1}_updated"] if k else rec["tiles_built"])
                          for k in range(STEPS)]
        rec["tail_chunk0_us"] = [[rec[f"tail{k}_copied"] - (rec[f"tail{k - 1}_multiplied"] if k else rec["factored"]),
                                  rec[f"tail{k}_waited"] - rec[f"tail{k}_copied"],
                                  rec[f"tail{k}_multiplied"] - rec[f"tail{k}_waited"]] for k in range(STEPS)]
        print(json.dumps(rec), flush=True)
    print(json.dumps({"stamped_ms": stamped, "shipped_ms": shipped}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
