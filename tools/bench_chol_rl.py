"""K5, K10a and K10c (``csrc/chol_rl.cuh``) built as they are and as
variants, timed side by side on the card.

A variant is a list of (text, replacement) pairs applied to ``chol_rl.cuh``,
or (file, text, replacement) triples applied to that file, in a copy of
``csrc/`` under ``build/chol_rl_variants/<name>/``; each is built with the
port's nvcc flags and loaded in place of the wrappers' libraries.  For each
build and round (two rounds, in turns): K5 at N = 8192 on the dense run's
Gram at init (its error from float64 and a bitwise repeat), K10a at
N = 1280 (random SPD) and 1024 (the dense run's Gram) and K10c at
N = 8192 and 4096 (the dense run's Grams), median ms of CUDA events over
blocks of calls; then potrf's times, and each build's device time by
kernel over three calls (``torch.profiler``).  One JSON line per
measurement.

Run from the repository root on a CUDA card:
    python tools/bench_chol_rl.py ['{"name": [["text", "replacement"], ["file", "text", "replacement"], ...], ...}']
"""

import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from nonstationary_precip_tpu_torch.experiments import exact_largen  # noqa: E402
from nonstationary_precip_tpu_torch.ops import chol_blocked, chol_stream, cuda_build  # noqa: E402


def build(name: str, subs: list) -> dict:
    """{wrapper module name: library} of a copy of csrc/ with ``subs`` applied."""
    d = ROOT / "build" / "chol_rl_variants" / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC, d)
    for sub in subs:
        file, old, new = sub if len(sub) == 3 else ("chol_rl.cuh", *sub)
        text = (d / file).read_text()
        if old not in text:
            raise ValueError(f"{name}: {old!r} is not in {file}")
        (d / file).write_text(text.replace(old, new))
    libs, log = {}, ""
    for src in ("chol_stream", "chol_blocked", "chol_stream_v1"):
        so = d / f"lib{src}.so"
        proc = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(d / f"{src}.cu")],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{proc.stderr[-3000:]}")
        log = proc.stdout + proc.stderr
        lib = ctypes.CDLL(str(so))
        getattr(lib, src).argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        getattr(lib, src).restype = ctypes.c_int
        libs[src] = lib
    print(json.dumps({"build": name, "ptxas": cs.ptxas_summary(log)}), flush=True)
    return libs


def use(libs: dict):
    chol_stream._lib, chol_blocked._lib = libs["chol_stream"], libs["chol_blocked"]
    chol_stream._v1_lib = libs["chol_stream_v1"]


def main():
    variants = {"as_is": [], **(json.loads(sys.argv[1]) if len(sys.argv) > 1 else {})}
    dev = torch.device("cuda")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi_line()}), flush=True)
    built = {name: build(name, subs) for name, subs in variants.items()}
    a8 = cs.dense_gram(exact_largen, 8192, dev)
    ref8 = torch.linalg.cholesky(a8.double())
    gen = torch.Generator().manual_seed(5)
    b = torch.randn(1280, 1280, generator=gen, dtype=torch.float64)
    a12 = (b @ b.T / 1280 + torch.eye(1280, dtype=torch.float64)).float().to(dev)
    a10 = cs.dense_gram(exact_largen, 1024, dev)
    a4 = cs.dense_gram(exact_largen, 4096, dev)
    k5, k10a = chol_stream.streaming_cholesky_cuda, chol_blocked.blocked_cholesky_cuda
    k10c = chol_stream.streaming_cholesky_v1_cuda
    for rnd in range(2):
        for name, libs in built.items():
            use(libs)
            l = k5(a8)
            print(json.dumps({"round": rnd, "build": name,
                              "k5_8192_ms": statistics.median(cs.block_times_ms(lambda: k5(a8), 20)),
                              "k10a_1280_ms": statistics.median(cs.block_times_ms(lambda: k10a(a12), 60)),
                              "k10a_1024_ms": statistics.median(cs.block_times_ms(lambda: k10a(a10), 60)),
                              "k10c_8192_ms": statistics.median(cs.block_times_ms(lambda: k10c(a8), 20)),
                              "k10c_4096_ms": statistics.median(cs.block_times_ms(lambda: k10c(a4), 20)),
                              "k10c_vs_f64": float((k10c(a8).double() - ref8).abs().max()),
                              "k5_vs_f64": float((l.double() - ref8).abs().max()),
                              "k5_bitwise": bool(torch.equal(l, k5(a8)))}), flush=True)
    print(json.dumps({"potrf_8192_ms": statistics.median(cs.block_times_ms(lambda: torch.linalg.cholesky(a8), 20)),
                      "potrf_1280_ms": statistics.median(cs.block_times_ms(lambda: torch.linalg.cholesky(a12), 60))}),
          flush=True)
    from torch.profiler import ProfilerActivity, profile

    for name, libs in built.items():
        use(libs)
        for what, fn, x in (("k5_8192", k5, a8), ("k10a_1280", k10a, a12), ("k10c_8192", k10c, a8)):
            fn(x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    fn(x)
                torch.cuda.synchronize()
            by_kernel = {e.key.split("(")[0]: e.device_time_total / 3e3 for e in prof.key_averages()
                         if e.device_time_total > 0}
            print(json.dumps({"build": name, "call": what, "device_ms_by_kernel": by_kernel}), flush=True)


if __name__ == "__main__":
    main()
