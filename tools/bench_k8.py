"""K8 (the fused Gibbs MAP solve, csrc/gibbs_fused.cu) beside another tree's
source, and the kernels that share its factorisation (K10a, K5, K10c on
csrc/chol_rl.cuh), timed side by side on the card.

Builds ``gibbs_fused.cu``, ``chol_blocked.cu`` (K10a), ``chol_stream.cu``
(K5) and ``chol_stream_v1.cu`` (K10c) from this tree's ``csrc/`` and, with
``--baseline DIR``, from another tree's (for example the parent commit's,
unpacked with ``git archive`` under ``build/``), plus a probe: this tree's
K8 with its ladder cut to the first attempt, whose time beside the shipped
K8's is the span of the happy path's empty attempts 2 and 3.  Every build
runs at once; each prints nvcc's registers and spills, and for the chol_rl
kernels whether they and the runtime's registers, local bytes and shared
memory equal the baseline's.  Then, in turns
(baseline, this tree, probe, probe, this tree, baseline), median ms of
CUDA events over 60 calls: K8 at N = 1024 and 1280 on the Gibbs rows'
trained pose (``exact_largen.gibbs_dense``'s 20 steps, as
``chip_smoke.py`` trains them), with its error from the plain version and
its attempt; K10a at 1280 on the same pose's noisy Gram; K5 and K10c at
N = 8192 on the dense run's Gram (20 calls).  Then whether each factor
of K10a, K5 and K10c equals the baseline's bit for bit, each K8 build's
device time by kernel in a call at N = 1280 beside K10a's
(torch.profiler), and the card's name and power limit.

Run from the repository root on a CUDA card:
    python tools/bench_k8.py [--baseline DIR]
"""

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from nonstationary_precip_tpu_torch.experiments import exact_largen  # noqa: E402
from nonstationary_precip_tpu_torch.kernels.gibbs import gibbs_gram_reference  # noqa: E402
from nonstationary_precip_tpu_torch.ops import chol_stream, cuda_build, gibbs_fused  # noqa: E402

SOURCES = ("gibbs_fused", "chol_blocked", "chol_stream", "chol_stream_v1")
OUT = ROOT / "build" / "k8var"
# the chol_rl kernels of each library, by role: the prefix of their names in
# ptxas's report (with K8's hooks and before them)
ROLES = {"diag": "diag_kernel", "panel": "panel_kernel", "syrk_column": "syrk_kernel<0,",
         "syrk_triangle": "syrk_kernel<1,"}
P, I = ctypes.c_void_p, ctypes.c_int


def c_params(source: Path, fn: str) -> int:
    """Parameters of the ``extern "C"`` function ``fn`` in ``source``."""
    m = re.search(rf"\bint {fn}\(([^)]*)\)", source.read_text())
    return len(m.group(1).split(","))


def build(name: str, csrc: Path, one_attempt: bool = False) -> dict:
    """{source: (library, ptxas summary)} of a copy of ``csrc``."""
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d, ignore=shutil.ignore_patterns("*.so"))
    if one_attempt:
        f = d / "gibbs_fused.cu"
        text = f.read_text()
        if "attempt < 3" not in text:
            raise ValueError("gibbs_fused.cu: no three-attempt loop to cut")
        f.write_text(text.replace("attempt < 3", "attempt < 1"))

    def one(src):
        so = d / f"lib{src}.so"
        proc = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(d / f"{src}.cu")],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{name} {src}: nvcc failed:\n{proc.stderr[-3000:]}")
        lib = ctypes.CDLL(str(so))
        if src == "gibbs_fused":
            k = c_params(d / "gibbs_fused.cu", "gibbs_fused")
            lib.gibbs_fused.argtypes = [P, P, I, I, P, P, P] + [P] * (k - 9) + [I, P]
        else:
            getattr(lib, src).argtypes = [P, I, P]
        return src, (lib, cs.ptxas_summary(proc.stdout + proc.stderr), d)

    srcs = ("gibbs_fused",) if one_attempt else SOURCES
    with ThreadPoolExecutor(len(srcs)) as pool:
        return dict(pool.map(one, srcs))


def k8_call(lib, d: Path, x, ell, y, s2, noise):
    """One call of a gibbs_fused build (either C interface); returns
    (a closure that calls it, its outputs (L, α, state))."""
    n, dim = x.shape
    n_pad = -(-n // 128) * 128
    dev = x.device
    l = torch.zeros(n_pad, n_pad, device=dev)
    alpha = torch.empty(n_pad, device=dev)
    state = torch.zeros(2, dtype=torch.int32, device=dev)
    s2t, nt = (torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(1).contiguous() for v in (s2, noise))
    scratch = []
    if c_params(d / "gibbs_fused.cu", "gibbs_fused") == 16:  # the workspace design: A, cbuf, ljj, linv
        scratch = [torch.empty(n_pad, n_pad, device=dev), torch.empty(n_pad, 128, device=dev),
                   torch.empty(128, 128, device=dev), torch.empty(128, 128, device=dev)]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call():
        l.zero_()
        state.zero_()
        ptrs = [scratch[0].data_ptr(), l.data_ptr(), alpha.data_ptr(), *(t.data_ptr() for t in scratch[1:])] \
            if scratch else [l.data_ptr(), alpha.data_ptr()]
        err = lib.gibbs_fused(x.data_ptr(), ell.data_ptr(), n, dim, y.data_ptr(), s2t.data_ptr(), nt.data_ptr(),
                              *ptrs, state.data_ptr(), n_pad, stream)
        if err != 0:
            raise RuntimeError(f"gibbs_fused: CUDA error {err}")

    return call, (l[:n, :n], alpha[:n], state)


def chol_call(lib, src: str, a: torch.Tensor):
    """A closure that factors the padded lower triangle of ``a`` in place
    with one chol_rl library, and the factor it leaves."""
    pad = chol_stream.PANEL if src != "chol_blocked" else 128
    w0 = torch.tril(chol_stream.padded(a, pad)).contiguous()
    w = torch.empty_like(w0)
    stream = torch.cuda.current_stream(a.device).cuda_stream

    def call():
        w.copy_(w0)
        if getattr(lib, src)(w.data_ptr(), w.shape[0], stream) != 0:
            raise RuntimeError(f"{src}: launch failed")

    return call, w


def by_kernel_ms(call) -> dict:
    """{kernel: (launches, device ms)} of one call of ``call``, the mean
    over three traced calls (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            m = re.search(r"(\w+_kernel(?:<[^()]*>)?)\(", e.key)
            name = m.group(1) if m else e.key
            count, ms = out.get(name, (0, 0.0))
            out[name] = (count + e.count // 3, ms + e.device_time_total / 3e3)
    return out


def same_resources(mine: dict, theirs: dict) -> dict:
    """For each chol_rl role present in both ptxas summaries, whether the
    registers and spills are equal."""
    out = {}
    for role, prefix in ROLES.items():
        a = [v for k, v in mine.items() if k.startswith(prefix)]
        b = [v for k, v in theirs.items() if k.startswith(prefix)]
        if a and b:
            out[role] = {"this": a[0], "baseline": b[0], "equal": a[0] == b[0]}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, help="another tree's csrc/ directory")
    args = ap.parse_args()
    dev = torch.device("cuda")
    jobs = {"this": (cuda_build.CSRC, False), "one_attempt": (cuda_build.CSRC, True)}
    if args.baseline:
        jobs["baseline"] = (args.baseline.resolve(), False)
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda kv: build(kv[0], *kv[1]), jobs.items())))
    for name, libs in built.items():
        print(json.dumps({"build": name, "ptxas": {src: ptx for src, (_, ptx, _) in libs.items()}}), flush=True)
    if "baseline" in built:
        print(json.dumps({"chol_rl_resources_vs_baseline": {
            src: same_resources(built["this"][src][1], built["baseline"][src][1])
            for src in ("chol_blocked", "chol_stream", "chol_stream_v1")}}), flush=True)
        # registers, local bytes, static and dynamic shared memory as the runtime reports them
        attrs = {}
        for src in ("chol_blocked", "chol_stream", "chol_stream_v1"):
            for b in ("this", "baseline"):
                out = (ctypes.c_int * 16)()
                fn = getattr(built[b][src][0], f"{src}_attributes")
                fn.argtypes = [P]
                if fn(out) != 0:
                    raise RuntimeError(f"{b} {src}_attributes failed")
                attrs.setdefault(src, {})[b] = list(out)
            attrs[src]["equal"] = attrs[src]["this"] == attrs[src]["baseline"]
        print(json.dumps({"chol_rl_attributes_vs_baseline": attrs}), flush=True)

    out = exact_largen.gibbs_dense(ns=cs.GIBBS_NS, dev="cuda")
    pay = cs.gibbs_payloads(exact_largen, out, dev)
    order = ["baseline", "this", "one_attempt", "one_attempt", "this", "baseline"]
    order = [b for b in order if b in built]
    times = {b: {} for b in built}
    for n in cs.GIBBS_NS:
        x, ell, y, s2, noise, _, _ = pay[f"{n}_trained"]
        lp, ap_, _ = gibbs_fused.gibbs_chol_solve_plain(x, ell, y, s2, noise)
        calls = {b: k8_call(built[b]["gibbs_fused"][0], built[b]["gibbs_fused"][2], x, ell, y, s2, noise)
                 for b in built}
        for b, (call, (l, alpha, state)) in calls.items():
            call()
            torch.cuda.synchronize()
            print(json.dumps({"build": b, "k8_n": n, "attempt": int(state[0]),
                              "L_rel_diff_plain": float((l - lp).abs().max() / lp.abs().max()),
                              "alpha_rel_diff_plain": float((alpha - ap_).abs().max() / ap_.abs().max())}),
                  flush=True)
        for b in order:
            times[b].setdefault(f"k8_{n}_ms", []).append(statistics.median(cs.block_times_ms(calls[b][0], 60)))
        k8_1280 = calls
        with torch.no_grad():
            a = s2 * gibbs_gram_reference(x, ell, x, ell) + noise * torch.eye(n, device=dev)
        if n == cs.GIBBS_NS[-1]:
            k10a = {b: chol_call(built[b]["chol_blocked"][0], "chol_blocked", a) for b in built if b != "one_attempt"}
    a8 = cs.dense_gram(exact_largen, 8192, dev)
    dense = {src: {b: chol_call(built[b][src][0], src, a8) for b in built if b != "one_attempt"}
             for src in ("chol_stream", "chol_stream_v1")}
    for what, calls, reps in (("k10a_1280", k10a, 60), ("k5_8192", dense["chol_stream"], 20),
                              ("k10c_8192", dense["chol_stream_v1"], 20)):
        for b in order:
            if b in calls:
                times[b].setdefault(f"{what}_ms", []).append(statistics.median(cs.block_times_ms(calls[b][0], reps)))
        if "baseline" in calls:
            for b in calls:
                calls[b][0]()
            torch.cuda.synchronize()
            print(json.dumps({"factor": what, "bitwise_equal_to_baseline":
                              bool(torch.equal(calls["this"][1], calls["baseline"][1]))}), flush=True)
    for b, t in times.items():
        print(json.dumps({"build": b, "ms": t}), flush=True)
    # where one call at N = 1280 spends its device time, by kernel: each K8
    # build, and K10a on the same pose's Gram (its tiles without K8's hooks)
    for b, (call, _) in k8_1280.items():
        print(json.dumps({"build": b, "k8_1280_device_ms_by_kernel": by_kernel_ms(call)}), flush=True)
    print(json.dumps({"build": "this", "k10a_1280_device_ms_by_kernel": by_kernel_ms(k10a["this"][0])}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
