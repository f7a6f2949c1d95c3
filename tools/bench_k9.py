"""K9 (the Gibbs cross-Gram, csrc/gibbs_gram.cu) beside another tree's, by
device time and by what a caller pays, and K2 (csrc/gibbs_matvec.cu, which
shares K9's d = 2 element) beside the other tree's K2.

Builds this tree's ``gibbs_gram.cu`` at each register tile in ``ROWS``
(rows a thread, ``kRowsPerThread``, rewritten in a copy of the source under
``build/k9var``; 16 times that rows by 64 columns a block) and, with ``--baseline DIR``, ``DIR/gibbs_gram.cu`` with DIR's own
headers (for example the parent commit's ``csrc/``, unpacked with
``git archive`` under ``build/``), plus this tree's and DIR's
``gibbs_matvec.cu``; every nvcc run at once.  Then, at the shapes the
paths give K9 (the Gibbs rows' predictive at N = 1280: 1280², 256 × 1280
and 256²; the slice's field prediction: 316², 394² and 394 × 316) on random
payloads (x uniform in [-2, 2], ℓ = exp(0.3·N(0, 1))), in turns (baseline,
each tile, each tile again, baseline) for each shape:
  * ``device_ms``: the median duration of ``--calls`` launches as
    torch.profiler traces them (the kernel alone);
  * ``call_ms``: the median of CUDA events around blocks of 10 calls through
    a wrapper that does what ``ops/gibbs_gram.gibbs_gram_cuda`` does
    (``.contiguous()``, ``torch.empty``, the device context, the ctypes
    call): what a caller pays, the host included;
  * the largest error from float64 relative to its largest entry, the plain
    version's beside it, and whether every tile of this tree gives the
    same bits.
Then K2 (``gibbs_rows_kernel<GibbsElem,2,9>``) and K3
(``gibbs_rows_kernel<PanelElem,2,17>``, which shares K2's row and column
factors) of both trees at the large-N gate's shape (16384², R 9 and 8
probes' 1 + 2·8 factors, ``gibbs_largen._data`` at a trained-like ℓ):
nvcc's registers and spills of each, and whether their outputs are equal
bit for bit.  With ``--predictive`` (and ``--baseline``), the dense Gibbs
rows' trained predictive (``exact_largen.gibbs_dense`` at N = 1024 and
1280, 20 steps, as ``chip_smoke.py`` trains them; ``gibbs_predict``, whose
three Grams go through K9) timed with the baseline's K9 library and with
this tree's in turns (baseline, this tree, this tree, baseline): the median
of CUDA events around blocks of 10 calls.  Last, the card's name and power
limit.  One JSON line each.

Run from the repository root on a CUDA card:
    python tools/bench_k9.py [--baseline DIR [--predictive]] [--calls 60]
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
from nonstationary_precip_tpu_torch.kernels.gibbs import gibbs_gram_reference  # noqa: E402
from nonstationary_precip_tpu_torch.ops import gibbs_gram, matvec  # noqa: E402
from nonstationary_precip_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC, NVCC_FLAGS, nvcc  # noqa: E402

ROWS = (2, 4, 8)
SHAPES = ((1280, 1280), (256, 1280), (256, 256), (316, 316), (394, 394), (394, 316))
K2_N, K2_R = 16384, 9
WALK = {"K2": "gibbs_rows_kernel<GibbsElem,2,9>", "K3": "gibbs_rows_kernel<PanelElem,2,17>"}
K3_FW = 17
OUT = BUILD_DIR / "k9var"


ROWS_DECL = r"constexpr int kRowsPerThread = (\d+);"


def rows_source(rows: int) -> Path:
    """A copy of this tree's ``gibbs_gram.cu`` with ``rows`` rows a thread."""
    text, count = re.subn(ROWS_DECL, f"constexpr int kRowsPerThread = {rows};", gibbs_gram.SOURCE.read_text())
    if count != 1:
        raise RuntimeError(f"{gibbs_gram.SOURCE} declares kRowsPerThread {count} times")
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"gibbs_gram_rows{rows}.cu"
    path.write_text(text)
    return path


def build(name: str, source: Path, include: Path) -> tuple:
    """nvcc of ``source`` with ``include``'s headers into OUT; (library,
    {kernel: "R regs, S spill bytes"})."""
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"lib{name}.so"
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-I", str(include), "-o", str(so), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    if hasattr(lib, "gibbs_gram"):
        # the stacked entry takes a member count after d; an older source does not
        lib.stacked = "int nt," in source.read_text()
        lib.gibbs_gram.argtypes = [p, p, i, p, p, i, i] + [i] * lib.stacked + [p, p]
        lib.gibbs_gram.restype = i
    else:
        lib.gibbs_matvec.argtypes = [p, p, i, p, p, i, i, p, i, i, p, i, p, i, i, p]
        lib.gibbs_matvec.restype = i
        lib.gibbs_panel_grads.argtypes = [p, p, p, i, p, p, p, i, i, i, p, p, p, p, i, i, p]
        lib.gibbs_panel_grads.restype = i
    return lib, cs.ptxas_summary(proc.stdout + proc.stderr)


def gram_call(lib, x1, l1, x2, l2):
    """What ``gibbs_gram_cuda`` does around the launch, on ``lib``."""
    x1, l1, x2, l2 = (t.contiguous() for t in (x1, l1, x2, l2))
    (n1, d), n2 = x1.shape, x2.shape[0]
    out = torch.empty((n1, n2), dtype=torch.float32, device=x1.device)
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        err = lib.gibbs_gram(x1.data_ptr(), l1.data_ptr(), n1, x2.data_ptr(), l2.data_ptr(), n2, d,
                             *([1] if lib.stacked else []), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gibbs_gram launch failed: CUDA error {err}")
    return out


def payload(gen, n: int, dev) -> tuple:
    x = (torch.rand(n, 2, generator=gen) * 4 - 2).to(dev)
    ell = torch.exp(0.3 * torch.randn(n, 2, generator=gen)).to(dev)
    return x, ell


def rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a.double() - ref).abs().max() / ref.abs().max())


def k2_out(lib, x, ell, v, splits: int, per: int) -> torch.Tensor:
    out = torch.empty(K2_N, K2_R, device=x.device)
    part = torch.empty(splits * K2_N * K2_R, device=x.device)
    err = lib.gibbs_matvec(x.data_ptr(), ell.data_ptr(), K2_N, x.data_ptr(), ell.data_ptr(), K2_N, 2, v.data_ptr(),
                           K2_R, K2_R, out.data_ptr(), K2_R, part.data_ptr(), splits, per,
                           torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gibbs_matvec launch failed: CUDA error {err}")
    return out


def k3_out(lib, x, ell, f1, f2, splits: int, per: int) -> torch.Tensor:
    gx, gl = torch.empty(K2_N, 2, device=x.device), torch.empty(K2_N, 2, device=x.device)
    sp = torch.empty(K2_N, device=x.device)
    part = torch.empty(splits * K2_N * 5, device=x.device)
    err = lib.gibbs_panel_grads(x.data_ptr(), ell.data_ptr(), f1.data_ptr(), K2_N, x.data_ptr(), ell.data_ptr(),
                                f2.data_ptr(), K2_N, 2, K3_FW, gx.data_ptr(), gl.data_ptr(), sp.data_ptr(),
                                part.data_ptr(), splits, per, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gibbs_panel_grads launch failed: CUDA error {err}")
    return torch.cat([gx.flatten(), gl.flatten(), sp])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, help="another tree's csrc/ (gibbs_gram.cu, gibbs_matvec.cu)")
    ap.add_argument("--calls", type=int, default=60)
    ap.add_argument("--predictive", action="store_true", help="time the Gibbs predictive with each tree's K9")
    args = ap.parse_args()
    dev = torch.device("cuda")
    jobs = {f"rows{r}": (rows_source(r), CSRC) for r in ROWS}
    jobs["k2"] = (matvec.SOURCE, CSRC)
    if args.baseline:
        base = args.baseline.resolve()
        jobs["baseline"] = (base / "gibbs_gram.cu", base)
        jobs["k2_baseline"] = (base / "gibbs_matvec.cu", base)
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda kv: build(kv[0], *kv[1]), jobs.items())))
    for name, (_, ptxas) in built.items():
        print(json.dumps({"build": name, "ptxas": ptxas}), flush=True)
    grams = [name for name in built if not name.startswith("k2")]
    order = (["baseline"] if args.baseline else []) + [f"rows{r}" for r in ROWS]
    turns = order + order[::-1]
    gen = torch.Generator().manual_seed(9)
    for n1, n2 in SHAPES:
        x1, l1 = payload(gen, n1, dev)
        x2, l2 = (x1, l1) if n2 == n1 else payload(gen, n2, dev)  # a square Gram is K(x, x)
        ref = gibbs_gram_reference(x1.double(), l1.double(), x2.double(), l2.double())
        plain = gibbs_gram_reference(x1, l1, x2, l2)
        outs = {name: gram_call(built[name][0], x1, l1, x2, l2) for name in grams}
        torch.cuda.synchronize()
        rows = {name: {"device_ms": [], "call_ms": []} for name in grams}
        for name in turns:
            lib = built[name][0]

            def call():
                return gram_call(lib, x1, l1, x2, l2)

            durations = [(end - start) / 1e3 for kname, start, end in cs.device_kernels(call, args.calls)
                         if "gibbs_gram_kernel" in kname]
            rows[name]["device_ms"].append(statistics.median(durations))
            rows[name]["call_ms"].append(statistics.median(cs.block_times_ms(call, args.calls)))
        same = all(torch.equal(outs[f"rows{r}"], outs[f"rows{ROWS[0]}"]) for r in ROWS)
        b_ms, b_by = cs.bound(gibbs_gram.gram_ops(n1, n2, 2), gibbs_gram.gram_bytes(n1, n2, 2))
        for name in grams:
            print(json.dumps({"shape": [n1, n2], "variant": name,
                              "device_ms": statistics.median(rows[name]["device_ms"]),
                              "call_ms": statistics.median(rows[name]["call_ms"]), "turns": rows[name],
                              "vs_f64": rel(outs[name], ref), "plain_vs_f64": rel(plain, ref),
                              "tiles_bitwise_equal": same, "bound_ms": b_ms, "bound_by": b_by}), flush=True)

    x, _ = _data(K2_N)
    x = x.to(dev).contiguous()
    ell = torch.exp(0.3 * torch.randn(K2_N, 2, generator=gen)).to(dev).contiguous()
    v = torch.randn(K2_N, K2_R, generator=gen).to(dev)
    f1, f2 = (torch.randn(K2_N, K3_FW, generator=gen).to(dev) for _ in range(2))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, per = matvec.column_splits(K2_N, K2_N, 1, sms, matvec.K2_ROWS)
    k3_splits, k3_per = matvec.column_splits(K2_N, K2_N, 1, sms, matvec.ROWS, matvec.K3_BLOCKS_PER_SM)
    libs = [name for name in built if name.startswith("k2")]
    k2 = {name: k2_out(built[name][0], x, ell, v, splits, per) for name in libs}
    k3 = {name: k3_out(built[name][0], x, ell, f1, f2, k3_splits, k3_per) for name in libs}
    torch.cuda.synchronize()
    print(json.dumps({"ptxas": {name: {k: built[name][1].get(w) for k, w in WALK.items()} for name in libs},
                      "k2_bitwise_equal": all(torch.equal(o, k2["k2"]) for o in k2.values()),
                      "k3_bitwise_equal": all(torch.equal(o, k3["k2"]) for o in k3.values()),
                      "compared": libs}), flush=True)
    if args.predictive and args.baseline:
        shipped = int(re.search(ROWS_DECL, gibbs_gram.SOURCE.read_text()).group(1))
        predictive_turns({"baseline": built["baseline"][0], "this_tree": built[f"rows{shipped}"][0]})
    print(cs.nvidia_smi_line(), flush=True)


def predictive_turns(libs: dict):
    """The trained Gibbs predictive at each dense row's N with each K9
    library in turns; one JSON line per N."""
    from nonstationary_precip_tpu_torch.experiments import exact_largen

    out = exact_largen.gibbs_dense(ns=cs.GIBBS_NS, dev="cuda")
    restore = gibbs_gram._lib
    try:
        for n, o in out.items():
            x, y = (t.cuda() for t in exact_largen.gibbs_data((n,))[n])

            def predict():
                return exact_largen.gibbs_predict(o["model"], x, y)

            blocks = {name: [] for name in libs}
            for name in ("baseline", "this_tree", "this_tree", "baseline"):
                gibbs_gram._lib = libs[name]
                blocks[name].append(statistics.median(cs.block_times_ms(predict, 20)))
            print(json.dumps({"predictive_n": n, "ms": {k: statistics.median(v) for k, v in blocks.items()},
                              "blocks_ms": blocks}), flush=True)
    finally:
        gibbs_gram._lib = restore


if __name__ == "__main__":
    main()
