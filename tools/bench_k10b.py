"""K10b (the retry-free grid-batched (L, L⁻¹): K1's ``csrc/chol_inv_cluster.cu``
with ``max_tries = 0``) at two cluster sizes, beside another tree's K10b
and K1.

Builds this tree's ``chol_inv_cluster.cu`` at clusters of 8 (the shipped
size) and 4 (``-DK1_CLUSTER``) and, with ``--baseline ROOT`` (another
checkout, for example the parent commit unpacked with ``git archive``
under ``build/``), ROOT's ``chol_inv_cluster.cu`` (K1); every nvcc run at
once.  Then, on random SPD stacks (B Bᵀ / N + ½ I, as ``chip_smoke.py``'s
k10b makes them) at the deep GP's K_zz shape (50, 250), the slice's
(10, 316) and the window's top (3, 512):
  * each cluster size's median ms a call (CUDA events around blocks of 10
    calls of the library, in turns 8, 4, 4, 8), its L's and L⁻¹'s largest
    error from float64 relative to the largest entry, whether the sizes
    give the same bits, and the dynamic shared memory a CTA takes against
    the card's opt-in limit (a size that does not fit is reported and not
    run);
  * ``entry_ms``: K10b's entry ``ops.chol_inv.chol_inv_batched`` as a
    caller calls it, this tree's in this process and, with ``--baseline``,
    ROOT's in a child process (whatever kernel ROOT's entry launches) run
    before and after this tree's turns; the plain version beside them.
Last, whether K1 (``max_tries = 6``) of this tree and of ROOT give the same
bits at (10, 316) and (2, 384), and the card's name and power limit.  One
JSON line each.

Run from the repository root on a CUDA card:
    python tools/bench_k10b.py [--baseline ROOT] [--calls 60]
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

# the tree whose package this process imports: this file's, or the one a
# parent process names for its child (``entry_times``)
TREE_ENV = "BENCH_K10B_TREE"
ROOT = Path(os.environ.get(TREE_ENV) or Path(__file__).resolve().parent.parent)
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from nonstationary_precip_tpu_torch.ops import chol_inv  # noqa: E402
from nonstationary_precip_tpu_torch.ops.cuda_build import BUILD_DIR, NVCC_FLAGS, nvcc  # noqa: E402

SHAPES = ((50, 250), (10, 316), (3, 512))
K1_SHAPES = ((10, 316), (2, 384))
OUT = BUILD_DIR / "k10bvar"


def build(name: str, source: Path, flags: list):
    """nvcc of ``source`` with its own directory's headers; (library,
    ptxas lines)."""
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"lib{name}.so"
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, *flags, "-I", str(source.parent), "-o", str(so), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.chol_inv_cluster.argtypes = [p] * 4 + [i, i, ctypes.c_float, i, p]
    for fn in ("chol_inv_cluster_smem", "chol_inv_max_smem"):
        getattr(lib, fn).argtypes = [i]
    return lib, cs.ptxas_summary(proc.stdout + proc.stderr)


def cluster_call(lib, a: torch.Tensor, max_tries: int = 0):
    b, n, _ = a.shape
    l, li = torch.empty_like(a), torch.empty_like(a)
    jit = torch.empty(b, device=a.device)
    err = lib.chol_inv_cluster(a.data_ptr(), l.data_ptr(), li.data_ptr(), jit.data_ptr(), b, n, 1e-5, max_tries,
                               torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"chol_inv_cluster launch failed: CUDA error {err}")
    return l, li


def spd(b: int, n: int, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    m = torch.randn(b, n, n, generator=gen, dtype=torch.float64)
    return (m @ m.mT / n + 0.5 * torch.eye(n, dtype=torch.float64)).float().cuda()


def entry_times(calls: int) -> dict:
    """{(b, n): median ms a call of this process's tree's K10b entry}, and
    one JSON line each."""
    out = {}
    for b, n in SHAPES:
        a = spd(b, n, 173 + n)
        out[(b, n)] = statistics.median(cs.block_times_ms(lambda: chol_inv.chol_inv_batched(a), calls))
        print(json.dumps({"entry_shape": [b, n], "entry_ms": out[(b, n)], "tree": str(ROOT)}), flush=True)
    return out


def child_entry_times(root: Path, calls: int) -> dict:
    """``entry_times`` of ``root``'s package, in a child process."""
    proc = subprocess.run([sys.executable, __file__, "--entry-only", "--calls", str(calls)], cwd=root,
                          env={**os.environ, TREE_ENV: str(root)}, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the baseline's entry failed:\n{proc.stdout}{proc.stderr}")
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    return {tuple(r["entry_shape"]): r["entry_ms"] for r in rows}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, help="another checkout's root")
    ap.add_argument("--calls", type=int, default=60)
    ap.add_argument("--entry-only", action="store_true", help="time this tree's entry alone (the child's part)")
    args = ap.parse_args()
    if args.entry_only:
        entry_times(args.calls)
        return
    jobs = {"c8": (chol_inv.SOURCE, ["-DK1_CLUSTER=8"]), "c4": (chol_inv.SOURCE, ["-DK1_CLUSTER=4"])}
    base = args.baseline.resolve() if args.baseline else None
    if base:
        jobs["k1_baseline"] = (base / "nonstationary_precip_tpu_torch" / "csrc" / "chol_inv_cluster.cu", [])
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda kv: build(kv[0], *kv[1]), jobs.items())))
    for name, (_, ptxas) in built.items():
        print(json.dumps({"build": name, "ptxas": ptxas}), flush=True)
    entry = {"baseline": [child_entry_times(base, args.calls)]} if base else {}
    entry["this_tree"] = [entry_times(args.calls)]
    calls = {name: (lambda a, lib=built[name][0]: cluster_call(lib, a)) for name in ("c8", "c4")}
    for b, n in SHAPES:
        a = spd(b, n, 173 + n)
        l64 = torch.linalg.cholesky(a.double())
        eye = torch.eye(n, dtype=torch.float64, device=a.device)
        li64 = torch.linalg.solve_triangular(l64, eye.expand_as(l64), upper=False)
        rows, outs = {}, {}
        for name in calls:
            lib = built[name][0]
            smem, limit = lib.chol_inv_cluster_smem(n), lib.chol_inv_max_smem(0)
            rows[name] = {"variant": name, "shape": [b, n], "blocks_ms": [], "smem_bytes": smem,
                          "smem_limit": limit, "fits": smem <= limit}
            if smem > limit:
                continue
            outs[name] = calls[name](a)
            torch.cuda.synchronize()
            rows[name]["l_vs_f64"] = float((outs[name][0].double() - l64).abs().max() / l64.abs().max())
            rows[name]["linv_vs_f64"] = float((outs[name][1].double() - li64).abs().max() / li64.abs().max())
        order = list(outs)
        for name in order + order[::-1]:
            rows[name]["blocks_ms"].append(statistics.median(cs.block_times_ms(lambda: calls[name](a), args.calls)))
        same = all(torch.equal(outs[name][0], outs["c8"][0]) and torch.equal(outs[name][1], outs["c8"][1])
                   for name in order)
        plain = statistics.median(cs.block_times_ms(lambda: chol_inv.chol_inv_batched_plain(a), args.calls))
        for name, row in rows.items():
            if row["blocks_ms"]:
                row["ms"] = statistics.median(row["blocks_ms"])
            print(json.dumps({**row, "clusters_bitwise_equal": same, "plain_ms": plain}), flush=True)
    entry["this_tree"].append(entry_times(args.calls))
    if base:
        entry["baseline"].append(child_entry_times(base, args.calls))
    for b, n in SHAPES:
        print(json.dumps({"entry_shape": [b, n], "turns_ms": {k: [t[(b, n)] for t in v] for k, v in entry.items()}}),
              flush=True)
    if base:
        for b, n in K1_SHAPES:
            a = spd(b, n, 11 + n)
            mine = cluster_call(built["c8"][0], a, max_tries=6)
            theirs = cluster_call(built["k1_baseline"][0], a, max_tries=6)
            torch.cuda.synchronize()
            print(json.dumps({"k1_shape": [b, n], "k1_bitwise_equal_baseline":
                              all(torch.equal(x, y) for x, y in zip(mine, theirs))}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
