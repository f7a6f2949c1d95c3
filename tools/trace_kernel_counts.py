"""Device kernel launches a step in two Chrome traces, side by side.

Reads two traces written by ``torch.profiler`` (``export_chrome_trace``;
plain or gzipped JSON), counts the device operations (events of category
``kernel``, ``gpu_memcpy`` and ``gpu_memset``: what the profiler's
``key_averages`` counts as CUDA events) by name, divides by ``--steps``
and prints the total a step of each trace, then every operation whose
count differs between them, the largest differences first, as JSON lines.
Used to say where the extra launches of one version of a step over another
come from, e.g. two runs of ``tools/profile_torch_largen.py`` on two
commits.

Run anywhere (no card needed):
    python tools/trace_kernel_counts.py A.json B.json [--steps 5]
"""

import argparse
import collections
import gzip
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_counts(path: str) -> collections.Counter:
    """Device operations by name in the Chrome trace at ``path``."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return collections.Counter(e["name"] for e in events if e.get("cat") in DEVICE_CATS)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    a, b = kernel_counts(args.a), kernel_counts(args.b)
    print(json.dumps({"a": args.a, "b": args.b, "steps": args.steps, "a_per_step": sum(a.values()) / args.steps,
                      "b_per_step": sum(b.values()) / args.steps}))
    diffs = sorted(((b[k] - a[k], k) for k in a.keys() | b.keys() if a[k] != b[k]), key=lambda t: (-abs(t[0]), t[1]))
    for d, name in diffs:
        print(json.dumps({"kernel": name[:120], "a": a[name], "b": b[name], "b_minus_a_per_step": d / args.steps}))


if __name__ == "__main__":
    main()
