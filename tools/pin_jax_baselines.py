"""Pin JAX runs of the production training driver
(``nonstationary_precip_tpu.experiments.precipitation_baselines``) as a
committed fixture (tests/fixtures/jax_baselines_ref.npz), for checks that
run where JAX is absent: tests/test_torch_baselines.py runs the PyTorch
port's driver on the CPU on the same argv and holds it to these runs, and
chip_smoke.py (phase ``baselines_ref``) does the same on the card.

What is pinned, in float32 on the CPU, for each case of ``CASES`` (the
driver's exact and sparse Gibbs runs at tests/test_precip_baselines.py's
argv: 20 steps, log and test interval 10, threshold 0, M = 20): JAX's own
``main`` runs, its ``fit`` and ``kmeans_inducing_points`` wrapped to record
  * ``<case>.argv``: the flags (without --logdir and --name);
  * ``<case>.losses``: the fit's per-step loss trace;
  * ``<case>.records``: train.jsonl's records as rows of ``RECORD_KEYS``;
  * ``<case>.rmse`` / ``<case>.nlpd``: the final metrics ``main`` returns;
  * ``<case>.files``: the run directory's entries, sorted;
  * ``<case>.params_total``: params.txt's trainable total;
  * ``sparse.z``: the k-means centres JAX's driver drew from
    ``PRNGKey(BASE_SEED)``.

Run: python tools/pin_jax_baselines.py  (regenerates the .npz in about
25 s; do this deliberately, with a note in the commit message).  Run it
without JAX_ENABLE_X64.
"""

import contextlib
import io
import json
import os
import pathlib
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from nonstationary_precip_tpu.experiments import precipitation_baselines as pb  # noqa: E402

OUT = ROOT / "tests" / "fixtures" / "jax_baselines_ref.npz"
ARGV = ["--num_inducing", "20", "--max_iters", "20", "--log_interval", "10", "--test_interval", "10",
        "--threshold", "0"]
CASES = {"exact": ["--inference", "exact", *ARGV], "sparse": ["--inference", "sparse", *ARGV]}
RECORD_KEYS = ("step", "objective", "noise", "outputscale", "rmse", "rmse_raw", "nlpd")


def pin_case(case: str, argv: list, logdir: str) -> dict:
    seen = {}
    fit, kmeans = pb.fit, pb.kmeans_inducing_points

    def fit_rec(*a, **kw):
        res = fit(*a, **kw)
        seen["losses"] = np.asarray(res.losses)
        return res

    def kmeans_rec(*a, **kw):
        z = kmeans(*a, **kw)
        seen["z"] = np.asarray(z)
        return z

    pb.fit, pb.kmeans_inducing_points = fit_rec, kmeans_rec
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rmse, nlpd = pb.main(["--logdir", logdir, "--name", case, *argv])
    finally:
        pb.fit, pb.kmeans_inducing_points = fit, kmeans
    run = pathlib.Path(logdir) / case
    recs = [json.loads(line) for line in (run / "train.jsonl").read_text().splitlines()]
    total = (run / "params.txt").read_text().splitlines()[-1].split(":")[-1]
    out = {f"{case}.argv": np.array(argv), f"{case}.losses": seen["losses"],
           f"{case}.records": np.array([[r[k] for k in RECORD_KEYS] for r in recs], dtype=np.float64),
           f"{case}.rmse": np.float64(rmse), f"{case}.nlpd": np.float64(nlpd),
           f"{case}.files": np.array(sorted(p.name for p in run.iterdir())), f"{case}.params_total": int(total)}
    if "z" in seen:
        out[f"{case}.z"] = seen["z"]
    return out


def main():
    if jax.config.jax_enable_x64:
        raise SystemExit("run without JAX_ENABLE_X64: the driver's float32 run is what is pinned")
    fields = {"record_keys": np.array(RECORD_KEYS)}
    with tempfile.TemporaryDirectory() as logdir:
        for case, argv in CASES.items():
            fields.update(pin_case(case, argv, logdir))
            print(case, "losses", fields[f"{case}.losses"][[0, -1]], "rmse", fields[f"{case}.rmse"],
                  "nlpd", fields[f"{case}.nlpd"])
    np.savez_compressed(OUT, **fields)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
