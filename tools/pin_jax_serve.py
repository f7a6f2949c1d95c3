"""Pin JAX runs of the batch-inference CLI (``nonstationary_precip_tpu.serve``)
as a committed fixture (tests/fixtures/jax_serve_ref.npz), for checks that
run where JAX is absent: tests/test_torch_serve.py serves every family with
the PyTorch port on the CPU from these runs' initial leaves and draws and
holds its step-0 loss and its served marginals to theirs, and chip_smoke.py
(phase ``serve_ref``) does the same on the card.

What is pinned, in float32 on the CPU, for each case of ``CASES`` (one per
model family at the tiny budget the tests use, and the matrix-free path at
N = 256 and N = 2048): JAX's own ``serve.main`` runs, its ``_build``,
``fit`` / ``fit_minibatched`` and ``_predict`` wrapped to record
  * ``<case>.argv``: the CLI flags (without --train_csv and --output);
  * ``<case>.data`` / ``<case>.header``: the training CSV the run read
    (``spatial``: the bundled uib_spatial.csv; ``st``: the first five
    months, 215 rows, of uib_spatio_temporal.csv; ``mf256``, ``mf2048``:
    the matrix-free quickstart's data, x ~ U(−3, 3)² from
    ``default_rng(11)``, as tools/pin_jax_gibbs_mf.py makes it);
  * ``<case>.init.<leaf>``: every leaf of the model ``_build`` made, by the
    port's parameter name;
  * ``<case>.loss0``: the loss at that init (the deep GP's: its fit's step
    0), ``<case>.losses``: the fit's trace, ``<case>.fitted.<leaf>``: the
    fitted model's leaves that differ from the init's;
  * in float64, computed last with x64 on, everything cast from the float32
    run (every case but the deep GP, whose ε JAX draws in x's dtype):
    ``<case>.loss0_f64``, the step-0 loss at the same init (not for the
    matrix-free cases), and ``<case>.mean_f64`` / ``std_f64``, JAX's
    ``_predict`` at the fitted pose in raw units;
  * ``<case>.mean`` / ``<case>.std``: the served marginals in raw units,
    and ``<case>.csv_header`` / ``<case>.csv_shape``: the CSV written;
  * the draws JAX makes from its keys, as the port takes them: the deep
    GP's ε of every step and of the 10 predictive samples
    (``<case>.eps_train_<i>``, ``<case>.eps_pred_<i>``, one per hidden
    layer, rebuilt from the keys as tools/pin_jax_deepgp.py does), and the
    matrix-free prior hoist's SLQ probes (``<case>.prior_u1`` / ``prior_u2``,
    one pair a dim, from ``fold_in(PRNGKey(seed + 1), dim)``) and the
    loss's fixed probes (``<case>.u1`` / ``u2``, from ``PRNGKey(seed + 2)``);
  * the matrix-free cases' α-solve and worst variance-solve relres.
On the CPU the JAX matrix-free path takes its panel matvec, the same math as
the port's K2 and K3.

Run: python tools/pin_jax_serve.py  (regenerates the .npz, about 3
minutes, most of it the N = 2048 case; do this deliberately, with a note in
the commit message).  Run it without JAX_ENABLE_X64.
"""

import contextlib
import io
import json
import os
import pathlib
import re
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import nonstationary_precip_tpu.train as jax_train  # noqa: E402
import nonstationary_precip_tpu.train.optim as jax_optim  # noqa: E402
from nonstationary_precip_tpu import serve  # noqa: E402
from nonstationary_precip_tpu.utils.config import DATASET_DIR  # noqa: E402
from pin_jax_deepgp import loss_eps  # noqa: E402  (tools/, beside this file)
from pin_jax_gibbs_mf import draws  # noqa: E402

OUT = ROOT / "tests" / "fixtures" / "jax_serve_ref.npz"
ST_ROWS = 215  # the first five months of the spatio-temporal cube, 43 sites each
ST_COLS = ["--x_cols", "1,2,3", "--y_col", "4"]

#: case → (data, model, flags); every case serves the training sites.
CASES = {
    "seard": ("spatial", "seard", ["--max_iters", "5"]),
    "gibbs_exact": ("spatial", "gibbs_exact", ["--max_iters", "5"]),
    "gibbs_sparse": ("spatial", "gibbs_sparse", ["--max_iters", "5"]),
    "mv_gibbs": ("spatial", "mv_gibbs", ["--max_iters", "5"]),
    "mv_gibbs_sparse": ("spatial", "mv_gibbs_sparse", ["--max_iters", "5"]),
    "deepgp": ("spatial", "deepgp", ["--num_epochs", "1"]),
    "st_stationary": ("st", "st_stationary", ["--max_iters", "5", *ST_COLS]),
    "st_nonstationary": ("st", "st_nonstationary", ["--max_iters", "5", "--num_inducing", "50", *ST_COLS]),
    "mf256": ("mf256", "gibbs_exact", ["--max_iters", "3", "--matrixfree", "true"]),
    "mf2048": ("mf2048", "gibbs_exact", ["--max_iters", "3", "--matrixfree", "true"]),
}
PRED_SAMPLES = 10  # the deep GP's predictive samples in JAX's ``_predict``
F32_MEAN: dict = {}  # case → JAX's float32 served mean
F64_LATER: dict = {}  # case → (cfg, init model, fitted model, loss_fn, x, y, csv), for the float64 runs
MV_PRIOR = ("loc", "row_cov", "col_cov")  # MatrixNormalPrior's flattened children


def leaves(tree) -> dict:
    """A JAX model's leaves by the port's parameter name: attribute and
    sequence keys dotted, the matrix-normal prior's children by name."""
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = []
        for k in path:
            if isinstance(k, jax.tree_util.GetAttrKey):
                parts.append(k.name)
            elif isinstance(k, jax.tree_util.SequenceKey):
                parts.append(str(k.idx))
            elif isinstance(k, jax.tree_util.FlattenedIndexKey):
                parts.append(MV_PRIOR[k.key])
            else:
                parts.append(str(getattr(k, "key", k)))
        out[".".join(parts)] = np.asarray(v)
    return out


def datasets() -> dict:
    """{name: (header, float64 array)} of the cases' training CSVs."""
    sp = np.loadtxt(DATASET_DIR / "uib_spatial.csv", delimiter=",", skiprows=1)
    st = np.loadtxt(DATASET_DIR / "uib_spatio_temporal.csv", delimiter=",", skiprows=1)[:ST_ROWS]
    out = {"spatial": ("lon,lat,tp", sp), "st": (",time,lon,lat,tp", st)}
    for n in (256, 2048):
        rng = np.random.default_rng(11)
        x = rng.uniform(-3, 3, size=(n, 2)).astype(np.float32)
        eps = rng.normal(size=n).astype(np.float32)
        y = np.sin(2.0 * x[:, 0] * (1.0 + 0.4 * np.tanh(x[:, 1]))) + 0.1 * eps
        out[f"mf{n}"] = ("x0,x1,y", np.column_stack([x, y]).astype(np.float64))
    return out


def write_csv(path, header: str, data: np.ndarray):
    np.savetxt(path, data, delimiter=",", header=header, comments="", fmt="%.17g")


def pin_case(case: str, data_name: str, model: str, flags: list, csv: str, tmp: str) -> dict:
    """One JAX serve of ``case``, recorded through wrappers of its pieces."""
    rec = {}
    build, jfit, jfit_mb = serve._build, jax_train.fit, jax_optim.fit_minibatched

    def build_rec(name, train_x, train_y, cfg, key):
        out = build(name, train_x, train_y, cfg, key)
        rec.update(init=leaves(out[0]), built=out, x=train_x, y=train_y, k_init=key)
        return out

    def fit_rec(*args, **kw):
        res = jfit(*args, **kw)
        rec.update(losses=np.asarray(res.losses), fitted=leaves(res.model), fitted_model=res.model)
        return res

    def fit_mb_rec(model_, loss_fn, x, y, *, key, num_epochs, batch_size, **kw):
        res = jfit_mb(model_, loss_fn, x, y, key=key, num_epochs=num_epochs, batch_size=batch_size, **kw)
        rec.update(losses=np.asarray(res.losses), fitted=leaves(res.model), fitted_model=res.model, k_fit=key,
                   num_epochs=num_epochs,
                   batch_size=batch_size)
        return res

    out_csv = os.path.join(tmp, f"{case}.csv")
    argv = ["--model", model, "--train_csv", csv, "--output", out_csv, *flags]
    serve._build, jax_train.fit, jax_optim.fit_minibatched = build_rec, fit_rec, fit_mb_rec
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            mean, std = serve.main(argv)
    finally:
        serve._build, jax_train.fit, jax_optim.fit_minibatched = build, jfit, jfit_mb
    cfg = serve.ServeConfig(model="gibbs_exact", max_iters=1000).parse_args(argv)
    m0, loss_fn, _, extra = rec["built"]
    with open(out_csv) as fh:
        header = fh.readline().strip()
    got = {"argv": np.str_(json.dumps(flags)), "data": np.str_(data_name), "model": np.str_(model),
           "mean": np.asarray(mean), "std": np.asarray(std), "csv_header": np.str_(header),
           "csv_shape": np.asarray(np.loadtxt(out_csv, delimiter=",", skiprows=1).shape),
           "losses": rec["losses"], **{f"init.{k}": v for k, v in rec["init"].items()},
           **{f"fitted.{k}": v for k, v in rec["fitted"].items() if not np.array_equal(v, rec["init"][k])}}
    if model == "deepgp":
        got["loss0"] = np.float64(rec["losses"][0])
        n = rec["x"].shape[0]
        b = min(rec["batch_size"], n)
        steps = len(rec["losses"])
        keys = jax.random.split(rec["k_fit"], steps)
        per_step = [loss_eps(keys[t], cfg.num_samples, 2, cfg.num_layers, b) for t in range(steps)]
        k_pred = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)[2]
        for i in range(cfg.num_layers):
            got[f"eps_train_{i}"] = np.stack([e[i] for e in per_step])
            got[f"eps_pred_{i}"] = loss_eps(k_pred, PRED_SAMPLES, 2, cfg.num_layers, n)[i]
    else:
        got["loss0"] = np.float64(jax.jit(lambda m, xx, yy, *ex: loss_fn(m, xx, yy, *ex))(m0, rec["x"], rec["y"],
                                                                                           *extra))
    if cfg.matrixfree:
        n = rec["x"].shape[0]
        prior_rank, rank = min(50, n), min(cfg.precond_rank, n)
        pairs = [draws(jax.random.fold_in(jax.random.PRNGKey(cfg.seed + 1), dim), prior_rank, n, 16)
                 for dim in range(rec["x"].shape[1])]
        got["prior_u1"] = np.stack([np.asarray(u1) for u1, _ in pairs])
        got["prior_u2"] = np.stack([np.asarray(u2) for _, u2 in pairs])
        u1, u2 = draws(jax.random.PRNGKey(cfg.seed + 2), rank, n, 8)
        got["u1"], got["u2"] = np.asarray(u1), np.asarray(u2)
        text = printed.getvalue()
        got["alpha_relres"] = np.float64(re.search(r"alpha solve relres=(\S+)", text).group(1))
        got["worst_relres"] = np.float64(re.search(r"worst relres=(\S+)", text).group(1))
    F32_MEAN[case] = got["mean"]
    F64_LATER[case] = (cfg, m0, rec["fitted_model"], loss_fn, rec["x"], rec["y"], csv)
    print(f"{case}: loss0 {float(got['loss0']):.6f}, {len(got['losses'])} steps -> {float(got['losses'][-1]):.6f}; "
          f"mean[:2] {got['mean'][:2]}, std[:2] {got['std'][:2]}", flush=True)
    return got


def float64_case(case, cfg, m0, m1, loss_fn, x, y, csv) -> dict:
    """``<case>.loss0_f64`` (not for the matrix-free cases, whose loss is a
    stochastic estimate) and ``<case>.mean_f64`` / ``std_f64``: JAX's
    ``_predict`` at the fitted pose, everything cast to float64 (the
    float32 training inputs included), in raw units."""
    f64 = jax.numpy.float64
    cast = lambda t: jax.tree_util.tree_map(lambda a: jax.numpy.asarray(a, f64), t)  # noqa: E731
    x64, y64 = cast(x), cast(y)
    n = x64.shape[0]

    def extra_of(m):
        if cfg.matrixfree:
            return (m.prior.gram_pre_lazy(x64, jax.random.PRNGKey(cfg.seed + 1), rank=min(50, n),
                                          block=serve._lazy_block(n)),)
        return (m.prior.gram_pre(x64),) if cfg.model == "gibbs_exact" else ()

    got = {}
    if not cfg.matrixfree:
        m64 = cast(m0)
        got[f"{case}.loss0_f64"] = np.float64(jax.jit(lambda m, *a: loss_fn(m, x64, y64, *a))(m64, *extra_of(m64)))
    m64 = cast(m1)
    k_pred = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)[2]
    with contextlib.redirect_stdout(io.StringIO()):
        mean, var = serve._predict(cfg.model, m64, x64, y64, x64, k_pred, cfg=cfg, extra=extra_of(m64))
    raw_y = np.loadtxt(csv, delimiter=",", skiprows=1)[:, cfg.y_col]
    meany, stdy = float(raw_y.mean()), float(raw_y.std(ddof=1))
    got[f"{case}.mean_f64"] = np.asarray(mean) * stdy + meany
    got[f"{case}.std_f64"] = np.sqrt(np.maximum(np.asarray(var), 0.0)) * stdy
    print(f"{case}: float64 loss0 {got.get(f'{case}.loss0_f64')}, served at the fitted pose: float32 from float64 "
          f"{np.abs(got[f'{case}.mean_f64'] - F32_MEAN[case]).max():.3g} (mean)", flush=True)
    return got


def main():
    if jax.config.jax_enable_x64:
        raise SystemExit("pin in float32: unset JAX_ENABLE_X64")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = datasets()
        for name, (header, arr) in data.items():
            write_csv(os.path.join(tmp, f"{name}.train.csv"), header, arr)
            out[f"data.{name}"] = arr
            out[f"header.{name}"] = np.str_(header)
        for case, (data_name, model, flags) in CASES.items():
            got = pin_case(case, data_name, model, flags, os.path.join(tmp, f"{data_name}.train.csv"), tmp)
            out.update({f"{case}.{k}": v for k, v in got.items()})
        # float64, run last (x64 on): the step-0 loss at the same init and the
        # served marginals at the fitted pose, where float32 rounding is
        # amplified (cond(K + σ²I) ~ 1e4 in the exact Gibbs families, the
        # sparse MV prior's cond(U) ~ 1e7); each package's float32 is held to
        # these
        jax.config.update("jax_enable_x64", True)
        for case, (cfg, m0, m1, loss_fn, x, y, csv) in F64_LATER.items():
            if CASES[case][1] != "deepgp":  # its ε are drawn in x's dtype: float64 draws differ
                out.update(float64_case(case, cfg, m0, m1, loss_fn, x, y, csv))
    OUT.parent.mkdir(exist_ok=True)
    np.savez_compressed(OUT, **out, cases=np.asarray(list(CASES)), jax_version=np.str_(jax.__version__))
    print(f"pinned {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
