"""Pin JAX runs of the sparse and spatio-temporal models as a committed
fixture (tests/fixtures/jax_sparse_ref.npz), for checks that run where JAX
is absent: chip_smoke.py runs the PyTorch port on the card from these runs'
inducing inputs and holds its losses to theirs, and
tests/test_torch_sparse_gp.py holds the port's step-0 losses on the CPU to
them.

What is pinned, in float32 on the CPU:
* ``gibbs.*``: the JAX ``spatial_gibbs --inference sparse`` experiment's 10
  splits (its data prep, prior and ``GibbsSparseGP`` at M = 250, noise
  0.011 and outputscale 0.644 fixed, z and the field training), each
  split's k-means seed row (``jax.random.randint(PRNGKey(173 + i), (), 0,
  316)``) and k-means z, and the per-split losses of 20 Adam steps at lr
  0.01 (``fit_splits``), and the same 20 steps from the same z in float64
  (``gibbs.losses_f64``, run last, with x64 on): this model's float32
  trajectories part from float64 within 20 steps (the gradient in z passes
  through a numerically singular K_zz), so a float32 run is held to
  JAX's float32 distance from this one; the same 20 steps with z frozen
  (``gibbs.frozen.losses``, ``gibbs.frozen.losses_f64``), a trajectory a
  float32 run was expected to follow to rtol 1e-2 (it does not: the
  field's float32 gradient carries 10-20 % of rounding in both packages);
  each split's step-0 gradient in z and in the field, in float32 and in
  float64 (``gibbs.grad0.{z,log_ell_z}``, ``…_f64``); and the jitter each step's
  ``safe_cholesky`` members took in those four runs
  (``gibbs.jitter.{kzz,b,prior}``, ``gibbs.frozen.jitter.…``, ``…_f64``:
  (step, member), by :func:`classify_jitter`), logged by rerunning each
  under :class:`JitterLog`;
* ``st.*``: the JAX ``spatio_temporal --model Non-Stationary
  --num_inducing 100`` run's seed row, z and 20 losses at lr 0.015
  (``SparseSpatioTemporalNonstationary``, its default trainability);
* ``sgpr.*``: the JAX ``sgpr_bench`` run's z (M = 1900, drawn with numpy)
  and 20 losses at lr 0.05 (every parameter trains).

Run: python tools/pin_jax_sparse.py  (regenerates the .npz, about 5 minutes;
do this deliberately, with a note in the commit message).
"""

import math
import os
import pathlib
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from nonstationary_precip_tpu.data.datasets import load_uib_spatial, load_uib_spatio_temporal  # noqa: E402
from nonstationary_precip_tpu.data.datasets import spatio_temporal_month_split  # noqa: E402
from nonstationary_precip_tpu.experiments import sgpr_bench  # noqa: E402
from nonstationary_precip_tpu.experiments.spatial_gibbs import make_split  # noqa: E402
from nonstationary_precip_tpu.models import SparseSpatioTemporalNonstationary  # noqa: E402
from nonstationary_precip_tpu.models.sgpr import SGPR  # noqa: E402
from nonstationary_precip_tpu.ops.kmeans import kmeans_inducing_points  # noqa: E402
from nonstationary_precip_tpu.priors import LogNormalProcess  # noqa: E402
from nonstationary_precip_tpu.train.config import ExperimentConfig  # noqa: E402
from nonstationary_precip_tpu.train.optim import fit  # noqa: E402
from nonstationary_precip_tpu.train.vmapped import fit_splits  # noqa: E402
from nonstationary_precip_tpu.utils.config import BASE_SEED  # noqa: E402
from witness_sparse import classify_jitter  # noqa: E402  (tools/, beside this file)

OUT = pathlib.Path(__file__).resolve().parent.parent / "tests" / "fixtures" / "jax_sparse_ref.npz"
STEPS = 20
NUM_SPLITS = 10
ST_INDUCING = 100


def first_row(seed: int, n: int) -> int:
    """The seed row the JAX k-means draws from ``PRNGKey(seed)``."""
    return int(jax.random.randint(jax.random.PRNGKey(seed), (), 0, n))


def gibbs_fit(dtype, z=None, train_z=True):
    """The JAX sparse Gibbs slice's 10 splits, 20 Adam steps at lr 0.01 (its
    ``fit_splits``), from their own k-means z or from ``z`` (x64 draws other
    k-means seed rows, so a float64 run is given the float32 run's z);
    ``train_z=False`` freezes z.  Returns (splits, TrainResult)."""
    cfg = ExperimentConfig(lr=0.01, max_iters=STEPS, inference="sparse")
    _, x, y = load_uib_spatial()
    x_norm = (x - x.mean(0)) / x.std(0, ddof=1)
    y_norm = (y - y.mean()) / y.std(ddof=1)
    splits = [make_split(x_norm, y_norm, s, cfg, dtype) for s in range(NUM_SPLITS)]
    models = [s[0] for s in splits]
    if z is not None:
        models = [m.replace(z=jnp.asarray(zs, dtype), log_ell_z=m.prior.init_log_field(jnp.asarray(zs, dtype))
                            .astype(dtype)) for m, zs in zip(models, z)]
    masks = [m.trainable(train_noise=cfg.noise == 0, train_scale=cfg.scale == 0, train_z=train_z) for m in models]
    res = fit_splits(models, lambda m, xx, yy: m.loss(xx, yy), *zip(*[s[2] for s in splits]), lr=cfg.lr,
                     num_steps=STEPS, masks=masks)
    return splits, res


def gibbs_grads(dtype, z, suffix=""):
    """Each split's loss gradient in z and in the field at the pinned init
    (its k-means z, the prior's field there): ``gibbs.grad0.{z,log_ell_z}``."""
    cfg = ExperimentConfig(lr=0.01, max_iters=STEPS, inference="sparse")
    _, x, y = load_uib_spatial()
    x_norm = (x - x.mean(0)) / x.std(0, ddof=1)
    y_norm = (y - y.mean()) / y.std(ddof=1)
    grads = []
    for s in range(NUM_SPLITS):
        model, _, (x_tr, y_tr), _ = make_split(x_norm, y_norm, s, cfg, dtype)
        zs = jnp.asarray(z[s], dtype)
        model = model.replace(z=zs, log_ell_z=model.prior.init_log_field(zs).astype(dtype))
        g = jax.jit(jax.grad(lambda m, xx, yy: m.loss(xx, yy)))(model, x_tr, y_tr)
        grads.append((np.asarray(g.z), np.asarray(g.log_ell_z)))
    return {f"gibbs.grad0.z{suffix}": np.stack([g[0] for g in grads]),
            f"gibbs.grad0.log_ell_z{suffix}": np.stack([g[1] for g in grads])}


def pin_gibbs(dtype):
    splits, res = gibbs_fit(dtype)
    n = splits[0][3][0].shape[0]
    z = np.stack([np.asarray(s[0].z) for s in splits])
    return {"gibbs.first": np.array([first_row(BASE_SEED + s, n) for s in range(NUM_SPLITS)]),
            "gibbs.z": z, "gibbs.losses": np.asarray(res.losses),
            "gibbs.frozen.losses": np.asarray(gibbs_fit(dtype, z, train_z=False)[1].losses), **gibbs_grads(dtype, z)}


def pin_gibbs_f64(z_f32):
    """The sparse Gibbs slice's 20 steps in float64 from the float32 run's z,
    with z training and frozen, and its step-0 gradients (x64 must be on)."""
    return {"gibbs.losses_f64": np.asarray(gibbs_fit(jnp.float64, z_f32)[1].losses),
            "gibbs.frozen.losses_f64": np.asarray(gibbs_fit(jnp.float64, z_f32, train_z=False)[1].losses),
            **gibbs_grads(jnp.float64, z_f32, "_f64")}


class JitterLog:
    """Records the jitter every ``safe_cholesky`` member took, with the mean
    of the matrix's diagonal, in call order, while active: the JAX
    package's ``_safe_chol_fwd_impl`` is swapped for a copy that also hands
    both to a host callback.  The package's files are not touched; the
    copy does the same arithmetic."""

    def __enter__(self):
        from nonstationary_precip_tpu.ops import linalg

        self._linalg, self._orig, self.jitter, self.diag_mean = linalg, linalg._safe_chol_fwd_impl, [], []

        def record(j, d):
            self.jitter.extend(np.ravel(np.asarray(j)).tolist())
            self.diag_mean.extend(np.ravel(np.asarray(d)).tolist())

        def impl(mat, jitter, max_tries):
            eye = jnp.eye(mat.shape[-1], dtype=mat.dtype)
            base = jitter if jitter > 0 else linalg.EPSILON

            def cond_fn(state):
                i, _, chol = state
                return jnp.logical_and(i < max_tries, jnp.logical_not(jnp.all(jnp.isfinite(chol))))

            def body(state):
                i, j, chol = state
                finite = jnp.all(jnp.isfinite(chol), axis=(-1, -2))
                j_next = jnp.where(finite, j, jnp.where(j == 0, base, j * 10.0))
                return i + 1, j_next, jnp.linalg.cholesky(mat + j_next[..., None, None] * eye)

            zeros = jnp.zeros(mat.shape[:-2], dtype=mat.dtype)
            _, j, chol = jax.lax.while_loop(cond_fn, body, (jnp.asarray(0), zeros, linalg.cholesky(mat)))
            jax.debug.callback(record, j, jnp.mean(jnp.diagonal(mat, axis1=-2, axis2=-1), axis=-1))
            return chol

        linalg._safe_chol_fwd_impl = impl
        return self

    def __exit__(self, *exc):
        self._linalg._safe_chol_fwd_impl = self._orig


def pin_gibbs_jitter(dtype, z, losses, frozen_losses, suffix=""):
    """The jitter each step's ``safe_cholesky`` members took in the runs
    pinned above, rerun under :class:`JitterLog`, whose losses must be
    theirs: ``{run}.jitter.{kzz,b,prior}{suffix}``."""
    out = {}
    for key, train_z, want in (("gibbs", True, losses), ("gibbs.frozen", False, frozen_losses)):
        with JitterLog() as log:
            got = np.asarray(gibbs_fit(dtype, z, train_z=train_z)[1].losses)
        if not np.array_equal(got, want):
            raise SystemExit(f"{key}{suffix}: the logged rerun's losses differ from the pinned run's")
        for kind, arr in classify_jitter(log.jitter, log.diag_mean, STEPS).items():
            out[f"{key}.jitter.{kind}{suffix}"] = arr
    return out


def pin_st(dtype):
    cfg = ExperimentConfig(lr=0.015, max_iters=STEPS)
    x_train, y_train, *_ = spatio_temporal_month_split()
    x_train, y_train = jnp.asarray(x_train, dtype), jnp.asarray(y_train, dtype)
    prior = LogNormalProcess.create(input_dim=2, mean=math.log(cfg.prior_mean), outputscale=cfg.prior_scale,
                                    lengthscale=cfg.prior_ell, dtype=dtype)
    z = kmeans_inducing_points(jax.random.PRNGKey(BASE_SEED), x_train, ST_INDUCING)
    model = SparseSpatioTemporalNonstationary.create(z, prior, dtype=dtype)
    res = fit(model, lambda m, xx, yy: m.loss(xx, yy), x_train, y_train, lr=cfg.lr, num_steps=STEPS,
              mask=model.trainable())
    return {"st.first": first_row(BASE_SEED, x_train.shape[0]), "st.z": np.asarray(z),
            "st.losses": np.asarray(res.losses)}


def pin_sgpr(dtype):
    cfg = ExperimentConfig(lr=0.05, num_inducing=1900, train_percent=80.0)
    _, x, y = load_uib_spatio_temporal()
    x_norm = (x - x.mean(0)) / x.std(0, ddof=1)
    rng = np.random.default_rng(BASE_SEED)
    idx = rng.permutation(len(y))
    n_train = int(cfg.train_percent / 100 * len(y))
    train_x, train_y = jnp.asarray(x_norm[idx[:n_train]], dtype), jnp.asarray(y[idx[:n_train]], dtype)
    z = np.asarray(train_x)[rng.permutation(n_train)[: cfg.num_inducing]]
    model = SGPR.create(sgpr_bench.make_kernel(dtype), z, dtype=dtype)
    res = fit(model, lambda m, xx, yy: m.loss(xx, yy), train_x, train_y, lr=cfg.lr, num_steps=STEPS)
    return {"sgpr.z": z, "sgpr.losses": np.asarray(res.losses)}


def main():
    if jax.config.jax_enable_x64:
        raise SystemExit("pin in float32: unset JAX_ENABLE_X64")
    out = {}
    for pin in (pin_gibbs, pin_st, pin_sgpr):
        out.update(pin(jnp.float32))
        print(pin.__name__, "done", flush=True)
    out.update(pin_gibbs_jitter(jnp.float32, out["gibbs.z"], out["gibbs.losses"], out["gibbs.frozen.losses"]))
    jax.config.update("jax_enable_x64", True)
    out.update(pin_gibbs_f64(out["gibbs.z"]))
    out.update(pin_gibbs_jitter(jnp.float64, out["gibbs.z"], out["gibbs.losses_f64"], out["gibbs.frozen.losses_f64"],
                                "_f64"))
    np.savez_compressed(OUT, steps=STEPS, **out)
    print(f"wrote {OUT}: " + ", ".join(f"{k} {np.asarray(v).shape}" for k, v in out.items()))


if __name__ == "__main__":
    main()
