"""Pin two JAX runs of the stationary exact GP as a committed fixture
(tests/fixtures/jax_exact_ref.npz), for checks that run where JAX is
absent: chip_smoke.py runs the PyTorch port on the card on these inputs and
holds its losses to these.

What is pinned, in float32 on the CPU:
  * ``seard_*``: the JAX ``experiments/seard_spatial.py`` fit (its
    ``make_split`` and ``fit_splits``: Scale(RBF-ARD-2), constant mean, Adam
    lr 0.01) for splits 0 and 1, 51 steps: the per-split losses, and
    checksums of each split's training data;
  * ``lazy_*``: the matrix-free ``ExactGP.mll`` loop in the configuration of
    the port's ``experiments/exact_largen.lazy`` at N = 2048: the
    quickstart's data (``examples/quickstart_lazy_largen.py``: x ~ U(−3, 3)²
    from ``default_rng(3)``, y = sin 2x₀·cos x₁ + 0.15ε), Scale(RBF(2)),
    noise 0.05, zero mean, 8 probes under ``PRNGKey(0)``, block 2048, the
    rank-150 greedy pivoted-Cholesky preconditioner, 32 mBCG iterations, 20
    Adam steps at lr 0.01: the data, the standard normal draws u1, u2 that
    the key yields for the probes (``ops/bbmm.py:293-300``), the 20
    losses, the trained raw parameters, and the matrix-free and dense
    (Cholesky) losses at the trained pose.  On the CPU the JAX run takes
    the panel matvec, the same math as the port's fused K6.

Run: python tools/pin_jax_exact.py  (regenerates the .npz; do this
deliberately, with a note in the commit message).
"""

import os
import pathlib
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from nonstationary_precip_tpu.data.dataprep import load_csv  # noqa: E402
from nonstationary_precip_tpu.experiments.seard_spatial import make_split  # noqa: E402
from nonstationary_precip_tpu.kernels import RBF, Scale  # noqa: E402
from nonstationary_precip_tpu.models import ExactGP  # noqa: E402
from nonstationary_precip_tpu.train.config import ExperimentConfig  # noqa: E402
from nonstationary_precip_tpu.train.vmapped import fit_splits  # noqa: E402
from nonstationary_precip_tpu.utils.config import DATASET_DIR  # noqa: E402

OUT = pathlib.Path(__file__).resolve().parent.parent / "tests" / "fixtures" / "jax_exact_ref.npz"
SEARD_SPLITS, SEARD_STEPS, SEARD_LR = (0, 1), 51, 0.01
N, STEPS, RANK, ITERS, BLOCK, PROBES, LR, NOISE, KEY = 2048, 20, 150, 32, 2048, 8, 0.01, 0.05, 0


def leaves(model) -> dict:
    """A JAX model's leaves by dotted path (the port's parameter names)."""
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(model)[0]:
        out[jax.tree_util.keystr(path)[1:].replace("[", ".").replace("]", "")] = np.asarray(v)
    return out


def seard_run():
    cfg = ExperimentConfig(model="whitening", lr=SEARD_LR, max_iters=SEARD_STEPS)
    data = load_csv(DATASET_DIR / "uib_spatial.csv")
    splits = [make_split(data, rs, cfg, jnp.float32) for rs in SEARD_SPLITS]
    res = fit_splits([s[0] for s in splits], lambda m, xx, yy: m.loss(xx, yy),
                     *tuple(zip(*[s[1] for s in splits])), lr=SEARD_LR, num_steps=SEARD_STEPS)
    x = np.stack([np.asarray(s[1][0], np.float64) for s in splits])
    y = np.stack([np.asarray(s[1][1], np.float64) for s in splits])
    checksums = np.stack([x.sum(axis=(-1, -2)), (x * x).sum(axis=(-1, -2)), y.sum(axis=-1)], axis=-1)
    return np.asarray(res.losses), checksums


def lazy_data(n):
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.uniform(-3, 3, size=(n, 2)), jnp.float32)
    y = jnp.sin(2 * x[:, 0]) * jnp.cos(x[:, 1]) + 0.15 * jnp.asarray(rng.normal(size=n), jnp.float32)
    return x, y


def lazy_run():
    x, y = lazy_data(N)
    key = jax.random.PRNGKey(KEY)
    model = ExactGP.create(Scale.create(RBF.create(2)), noise=NOISE, mean_type="zero")
    kw = dict(solver="cg", key=key, block=BLOCK, num_probes=PROBES, max_iters=ITERS, precond_rank=RANK)

    def loss(m):
        return m.loss(x, y, **kw)

    opt = optax.adam(LR)

    @jax.jit
    def train(m):
        def body(carry, _):
            mm, s = carry
            val, g = jax.value_and_grad(loss)(mm)
            up, s = opt.update(g, s, mm)
            return (optax.apply_updates(mm, up), s), val

        (m, _), vals = jax.lax.scan(body, (m, opt.init(m)), None, length=STEPS)
        return m, vals

    trained, vals = train(model)
    k1, k2 = jax.random.split(key)
    u1 = jax.random.normal(k1, (RANK, PROBES), jnp.float32)
    u2 = jax.random.normal(k2, (N, PROBES), jnp.float32)
    return {"x": np.asarray(x), "y": np.asarray(y), "u1": np.asarray(u1), "u2": np.asarray(u2),
            "losses": np.asarray(vals), "params": leaves(trained),
            "loss_lazy": float(jax.jit(loss)(trained)), "loss_dense": float(jax.jit(lambda m: m.loss(x, y))(trained))}


def main():
    if jax.config.jax_enable_x64:
        raise SystemExit("pin in float32: unset JAX_ENABLE_X64")
    seard_losses, checksums = seard_run()
    lz = lazy_run()
    OUT.parent.mkdir(exist_ok=True)
    np.savez_compressed(
        OUT,
        seard_losses=seard_losses, seard_checksums=checksums, seard_splits=np.asarray(SEARD_SPLITS),
        seard_lr=np.float64(SEARD_LR),
        lazy_x=lz["x"], lazy_y=lz["y"], lazy_u1=lz["u1"], lazy_u2=lz["u2"], lazy_losses=lz["losses"],
        **{f"lazy_param.{k}": v for k, v in lz["params"].items()},
        lazy_loss_lazy=np.float64(lz["loss_lazy"]), lazy_loss_dense=np.float64(lz["loss_dense"]),
        lazy_n=np.int64(N), lazy_steps=np.int64(STEPS), lazy_rank=np.int64(RANK), lazy_iters=np.int64(ITERS),
        lazy_block=np.int64(BLOCK), lazy_lr=np.float64(LR), lazy_noise=np.float64(NOISE),
        lazy_key=np.int64(KEY), jax_version=np.str_(jax.__version__),
    )
    print(f"pinned {OUT}: seard losses step 0 {seard_losses[0]}, step 50 {seard_losses[50]}; lazy losses "
          f"{lz['losses'][0]:.6f} -> {lz['losses'][-1]:.6f}, trained pose lazy {lz['loss_lazy']:.6f} "
          f"dense {lz['loss_dense']:.6f}")


if __name__ == "__main__":
    main()
