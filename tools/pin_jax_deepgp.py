"""Pin the JAX package's DSVI deep GP run as a committed fixture
(tests/fixtures/jax_deepgp_ref.npz), for checks that run where JAX is
absent: the PyTorch port's chip smoke test (phase ``dgp_ref``) trains from
the same init, batch schedule and ε on the card and compares its losses
with these, and tests/test_torch_deepgp.py checks the fixture on the CPU.

What is pinned: the JAX experiment (nonstationary_precip_tpu.experiments.
deepgp_spatial, whitening, its full configuration: M = 250, 2 hidden layers,
batch 315, S = 3, lr 0.01) in float32 on the CPU, for splits 0 and 1 trained
in lockstep by ``fit_minibatched_splits`` for 10 epochs (10 steps):
  * init.<leaf>: every leaf of the two splits' initial models, stacked;
  * batch_idx (10, 2, 315): the batch schedule;
  * eps_<i> (10, 2, 3, 2, 315), one per hidden layer: the ε that the JAX
    loss draws from its keys, rebuilt from the same key schedule
    (``split(key_t, S)``, then per hidden layer ``k, sub = split(k)`` and
    ``normal(sub, (O, B))``);
  * losses (10, 2): the per-split losses of those 10 steps;
  * jitter_init / jitter_step10 (2, 5) bool: which members (layer 0's two
    outputs, layer 1's two, the head) of each split's K_zz the plain f32
    Cholesky fails on at the initial and the final pose, i.e. where JAX's
    fallback ``safe_cholesky`` (on the CPU the JAX package never runs its
    fused precompute) took jitter;
  * checksums (2, 3): Σx, Σx², Σy of each split's float32 training rows.

Run: python tools/pin_jax_deepgp.py  (about 30 s; regenerates the .npz, so
do it deliberately, with a note in the commit message).  Run it without
JAX_ENABLE_X64.
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

from nonstationary_precip_tpu.data.dataprep import load_csv  # noqa: E402
from nonstationary_precip_tpu.experiments.deepgp_spatial import prep_split  # noqa: E402
from nonstationary_precip_tpu.train.config import ExperimentConfig  # noqa: E402
from nonstationary_precip_tpu.train.optim import _epoch_schedule, fit_minibatched_splits  # noqa: E402
from nonstationary_precip_tpu.train.vmapped import stack_pytrees  # noqa: E402
from nonstationary_precip_tpu.utils.config import DATASET_DIR  # noqa: E402

OUT = pathlib.Path(__file__).resolve().parent.parent / "tests" / "fixtures" / "jax_deepgp_ref.npz"
SPLITS = (0, 1)
STEPS = 10


def leaves(tree) -> dict:
    """A pytree as {dotted path: numpy array}, the form the port's
    ``interop.deepgp_from_jax`` takes."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(getattr(k, "name", getattr(k, "idx", k))) for k in path): np.asarray(leaf)
            for path, leaf in flat}


def loss_eps(key, num_samples, hidden_dims, num_hidden, b, dtype=jnp.float32):
    """The ε the JAX ``DeepGP.loss`` draws from ``key``: per hidden layer an
    (S, O, B) array."""
    out = [[] for _ in range(num_hidden)]
    for k in jax.random.split(key, num_samples):
        for i in range(num_hidden):
            k, sub = jax.random.split(k)
            out[i].append(np.asarray(jax.random.normal(sub, (hidden_dims, b), dtype=dtype)))
    return [np.stack(e) for e in out]


def failing_members(model) -> np.ndarray:
    """Per split, per member of [layers..., head]: does the plain f32
    Cholesky of K_zz + εI fail?"""
    grams = [jax.vmap(lambda m: m.gram_zz())(layer) for layer in list(model.layers) + [model.head]]
    k = jnp.concatenate(grams, axis=1)  # (K, ΣO, M, M)
    return ~np.asarray(jnp.all(jnp.isfinite(jnp.linalg.cholesky(k)), axis=(-2, -1)))


def main():
    if jax.config.jax_enable_x64:
        raise SystemExit("pin in float32: unset JAX_ENABLE_X64")
    cfg = ExperimentConfig(model="whitening", lr=0.01, num_epochs=STEPS, num_samples=3, num_layers=2,
                           batch_size=315, num_inducing=250)
    data = load_csv(DATASET_DIR / "uib_spatial.csv")
    preps = [prep_split(data, rs, cfg) for rs in SPLITS]
    models = [p[0] for p in preps]
    xs = [p[1][0] for p in preps]
    ys = [p[1][1] for p in preps]
    keys = [p[3] for p in preps]
    n = xs[0].shape[0]

    def loss_fn(m, kk, xb, yb):
        return m.loss(kk, xb, yb, num_data=n, num_samples=cfg.num_samples)

    init = stack_pytrees(models)
    res = fit_minibatched_splits(models, loss_fn, xs, ys, keys=keys, num_epochs=STEPS,
                                 batch_size=cfg.batch_size, lr=cfg.lr, seeds=list(SPLITS))
    losses = np.asarray(res.losses)

    # the schedule and keys exactly as fit_minibatched_splits builds them
    batch_idx = np.stack([_epoch_schedule(s, n, STEPS, cfg.batch_size) for s in SPLITS], axis=1)
    keys_tk = jnp.stack([jax.random.split(kk, batch_idx.shape[0]) for kk in keys], axis=1)
    b = batch_idx.shape[-1]
    eps = [np.zeros((STEPS, len(SPLITS), cfg.num_samples, 2, b), np.float32) for _ in range(cfg.num_layers)]
    for t in range(STEPS):
        for k in range(len(SPLITS)):
            for i, e in enumerate(loss_eps(keys_tk[t, k], cfg.num_samples, 2, cfg.num_layers, b)):
                eps[i][t, k] = e

    x = np.asarray(jnp.stack(xs), np.float64)
    y = np.asarray(jnp.stack(ys), np.float64)
    checksums = np.stack([x.sum(axis=(-1, -2)), (x * x).sum(axis=(-1, -2)), y.sum(axis=-1)], axis=-1)
    OUT.parent.mkdir(exist_ok=True)
    np.savez_compressed(
        OUT,
        **{f"init.{k}": v for k, v in leaves(init).items()},
        batch_idx=batch_idx.astype(np.int16),
        **{f"eps_{i}": e for i, e in enumerate(eps)},
        losses=losses,
        jitter_init=failing_members(init),
        jitter_step10=failing_members(res.model),
        checksums=checksums,
        splits=np.asarray(SPLITS),
        lr=np.float64(cfg.lr),
        num_inducing=np.int64(cfg.num_inducing),
        num_samples=np.int64(cfg.num_samples),
        jax_version=np.str_(jax.__version__),
    )
    print(f"pinned {OUT} ({OUT.stat().st_size} bytes): losses at step 0 {losses[0]}, step {STEPS - 1} "
          f"{losses[-1]}; plain f32 Cholesky fails at init {failing_members(init).tolist()}, "
          f"after {STEPS} steps {failing_members(res.model).tolist()}")


if __name__ == "__main__":
    main()
