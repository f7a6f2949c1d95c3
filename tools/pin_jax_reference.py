"""Pin the JAX package's 10-split Gibbs MAP losses as a committed fixture
(tests/fixtures/jax_spatial_gibbs_ref.npz), for checks that run where JAX is
absent: the PyTorch port's chip smoke test compares its own losses on the
card with these numbers, and tests/test_torch_jax_reference.py holds the
port's CPU run to them.

What is pinned: the JAX experiment (nonstationary_precip_tpu.experiments.
spatial_gibbs, exact inference, its default hypers) in float32 on the CPU,
on the real UIB data and all 10 splits — the per-split MAP loss at the
initial pose (step 0) and after 50 Adam steps (lr 0.01), plus checksums of
each split's training inputs so a consumer can tell that it trains on the
same data.  On the CPU ``gibbs_map_loss_batched`` takes its vmapped
per-split loss, the same math as the batched (L, L⁻¹) kernel path.

Run: python tools/pin_jax_reference.py  (regenerates the .npz; do this
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

from nonstationary_precip_tpu.data.datasets import load_uib_spatial  # noqa: E402
from nonstationary_precip_tpu.experiments.spatial_gibbs import build_prior, make_split  # noqa: E402
from nonstationary_precip_tpu.models.gibbs_gp import gibbs_map_loss_batched  # noqa: E402
from nonstationary_precip_tpu.train.config import ExperimentConfig  # noqa: E402
from nonstationary_precip_tpu.train.vmapped import Stacked, fit_splits  # noqa: E402

OUT = pathlib.Path(__file__).resolve().parent.parent / "tests" / "fixtures" / "jax_spatial_gibbs_ref.npz"
STEPS = 50
NUM_SPLITS = 10


def split_checksums(x_train, y_train):
    """(K, 3) float64: Σx, Σx², Σy of each split's training rows — order-
    independent, so they pin membership rather than row order."""
    x = np.asarray(x_train, np.float64)
    y = np.asarray(y_train, np.float64)
    return np.stack([x.sum(axis=(-1, -2)), (x * x).sum(axis=(-1, -2)), y.sum(axis=-1)], axis=-1)


def main():
    if jax.config.jax_enable_x64:
        raise SystemExit("pin in float32: unset JAX_ENABLE_X64")
    cfg = ExperimentConfig(lr=0.01, max_iters=STEPS + 1)
    dtype = jnp.float32
    _, x, y = load_uib_spatial()
    x_norm = (x - x.mean(0)) / x.std(0, ddof=1)
    y_norm = (y - y.mean()) / y.std(ddof=1)
    splits = [make_split(x_norm, y_norm, s, cfg, dtype) for s in range(NUM_SPLITS)]
    models = [s[0] for s in splits]
    masks = [s[1] for s in splits]
    xs = jnp.stack([s[2][0] for s in splits])
    ys = jnp.stack([s[2][1] for s in splits])
    pre = jax.jit(jax.vmap(build_prior(cfg, dtype).gram_pre))(xs)
    res = fit_splits(
        models,
        lambda m, xx, yy, pc: m.loss(xx, yy, pc),
        list(xs), list(ys), Stacked(pre),
        lr=cfg.lr,
        num_steps=STEPS + 1,
        masks=masks,
        batched_loss=gibbs_map_loss_batched,
    )
    losses = np.asarray(res.losses)  # (STEPS + 1, K)
    OUT.parent.mkdir(exist_ok=True)
    np.savez_compressed(
        OUT,
        loss_step0=losses[0],
        loss_step50=losses[STEPS],
        steps=np.int64(STEPS),
        lr=np.float64(cfg.lr),
        checksums=split_checksums(xs, ys),
        jax_version=np.str_(jax.__version__),
    )
    print(f"pinned {OUT}: step-0 losses {losses[0]}, step-{STEPS} losses {losses[STEPS]}")


if __name__ == "__main__":
    main()
