"""Pin a JAX run of bench_scaling.py's Gibbs MAP row at N = 1024 as a
committed fixture (tests/fixtures/jax_gibbs_dense_ref.npz), for checks that
run where JAX is absent: chip_smoke.py runs the PyTorch port on the card from
this run's init and holds its losses and its predictive to these.

What is pinned, in float32 on the CPU: ``bench_scaling.py:33-88``'s first
Gibbs row (x ~ N(0, 1)² from the first 1024 × 2 normals of
``default_rng(0)``, y = sin x₀, the ``LogNormalProcess(2, mean=log 0.3,
outputscale=1, lengthscale=1.3)`` prior with ``gram_chol`` hoisted,
``GibbsExactGP(noise=0.011, outputscale=0.644)``), trained as the port's
``experiments/exact_largen.gibbs_dense`` trains it: the latent field only
(``model.trainable()``), Adam lr 0.01 for 20 steps.  Then the predictive at
the 16 × 16 grid on [−2, 2]² (``gibbs_dense``'s).  The fixture holds x and
y, the init's leaves (``init.<leaf>``), the 20 losses, the trained field,
the grid, the predictive mean and variance, and the RMSE of the mean
against sin x₀ and the joint NLPD per point.  On the CPU the JAX loss takes
its composed path (``pallas_fused.eligible`` is False there).

Run: python tools/pin_jax_gibbs_dense.py  (regenerates the .npz; do this
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

from nonstationary_precip_tpu.models import GibbsExactGP  # noqa: E402
from nonstationary_precip_tpu.priors import LogNormalProcess  # noqa: E402
from nonstationary_precip_tpu.train.metrics import nlpd_joint, rmse_raw  # noqa: E402
from nonstationary_precip_tpu.train.optim import fit  # noqa: E402

OUT = pathlib.Path(__file__).resolve().parent.parent / "tests" / "fixtures" / "jax_gibbs_dense_ref.npz"
N, STEPS, LR, GRID = 1024, 20, 0.01, 16


def leaves(model) -> dict:
    """A JAX model's leaves by dotted path (the port's parameter names)."""
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(model)[0]:
        out[jax.tree_util.keystr(path)[1:].replace("[", ".").replace("]", "")] = np.asarray(v)
    return out


def grid() -> np.ndarray:
    g = np.linspace(-2.0, 2.0, GRID)
    return np.stack(np.meshgrid(g, g, indexing="ij"), axis=-1).reshape(-1, 2)


def run(n: int, steps: int, dtype):
    x = jnp.asarray(np.random.default_rng(0).normal(size=(n, 2)), dtype)
    y = jnp.sin(x[:, 0])
    prior = LogNormalProcess.create(2, mean=float(np.log(0.3)), outputscale=1.0, lengthscale=1.3, dtype=dtype)
    model = GibbsExactGP.create(x, prior, noise=0.011, outputscale=0.644, dtype=dtype)
    pc = prior.gram_chol(x)
    res = fit(model, lambda m, xx, yy: m.loss(xx, yy, pc), x, y, lr=LR, num_steps=steps, mask=model.trainable())
    xq = jnp.asarray(grid(), dtype)
    yq = jnp.sin(xq[:, 0])
    pred = res.model.predictive(x, y, xq)
    return {"x": np.asarray(x), "y": np.asarray(y), "init": leaves(model), "losses": np.asarray(res.losses),
            "log_ell": np.asarray(res.model.log_ell), "grid": np.asarray(xq), "pred_mean": np.asarray(pred.mean),
            "pred_var": np.asarray(jnp.diagonal(pred.cov)), "rmse": float(rmse_raw(pred.mean, yq)),
            "nlpd": float(nlpd_joint(pred, yq, 1.0))}


def main():
    out = run(N, STEPS, jnp.float32)
    init = {f"init.{k}": v for k, v in out.pop("init").items()}
    np.savez_compressed(OUT, n=N, steps=STEPS, lr=LR, **init, **out)
    print(f"wrote {OUT}: losses {out['losses'][0]:.6f} -> {out['losses'][-1]:.6f}, RMSE {out['rmse']:.5f}, "
          f"NLPD {out['nlpd']:.5f}")


if __name__ == "__main__":
    main()
