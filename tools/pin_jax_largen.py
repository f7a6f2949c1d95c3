"""Pin the JAX package's large-N matrix-free Gibbs run as a committed fixture
(tests/fixtures/jax_gibbs_largen_ref.npz), for checks that run where JAX is
absent: chip_smoke.py runs the PyTorch port's experiment on the card on
these inputs and holds its losses to these.

What is pinned: the loop of ``nonstationary_precip_tpu.experiments.
gibbs_largen`` (lazy_cg_mll with the rank-150 greedy pivoted-Cholesky
preconditioner, 8 probes, 16 mBCG iterations, block 2048, 20 Adam steps at
lr 1e-2), in float32 on the CPU, at N = 2048: its data x, y; the standard
normal draws u1, u2 that its key yields for the probes (``ops/bbmm.py:297-
299``); the 20 losses; the trained parameters; the trained-pose
diagnostics; and the lazy and dense losses and the gradient cosine there.
On the CPU the loop takes the panel matvec and the panel-scan backward,
the same math as the fused kernels.

Run: python tools/pin_jax_largen.py  (regenerates the .npz; do this
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

from nonstationary_precip_tpu.experiments.gibbs_largen import _D, _data  # noqa: E402
from nonstationary_precip_tpu.kernels.gibbs import gibbs_gram_reference, packed_gibbs_cross  # noqa: E402
from nonstationary_precip_tpu.ops.lazy_cg import lazy_cg_diagnostics, lazy_cg_mll  # noqa: E402
from nonstationary_precip_tpu.ops.linalg import mvn_logpdf_from_chol, safe_cholesky  # noqa: E402
from nonstationary_precip_tpu.utils.transforms import positive  # noqa: E402

OUT = pathlib.Path(__file__).resolve().parent.parent / "tests" / "fixtures" / "jax_gibbs_largen_ref.npz"
N, STEPS, RANK, ITERS, BLOCK, SEED, LR, PROBES = 2048, 20, 150, 16, 2048, 173, 1e-2, 8


def probe_draws(key, rank, n, dtype=jnp.float32):
    """The normal draws ``sample_precond_probes(key, ...)`` makes."""
    k1, k2 = jax.random.split(key)
    return jax.random.normal(k1, (rank, PROBES), dtype), jax.random.normal(k2, (n, PROBES), dtype)


def jax_largen(n, steps, rank, iters, block=BLOCK, seed=SEED, lr=LR):
    """The JAX experiment's loop, gate and oracle (``experiments/
    gibbs_largen.py:79-162``), returning what it computes instead of only
    printing it."""
    x, y = _data(n)
    key = jax.random.PRNGKey(seed)
    cross = packed_gibbs_cross(_D)
    params = {
        "log_ell_pp": jnp.zeros((n, _D), jnp.float32),
        "raw_s2": jnp.asarray(0.5, jnp.float32),
        "log_noise": jnp.asarray(-2.0, jnp.float32),
    }
    kw = dict(block=block, num_probes=PROBES, max_iters=iters, tol=1e-6, precond_rank=rank, cross_fn=cross)

    def loss(p):
        aug = jnp.concatenate([x, p["log_ell_pp"]], axis=1)
        return -lazy_cg_mll(p["raw_s2"], aug, y, key, jnp.exp(p["log_noise"]), **kw) / n

    def loss_dense(p):
        ell = jnp.exp(p["log_ell_pp"])
        k = positive(p["raw_s2"]) * gibbs_gram_reference(x, ell, x, ell)
        k = k + jnp.exp(p["log_noise"]) * jnp.eye(n, dtype=x.dtype)
        return -mvn_logpdf_from_chol(y, jnp.zeros_like(y), safe_cholesky(k)) / n

    opt = optax.adam(lr)

    @jax.jit
    def train(p):
        def body(carry, _):
            pp, s = carry
            val, g = jax.value_and_grad(loss)(pp)
            up, s = opt.update(g, s)
            return (optax.apply_updates(pp, up), s), val

        (p, _), vals = jax.lax.scan(body, (p, opt.init(p)), None, length=steps)
        return p, vals

    p, vals = train(params)
    aug = jnp.concatenate([x, p["log_ell_pp"]], axis=1)
    diag = lazy_cg_diagnostics(p["raw_s2"], aug, y, key, jnp.exp(p["log_noise"]), **kw)
    lv, lg = jax.jit(jax.value_and_grad(loss))(p)
    dv, dg = jax.jit(jax.value_and_grad(loss_dense))(p)
    lf = jnp.concatenate([jnp.ravel(v) for v in jax.tree.leaves(lg)])
    df = jnp.concatenate([jnp.ravel(v) for v in jax.tree.leaves(dg)])
    u1, u2 = probe_draws(key, rank, n)
    return {
        "x": np.asarray(x), "y": np.asarray(y), "u1": np.asarray(u1), "u2": np.asarray(u2),
        "losses": np.asarray(vals), "params": {k: np.asarray(v) for k, v in p.items()}, "diag": diag,
        "loss_lazy": float(lv), "loss_dense": float(dv),
        "grad_cosine": float(jnp.dot(lf, df) / (jnp.linalg.norm(lf) * jnp.linalg.norm(df))),
    }


def main():
    if jax.config.jax_enable_x64:
        raise SystemExit("pin in float32: unset JAX_ENABLE_X64")
    out = jax_largen(N, STEPS, RANK, ITERS)
    OUT.parent.mkdir(exist_ok=True)
    np.savez_compressed(
        OUT,
        x=out["x"], y=out["y"], u1=out["u1"], u2=out["u2"], losses=out["losses"],
        **{f"param_{k}": v for k, v in out["params"].items()},
        relres_solve=np.float64(out["diag"]["relres_solve"]), relres_max=np.float64(out["diag"]["relres_max"]),
        iters_max=np.int64(out["diag"]["iters_max"]), broke=np.bool_(out["diag"]["broke"]),
        loss_lazy=np.float64(out["loss_lazy"]), loss_dense=np.float64(out["loss_dense"]),
        grad_cosine=np.float64(out["grad_cosine"]),
        n=np.int64(N), steps=np.int64(STEPS), rank=np.int64(RANK), iters=np.int64(ITERS), block=np.int64(BLOCK),
        seed=np.int64(SEED), lr=np.float64(LR), jax_version=np.str_(jax.__version__),
    )
    print(f"pinned {OUT}: losses {out['losses'][0]:.6f} -> {out['losses'][-1]:.6f}, diag {out['diag']}, "
          f"lazy {out['loss_lazy']:.6f} dense {out['loss_dense']:.6f} cos {out['grad_cosine']:.5f}")


if __name__ == "__main__":
    main()
