"""Pin a JAX run of the matrix-free Gibbs MAP flow (examples/
quickstart_gibbs_largen.py) as a committed fixture
(tests/fixtures/jax_gibbs_mf_ref.npz), for checks that run where JAX is
absent: chip_smoke.py runs the PyTorch port's quickstart on the card on
these inputs and holds its prior logdet, its losses and its posterior to
these.

What is pinned, in float32 on the CPU: the example's data at N = 2048
(``default_rng(11)``: x ~ U(−3, 3)², y, the 96 test points), its prior and
model, and its flow at the sizes of the card's large-N runs: the prior
hoist (``prior_pre_matrixfree``, rank 50, 16 SLQ probes, 96 iterations, tol
1e-8, block 2048), 20 Adam steps of ``loss_matrixfree`` (8 probes, 48 mBCG
iterations, prior 96) with the rank-150 data factor rebuilt every 4 steps,
then ``posterior_matrixfree`` (96 iterations, tol 1e-8, rank 150) at the
trained pose.  The fixture holds the data, the standard normal draws the
keys yield (each step's probes from ``fold_in(PRNGKey(0), step)``, each
prior dim's SLQ probes from ``fold_in(PRNGKey(1), dim)``, as
``ops/bbmm.py:297-299`` splits them), the prior's logdets, the 20 losses,
the trained parameters, the posterior mean and variance, and the
matrix-free and dense losses at the trained pose.  On the CPU the JAX flow
takes the panel matvec and the panel-scan backward (``fused_matvec=False``),
the same math as the fused kernels.

Run: python tools/pin_jax_gibbs_mf.py  (regenerates the .npz; do this
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

from nonstationary_precip_tpu.models.gibbs_gp import GibbsExactGP  # noqa: E402
from nonstationary_precip_tpu.priors.lognormal_process import LogNormalProcess  # noqa: E402

OUT = pathlib.Path(__file__).resolve().parent.parent / "tests" / "fixtures" / "jax_gibbs_mf_ref.npz"
N, STEPS, REFRESH, BLOCK, RANK, PRIOR_RANK = 2048, 20, 4, 2048, 150, 50
PROBES, SLQ_PROBES, ITERS, PRIOR_ITERS, LR = 8, 16, 48, 96, 1e-2


def draws(key, rank, n, num):
    """The normal draws ``sample_precond_probes(key, ...)`` makes."""
    k1, k2 = jax.random.split(key)
    return jax.random.normal(k1, (rank, num), jnp.float32), jax.random.normal(k2, (n, num), jnp.float32)


def main():
    if jax.config.jax_enable_x64:
        raise SystemExit("pin in float32: unset JAX_ENABLE_X64")
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.uniform(-3, 3, size=(N, 2)), jnp.float32)
    y = jnp.sin(2.0 * x[:, 0] * (1.0 + 0.4 * jnp.tanh(x[:, 1]))) + 0.1 * (
        jnp.asarray(rng.normal(size=N), jnp.float32))
    xs = jnp.asarray(rng.uniform(-3, 3, size=(96, 2)), jnp.float32)
    prior = LogNormalProcess.create(2, mean=float(np.log(0.5)), outputscale=1.0, lengthscale=1.5)
    model = GibbsExactGP.create(x, prior, noise=0.05, outputscale=1.0)
    key, prior_key = jax.random.PRNGKey(0), jax.random.PRNGKey(1)
    prior_pre = model.prior_pre_matrixfree(x, prior_key, rank=PRIOR_RANK, block=BLOCK, num_probes=SLQ_PROBES,
                                           max_iters=PRIOR_ITERS, tol=1e-8)
    opt = optax.adam(LR)
    mask = model.trainable(train_noise=True, train_scale=True)

    def loss(m, lpc, i):
        return m.loss_matrixfree(x, y, jax.random.fold_in(key, i), prior_pre, block=BLOCK, num_probes=PROBES,
                                 max_iters=ITERS, tol=1e-6, precond_lpc=lpc, fused_matvec=False,
                                 prior_max_iters=PRIOR_ITERS)

    @jax.jit
    def fit(m):
        st = opt.init(m)

        def inner(carry, i):
            mm, s = carry
            val, g = jax.value_and_grad(loss)(mm[0], mm[1], i)
            g = jax.tree.map(lambda gr, tr: jnp.where(tr, gr, 0.0), g, mask)
            up, s = opt.update(g, s)
            return ((optax.apply_updates(mm[0], up), mm[1]), s), val

        def outer(carry, w):
            mm, s = carry
            lpc = mm.precond_factor(x, rank=RANK)
            ((mm, _), s), vals = jax.lax.scan(inner, ((mm, lpc), s), w * REFRESH + jnp.arange(REFRESH))
            return (mm, s), vals

        (m, _), vals = jax.lax.scan(outer, (m, st), jnp.arange(STEPS // REFRESH))
        return m, vals.reshape(-1)

    trained, vals = fit(model)
    loss_mf = float(loss(trained, trained.precond_factor(x, rank=RANK), 0))
    loss_dense = float(trained.loss(x, y, prior_chols=None))
    post = trained.posterior_matrixfree(x, y, xs, prior_pre, block=BLOCK, max_iters=PRIOR_ITERS, tol=1e-8,
                                        precond_rank=RANK, fused_matvec=False)
    steps = [draws(jax.random.fold_in(key, i), RANK, N, PROBES) for i in range(STEPS)]
    dims = [draws(jax.random.fold_in(prior_key, d), PRIOR_RANK, N, SLQ_PROBES) for d in range(2)]
    OUT.parent.mkdir(exist_ok=True)
    np.savez_compressed(
        OUT, x=np.asarray(x), y=np.asarray(y), xs=np.asarray(xs),
        step_u1=np.stack([np.asarray(u1) for u1, _ in steps]), step_u2=np.stack([np.asarray(u2) for _, u2 in steps]),
        prior_u1=np.stack([np.asarray(u1) for u1, _ in dims]), prior_u2=np.stack([np.asarray(u2) for _, u2 in dims]),
        prior_logdet=np.asarray(prior_pre[1]), losses=np.asarray(vals),
        log_ell=np.asarray(trained.log_ell), raw_outputscale=np.asarray(trained.raw_outputscale),
        raw_noise=np.asarray(trained.likelihood.raw_noise),
        post_mean=np.asarray(post.mean), post_var=np.asarray(jnp.diagonal(post.cov)),
        loss_mf=np.float64(loss_mf), loss_dense=np.float64(loss_dense),
        n=np.int64(N), steps=np.int64(STEPS), refresh=np.int64(REFRESH), block=np.int64(BLOCK),
        rank=np.int64(RANK), prior_rank=np.int64(PRIOR_RANK), jax_version=np.str_(jax.__version__),
    )
    print(f"pinned {OUT}: prior logdet {np.asarray(prior_pre[1])}, losses {float(vals[0]):.6f} -> "
          f"{float(vals[-1]):.6f}, mf {loss_mf:.6f} dense {loss_dense:.6f}")


if __name__ == "__main__":
    main()
