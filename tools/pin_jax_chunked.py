"""Pin JAX runs of the host-chunked large-N surface as a committed fixture
(tests/fixtures/jax_chunked_ref.npz), for checks that run where JAX is
absent: chip_smoke.py's ``chunked_ref`` phase holds the port's chunked MAP
loss, ``fit_chunked`` and chunked serving state on the card to these.

What is pinned, on the CPU, for the data of examples/quickstart_gibbs_chunked.py
(``default_rng(11)``: x ~ U(−3, 3)², y, 64 query points) at N = 384 and
N = 2048, its prior and model (noise, outputscale and field trained):
  * the prior hoist's SLQ logdets (``prior_pre_matrixfree``: rank 32, 16
    probes from PRNGKey(1), 96 iterations, tol 1e-8; the port builds its own
    factors and takes these constants, as they are constants of training);
  * the step-0 loss and gradients (log ℓ, raw outputscale, raw noise) and
    relres of ``make_chunked_map_loss`` (block 128, chunk_iters 8, n_chunks
    4, tol 1e-6, rank 64, shift 1, prior 16 × 8) under each factor rule:
    greedy pivoted Cholesky, Nyström with the stride landmarks, and at
    N = 384 Nyström with keyed landmarks and RPCholesky with keyed pivots,
    the keys PRNGKey(99) (the landmarks ``permutation(key, n)[:64]`` and the
    Gumbel rows ``gumbel(fold_in(key, j), (n,))`` are pinned);
  * five ``fit_chunked`` steps (lr 2e-2) under greedy pivots;
  * the chunked serving state at the fitted pose (chunk_iters 8, 16
    chunks, tol 1e-8) with its α relres, and its mean-only query;
  * the probe draws the key PRNGKey(0) yields (u1 (64, 8), u2 (N, 8)).
All of that in float32, then the N = 384 step-0 cases in float64 (greedy and
stride Nyström, with their own draws and logdets) at ``LOSS_F64``'s budget
(8 iterations a solve, none stopped early), x64 switched on last.

The Nyström factor's eigenvectors are defined up to sign, which each
LAPACK picks its own way; JAX's ``eigh`` runs here with the port's rule
(``lazy_cg.canonical_eigh``: each eigenvector's largest entry positive),
swapped in at run time, so that both packages' factors meet the pinned
probe draws with the same columns.

Run: python tools/pin_jax_chunked.py  (regenerates the .npz, about 1 min 35 s
on this machine's CPU; do it deliberately).
"""

import os
import pathlib
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from nonstationary_precip_tpu.models.gibbs_gp import GibbsExactGP, make_chunked_map_loss  # noqa: E402
from nonstationary_precip_tpu.priors.lognormal_process import LogNormalProcess  # noqa: E402
from nonstationary_precip_tpu.train.optim import fit_chunked  # noqa: E402

OUT = pathlib.Path(__file__).resolve().parent.parent / "tests" / "fixtures" / "jax_chunked_ref.npz"
NS, N_TEST, RANK, PRIOR_RANK, PROBES, SLQ_PROBES, STEPS, LR = (384, 2048), 64, 64, 32, 8, 16, 5, 2e-2
LOSS = dict(block=128, num_probes=PROBES, chunk_iters=8, n_chunks=4, tol=1e-6, precond_rank=RANK, precond_shift=1.0,
            include_prior=True, prior_chunk_iters=16, prior_n_chunks=8, fused_matvec=False)
CASES = {384: ("pivchol", "nystrom", "nystrom_keyed", "pivchol_keyed"), 2048: ("pivchol", "nystrom")}
F64_CASES = ("pivchol", "nystrom")
# float64 at a budget no solve stops early in (tol below reach, 8 iterations
# each): CG is not forward stable, and a column declared converged one
# iteration apart, or tens of iterations on the prior's ill-conditioned Gram,
# would part two right implementations by far more than 1e-10
LOSS_F64 = {**LOSS, "tol": 1e-14, "chunk_iters": 4, "n_chunks": 2, "prior_chunk_iters": 4, "prior_n_chunks": 2}


def canonical(eigh):
    def wrapped(w, *a, **k):
        lam, v = eigh(w, *a, **k)
        lead = jnp.take_along_axis(v, jnp.argmax(jnp.abs(v), axis=0)[None], axis=0)
        return lam, v * jnp.where(lead < 0, -1.0, 1.0).astype(v.dtype)

    return wrapped


def data(n, dtype):
    rng = np.random.default_rng(11)
    x = rng.uniform(-3, 3, size=(n, 2))
    y = np.sin(2.0 * x[:, 0] * (1.0 + 0.4 * np.tanh(x[:, 1]))) + 0.1 * rng.normal(size=n)
    xs = rng.uniform(-3, 3, size=(N_TEST, 2))
    return (jnp.asarray(a, dtype) for a in (x, y, xs))


def setup(n, dtype):
    x, y, xs = data(n, dtype)
    prior = LogNormalProcess.create(2, mean=float(np.log(0.5)), outputscale=1.0, lengthscale=1.5, dtype=dtype)
    model = GibbsExactGP.create(x, prior, noise=0.05, outputscale=1.0, dtype=dtype)
    pre = model.prior_pre_matrixfree(x, jax.random.PRNGKey(1), rank=PRIOR_RANK, block=LOSS["block"],
                                     num_probes=SLQ_PROBES, max_iters=96, tol=1e-8)
    return x, y, xs, model, pre


def step0(out, tag, n, dtype, cases, cfg=LOSS):
    x, y, _, model, pre = setup(n, dtype)
    key, pk = jax.random.PRNGKey(0), jax.random.PRNGKey(99)
    k1, k2 = jax.random.split(key)
    out[f"{tag}.u1"] = np.asarray(jax.random.normal(k1, (RANK, PROBES), dtype))
    out[f"{tag}.u2"] = np.asarray(jax.random.normal(k2, (n, PROBES), dtype))
    out[f"{tag}.prior_logdet"] = np.asarray(pre[1])
    for case in cases:
        rule, keyed = case.split("_")[0], case.endswith("_keyed")
        loss = make_chunked_map_loss(2, precond=rule, **cfg)
        val, g, info = loss.value_and_grad(model, x, y, pre, key, pkey=pk if keyed else None)
        out.update({f"{tag}.{case}.loss0": np.asarray(val), f"{tag}.{case}.log_ell_grad": np.asarray(g.log_ell),
                    f"{tag}.{case}.raw_outputscale_grad": np.asarray(g.raw_outputscale),
                    f"{tag}.{case}.raw_noise_grad": np.asarray(g.likelihood.raw_noise),
                    f"{tag}.{case}.relres_max": np.asarray(info["relres_max"])})
    if "nystrom_keyed" in cases:
        out[f"{tag}.landmarks"] = np.asarray(jax.random.permutation(pk, n)[:RANK])
    if "pivchol_keyed" in cases:
        out[f"{tag}.gumbel"] = np.stack([np.asarray(jax.random.gumbel(jax.random.fold_in(pk, j), (n,), dtype))
                                         for j in range(RANK)])
    return x, y, model, pre, key


def fit_and_serve(out, tag, n):
    x, y, model, pre, key = step0(out, tag, n, jnp.float32, CASES[n])
    xs = list(data(n, jnp.float32))[2]
    loss = make_chunked_map_loss(2, precond="pivchol", **LOSS)
    res = fit_chunked(model, loss, x, y, pre, key=key, num_steps=STEPS, lr=LR,
                      mask=model.trainable(train_noise=True, train_scale=True))
    m = res.model
    state = m.posterior_state_matrixfree(x, y, pre, block=LOSS["block"], tol=1e-8, precond_rank=RANK,
                                         fused_matvec=False, chunk_iters=8, n_chunks=16)
    mean, info = m.posterior_matrixfree_from_state(state, xs, mean_only=True, block=LOSS["block"],
                                                   fused_matvec=False, chunk_iters=8, n_chunks=16, return_info=True)
    out.update({f"{tag}.fit_losses": np.asarray(res.losses), f"{tag}.fit_relres": np.asarray(res.relres),
                f"{tag}.alpha_relres": np.asarray(state[0].alpha_relres), f"{tag}.query_mean": np.asarray(mean),
                f"{tag}.query_relres_max": np.asarray(info["relres_max"])})


def main():
    if jax.config.jax_enable_x64:
        raise SystemExit("pin float32 first: unset JAX_ENABLE_X64")
    jnp.linalg.eigh = canonical(jnp.linalg.eigh)
    t0 = time.time()
    out = {"ns": np.asarray(NS), "rank": np.asarray(RANK), "steps": np.asarray(STEPS)}
    for n in NS:
        fit_and_serve(out, f"n{n}", n)
        print(f"N = {n} float32 pinned ({time.time() - t0:.0f} s)", flush=True)
    jax.config.update("jax_enable_x64", True)
    step0(out, "n384_f64", 384, jnp.float64, F64_CASES, LOSS_F64)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size / 1e3:.0f} kB) in {time.time() - t0:.0f} s")


if __name__ == "__main__":
    main()
