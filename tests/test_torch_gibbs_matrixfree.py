"""The matrix-free Gibbs MAP path of the port against the JAX package,
float64 on the CPU: the prior's matrix-free methods
(``priors/lognormal_process.py``), ``GibbsExactGP.loss_matrixfree`` and the
matrix-free posterior, state and query (``models/gibbs_gp.py``), then the
port's quickstart and step 0 of the pinned JAX run in float32.

Both sides get the same data, the same hoisted prior state and the draws
their keys yield.  The JAX side runs its panel paths (``fused_matvec=
False``); on the CPU the port's K2 and K3 take their plain versions.  At 8
mBCG iterations values and gradients agree to rtol 1e-8 of each array's
largest entry (CG is not forward stable: two right implementations drift
apart past ~10 iterations on the prior's jittered Gram).  The prior's
lengthscale is 0.6 here, so that its Gram is well conditioned enough for
that budget.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonstationary_precip_tpu.models.gibbs_gp import GibbsExactGP as JGibbs
from nonstationary_precip_tpu.priors.lognormal_process import LogNormalProcess as JPrior
from nonstationary_precip_tpu_torch.examples import quickstart_gibbs_largen as quickstart
from nonstationary_precip_tpu_torch.models.gibbs_gp import GibbsExactGP
from nonstationary_precip_tpu_torch.ops.lazy_cg import lazy_pivoted_cholesky
from nonstationary_precip_tpu_torch.priors.lognormal_process import LogNormalProcess, _dim_cross

torch.set_num_threads(1)
RTOL = 1e-8
N, BLOCK, ITERS, RANK, PRIOR_RANK = 128, 64, 8, 20, 16
F64 = torch.float64
PRIOR = dict(mean=float(np.log(0.5)), outputscale=1.0, lengthscale=0.6)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=F64, requires_grad=grad)


def _close(a, b, rtol=RTOL):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=rtol * max(np.abs(b).max(), 1e-300))


def _draws(key, rank, n, num):
    k1, k2 = jax.random.split(key)
    return (_t(jax.random.normal(k1, (rank, num), jnp.float64)), _t(jax.random.normal(k2, (n, num), jnp.float64)))


def _setup(seed=0):
    """(x, y, x_test, log ℓ) and the two models at the same pose."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, 3, size=(N, 2))
    y = quickstart.truth(x) + 0.1 * rng.normal(size=N)
    xs = rng.uniform(-3, 3, size=(10, 2))
    log_ell = np.log(0.5) + 0.2 * rng.normal(size=(N, 2))
    jm = JGibbs.create(jnp.asarray(x), JPrior.create(2, dtype=jnp.float64, **PRIOR), noise=0.05, outputscale=1.0,
                       dtype=jnp.float64)
    jm = dataclasses.replace(jm, log_ell=jnp.asarray(log_ell))
    tm = GibbsExactGP.create(_t(x), LogNormalProcess.create(2, dtype=F64, **PRIOR), noise=0.05, outputscale=1.0,
                             dtype=F64).trainable(train_noise=True, train_scale=True)
    with torch.no_grad():
        tm.log_ell.copy_(_t(log_ell))
    return x, y, xs, jm, tm


def _jax_pre(jm, x):
    """JAX's hoisted prior state (jitted: its eager CG loops take seconds)
    and its torch copy."""
    pre = jax.jit(lambda m, xx: m.prior_pre_matrixfree(xx, jax.random.PRNGKey(1), rank=PRIOR_RANK, block=BLOCK,
                                                       num_probes=16, max_iters=ITERS, tol=1e-10))(jm, jnp.asarray(x))
    return pre, tuple(_t(p) for p in pre)


def test_prior_gram_pre_lazy_matches_jax():
    """Per-dim factors and SLQ logdets, the port fed the draws of the JAX
    keys ``fold_in(key, d)``."""
    x, _, _, jm, tm = _setup()
    pre, _ = _jax_pre(jm, x)
    noise = [_draws(jax.random.fold_in(jax.random.PRNGKey(1), d), PRIOR_RANK, N, 16) for d in range(2)]
    lpc, logdet = tm.prior_pre_matrixfree(_t(x), noise, rank=PRIOR_RANK, block=BLOCK, max_iters=ITERS, tol=1e-10)
    _close(lpc, pre[0])
    _close(logdet, pre[1])
    # the factor is the same greedy pivoted Cholesky of each dim's Gram
    ell, s2 = tm.prior._dim_params()[0]
    _close(lazy_pivoted_cholesky((ell, s2), _t(x), PRIOR_RANK, cross_fn=_dim_cross), pre[0][0])


def test_prior_log_prob_matrixfree_value_and_grad_match_jax():
    """Value and the gradient in the field; the prior's hypers get none."""
    x, _, _, jm, tm = _setup(seed=1)
    pre, tpre = _jax_pre(jm, x)
    kw = dict(block=BLOCK, max_iters=ITERS, tol=1e-10)
    jv, jg = jax.jit(jax.value_and_grad(lambda le: jm.prior.log_prob_matrixfree(jnp.asarray(x), le, pre, **kw)))(
        jm.log_ell)
    le = _t(np.asarray(jm.log_ell), True)
    val = tm.prior.log_prob_matrixfree(_t(x), le, tpre, **kw)
    val.backward()
    _close(val.detach(), jv)
    _close(le.grad, jg)
    assert all(p.grad is None for p in tm.prior.parameters())


def test_prior_conditional_matrixfree_matches_jax():
    """The conditioning solves, the per-query panels and their composition,
    and the host-chunked route of the solves."""
    x, _, xs, jm, tm = _setup(seed=2)
    pre, tpre = _jax_pre(jm, x)
    kw = dict(block=BLOCK, max_iters=ITERS, tol=1e-10)
    given_j = (jnp.asarray(x), jnp.exp(jm.log_ell))
    given_t = (_t(x), torch.exp(_t(np.asarray(jm.log_ell))))
    ja = jax.jit(lambda p: jm.prior.conditional_pre_matrixfree(given_j, p, **kw))(pre)
    ta = tm.prior.conditional_pre_matrixfree(given_t, tpre, **kw)
    _close(ta, ja)
    jmean = jm.prior.conditional_mean_from_pre(jnp.asarray(xs), given_j, ja, block=4)
    tmean = tm.prior.conditional_mean_from_pre(_t(xs), given_t, ta, block=4)
    _close(tmean, jmean)
    _close(tm.prior.conditional_mean_matrixfree(_t(xs), given_t, tpre, **kw), jmean)
    # the host-chunked route (ported): the same iterations, stopped early once converged
    _close(tm.prior.conditional_pre_matrixfree(given_t, tpre, chunk_iters=4, **kw), ja)


def test_loss_matrixfree_value_and_grads_match_jax():
    """The MAP loss, prior included, and its gradients in the field, the
    raw outputscale and the raw noise, against JAX's panel path on the
    same probes; the other matvec precisions, and an unknown one raising."""
    x, y, _, jm, tm = _setup(seed=3)
    pre, tpre = _jax_pre(jm, x)
    key = jax.random.PRNGKey(7)
    kw = dict(block=BLOCK, max_iters=ITERS, tol=1e-10, precond_rank=RANK, prior_max_iters=ITERS)

    def jloss(m):
        return m.loss_matrixfree(jnp.asarray(x), jnp.asarray(y), key, pre, num_probes=8, fused_matvec=False, **kw)

    jv, jg = jax.jit(jax.value_and_grad(jloss))(jm)
    val = tm.loss_matrixfree(_t(x), _t(y), _draws(key, RANK, N, 8), tpre, **kw)
    val.backward()
    _close(val.detach(), jv)
    _close(tm.log_ell.grad, jg.log_ell)
    _close(tm.raw_outputscale.grad, jg.raw_outputscale)
    _close(tm.likelihood.raw_noise.grad, jg.likelihood.raw_noise)
    # the other contraction modes (ported): 'vpu' is the same estimand, 'high3' within its bf16 3-pass error
    draws = _draws(key, RANK, N, 8)
    with torch.no_grad():
        _close(tm.loss_matrixfree(_t(x), _t(y), draws, tpre, matvec_precision="vpu", **kw), jv)
        hi3 = tm.loss_matrixfree(_t(x), _t(y), draws, tpre, matvec_precision="high3", **kw)
    assert abs(float(hi3) - float(jv)) <= 1e-4 * abs(float(jv))
    with pytest.raises(ValueError, match="precision"):
        tm.loss_matrixfree(_t(x), _t(y), draws, tpre, matvec_precision="high", **kw)


def test_posterior_matrixfree_and_state_match_jax():
    """The one-shot posterior (mean, noiseless and noisy cov), the state
    and its queries (mean-only, with variance and ``return_info``), and the
    host-chunked routes at the same budget."""
    x, y, xs, jm, tm = _setup(seed=4)
    pre, tpre = _jax_pre(jm, x)
    kw = dict(block=BLOCK, max_iters=ITERS, tol=1e-10, precond_rank=RANK)
    jx, jy, jxs, tx, ty, txs = jnp.asarray(x), jnp.asarray(y), jnp.asarray(xs), _t(x), _t(y), _t(xs)
    for noiseless in (True, False):
        jp = jax.jit(lambda m, p, nl=noiseless: m.posterior_matrixfree(jx, jy, jxs, p, noiseless=nl, fused_matvec=False,
                                                                       **kw))(jm, pre)
        tp = tm.posterior_matrixfree(tx, ty, txs, tpre, noiseless=noiseless, **kw)
        _close(tp.mean, jp.mean)
        _close(tp.cov, jp.cov)

    skw = dict(block=BLOCK, max_iters=ITERS, tol=1e-10, precond_rank=RANK, prior_max_iters=ITERS)
    jst = jax.jit(lambda m, p: m.posterior_state_matrixfree(jx, jy, p, fused_matvec=False, **skw))(jm, pre)
    tst = tm.posterior_state_matrixfree(tx, ty, tpre, **skw)
    _close(tst[0].alpha, jst[0].alpha)
    _close(tst[1], jst[1])
    qkw = dict(block=BLOCK, max_iters=ITERS, tol=1e-10)
    jmean = jax.jit(lambda m, st: m.posterior_matrixfree_from_state(st, jxs, mean_only=True, fused_matvec=False,
                                                                     **qkw))(jm, jst)
    tmean = tm.posterior_matrixfree_from_state(tst, txs, mean_only=True, **qkw)
    _close(tmean, jmean)
    jpost, jinfo = jax.jit(lambda m, st: m.posterior_matrixfree_from_state(st, jxs, fused_matvec=False,
                                                                            return_info=True, **qkw))(jm, jst)
    tpost, tinfo = tm.posterior_matrixfree_from_state(tst, txs, return_info=True, **qkw)
    _close(tpost.mean, jpost.mean)
    _close(tpost.cov, jpost.cov)
    _close(tinfo["relres_max"], jinfo["relres_max"])
    # the host-chunked routes (ported; tests/test_torch_chunked.py holds them to JAX's): at a budget of
    # ITERS = 8 iterations as 2 chunks of 4, the same state and query
    cst = tm.posterior_state_matrixfree(tx, ty, tpre, chunk_iters=4, n_chunks=2, **skw)
    _close(cst[0].alpha, tst[0].alpha)
    _close(cst[1], tst[1])
    cpost = tm.posterior_matrixfree_from_state(cst, txs, chunk_iters=4, n_chunks=2, **qkw)
    _close(cpost.mean, tpost.mean)
    _close(cpost.cov, tpost.cov)


def test_quickstart_main_runs_on_the_cpu():
    """The port's quickstart at a tiny N on the CPU, with its own asserts
    (finite losses, the dense-loss band, a finite RMSE, the state's drift)."""
    rmse = quickstart.main(["--device", "cpu", "--n", "128", "--steps", "4", "--block", "64"])
    assert np.isfinite(rmse)


def test_quickstart_gradient_puts_the_field_first():
    """``value_and_grads`` flattens the field's gradient first, whatever the
    order of ``model.parameters()`` (the outputscale comes first there), so
    that the quickstart's and chip_smoke.py's field slices are the field's."""
    x = torch.tensor(np.random.default_rng(3).uniform(-3, 3, size=(16, 2)), dtype=torch.float32)
    model = quickstart.build_model(x)
    assert next(iter(model.parameters())) is not model.log_ell
    w = torch.arange(model.log_ell.numel(), dtype=torch.float32).reshape(model.log_ell.shape)

    def loss(m):
        return torch.sum(w * m.log_ell) + 7.0 * m.raw_outputscale + 11.0 * m.likelihood.raw_noise

    _, grads = quickstart.value_and_grads(loss, model)
    np.testing.assert_array_equal(grads.numpy(), np.concatenate([w.reshape(-1).numpy(), [7.0, 11.0]]))


def test_pinned_jax_run_step0_on_the_cpu():
    """Step 0 of the pinned JAX run (tests/fixtures/jax_gibbs_mf_ref.npz,
    float32, N = 2048) through the port's quickstart pieces on the CPU: the
    same loss to rtol 1e-4 (the port's CPU run: 4.0e-7).  The prior's
    constant logdet is the pinned run's (its f32 SLQ at tol 1e-8 runs past
    convergence and moves with the rounding; ROADMAP §3, F5), and its factors
    are rebuilt here without the SLQ.  The data term's mBCG runs 24
    iterations, past the 21 by which every column of this solve converges
    (``lazy_cg_diagnostics``), so its value is the run's at 48; at the init
    pose the field is the prior mean, so the prior's quadratic is 0 for any
    budget and runs 1 iteration.  The whole run is on the card
    (chip_smoke.py's gibbs_mf_ref)."""
    ref = np.load(Path(__file__).resolve().parent / "fixtures" / "jax_gibbs_mf_ref.npz")
    x, y = torch.tensor(ref["x"]), torch.tensor(ref["y"])
    model = quickstart.build_model(x)
    lpc = torch.stack([lazy_pivoted_cholesky(p, x, int(ref["prior_rank"]), cross_fn=_dim_cross)
                       for p in model.prior._dim_params()])
    noise = (torch.tensor(ref["step_u1"][0]), torch.tensor(ref["step_u2"][0]))
    with torch.no_grad():
        loss = model.loss_matrixfree(x, y, noise, (lpc, torch.tensor(ref["prior_logdet"])), block=int(ref["block"]),
                                     max_iters=24, tol=1e-6,
                                     precond_lpc=model.precond_factor(x, rank=int(ref["rank"])), prior_max_iters=1)
    assert abs(float(loss) - ref["losses"][0]) <= 1e-4 * abs(ref["losses"][0])
