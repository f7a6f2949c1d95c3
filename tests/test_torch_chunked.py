"""The port's host-chunked large-N surface against the JAX package, float64
on the CPU: ``ops/lazy_cg.make_chunked_solve`` / ``make_chunked_mll``,
``models/gibbs_gp.make_chunked_map_loss`` (``ChunkedMAPLoss``),
``train/optim.fit_chunked`` and the chunked posterior routes — the parity
cases of ``tests/test_chunked_api.py`` at its sizes — and F1 and F2, where
the port's chunked query departs from JAX's on purpose.

Both sides get the same data and the draws their keys yield (``_draws``;
RPCholesky's Gumbel rows and the keyed landmarks as JAX draws them).  JAX
runs its panel paths (``fused_matvec=False``); on the CPU the port's K2 and
K3 take their plain versions.  Tolerances: the chunked run against the
port's own monolithic one 1e-10 (the same operations in the same order); the
port against JAX 1e-8 of each array's largest entry (two right
implementations of CG drift apart over tens of iterations).
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonstationary_precip_tpu.kernels.gibbs import packed_gibbs_cross as jcross
from nonstationary_precip_tpu.models.gibbs_gp import GibbsExactGP as JGibbs
from nonstationary_precip_tpu.models.gibbs_gp import make_chunked_map_loss as jmake_loss
from nonstationary_precip_tpu.ops import lazy_cg as jlazy
from nonstationary_precip_tpu.priors.lognormal_process import LogNormalProcess as JPrior
from nonstationary_precip_tpu.train.optim import fit_chunked as jfit_chunked
from nonstationary_precip_tpu_torch.kernels.gibbs import packed_gibbs_cross
from nonstationary_precip_tpu_torch.models.gibbs_gp import GibbsExactGP, make_chunked_map_loss
from nonstationary_precip_tpu_torch.ops import lazy_cg
from nonstationary_precip_tpu_torch.ops.bbmm import mbcg, woodbury_precond
from nonstationary_precip_tpu_torch.priors.lognormal_process import _COND_JITTER, LogNormalProcess, _dim_cross
from nonstationary_precip_tpu_torch.train.checkpoint import BestCheckpointer, restore_pytree
from nonstationary_precip_tpu_torch.train.optim import fit_chunked

torch.set_num_threads(1)
F64 = torch.float64
PRIOR = dict(mean=float(np.log(0.3)), outputscale=1.0, lengthscale=1.3)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _close(a, b, rtol=1e-8):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=rtol * max(np.abs(b).max(), 1e-300))


def _draws(key, rank, n, num):
    k1, k2 = jax.random.split(key)
    return _t(jax.random.normal(k1, (rank, num), jnp.float64)), _t(jax.random.normal(k2, (n, num), jnp.float64))


def _xy(n, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, size=(n, 2))
    return x, np.sin(2 * x[:, 0]) + 0.1 * rng.normal(size=n)


def _models(x, seed=23):
    """The JAX model of ``test_chunked_api._model`` and the port's at its pose."""
    jm = JGibbs.create(jnp.asarray(x), JPrior.create(2, dtype=jnp.float64, **PRIOR), noise=0.1, outputscale=1.3,
                       dtype=jnp.float64)
    log_ell = np.asarray(jm.log_ell) + np.random.default_rng(seed).normal(scale=0.2, size=x.shape)
    jm = dataclasses.replace(jm, log_ell=jnp.asarray(log_ell))
    tm = GibbsExactGP.create(_t(x), LogNormalProcess.create(2, dtype=F64, **PRIOR), noise=0.1, outputscale=1.3,
                             dtype=F64)
    with torch.no_grad():
        tm.log_ell.copy_(_t(log_ell))
    return jm, tm


@functools.lru_cache(maxsize=8)
def _pre(n, rank, block, iters, tol):
    """JAX's hoisted prior state at ``_models(_xy(n))``'s pose, and its torch
    copy (jitted: JAX's eager CG loops take seconds; cached across tests)."""
    x, _ = _xy(n)
    jm, _ = _models(x)
    pre = jax.jit(lambda m, xx: m.prior_pre_matrixfree(xx, jax.random.PRNGKey(9), rank=rank, block=block,
                                                       num_probes=8, max_iters=iters, tol=tol))(jm, jnp.asarray(x))
    return pre, tuple(_t(p) for p in pre)


def _port_pre(tm, x, rank, block):
    """The port's own prior hoist from numpy draws, where no JAX side runs
    (the posterior and the fit use its factors; its logdet is a constant)."""
    rng = np.random.default_rng(9)
    noise = [(_t(rng.normal(size=(rank, 8))), _t(rng.normal(size=(x.shape[0], 8)))) for _ in range(2)]
    return tm.prior_pre_matrixfree(_t(x), noise, rank=rank, block=block, max_iters=16, tol=1e-10)


def _grads_close(tg, jg, rtol):
    _close(tg["log_ell"], jg.log_ell, rtol)
    _close(tg["raw_outputscale"], jg.raw_outputscale, rtol)
    _close(tg["likelihood.raw_noise"], jg.likelihood.raw_noise, rtol)


def test_chunked_solve_matches_monolithic_mbcg_and_jax():
    """The chunked solve re-enters mbcg: the same solution as one run (and
    early stop changes nothing), and JAX's chunked solve's."""
    n = 192
    x, _ = _xy(n)
    params = (_t([1.3, 1.3]), _t(1.0))
    jitter = _t(_COND_JITTER)
    rhs = _t(np.random.default_rng(3).normal(size=(n, 3)))
    lpc = lazy_cg.lazy_pivoted_cholesky(params, _t(x), 16, cross_fn=_dim_cross)
    res = mbcg(lazy_cg._lazy_matvec(params, _t(x), jitter, 64, _dim_cross), rhs, max_iters=64, tol=1e-12,
               precond=woodbury_precond(lpc, jitter))
    solve = lazy_cg.make_chunked_solve(64, 8, 8, 1e-12, _dim_cross, None, 1.0)
    sol, relres = solve(params, _t(x), rhs, jitter, lpc, early_stop=False)
    _close(sol, res.x, 1e-10)
    _close(relres, res.residnorm, 1e-10)
    sol_e, relres_e = solve(params, _t(x), rhs, jitter, lpc, early_stop=True)
    _close(sol_e, sol, 1e-10)
    assert float(relres_e.max()) < 1e-5
    from nonstationary_precip_tpu.priors.lognormal_process import _dim_cross as jdim
    jsolve = jlazy.make_chunked_solve(64, 8, 8, 1e-12, jdim, None, 1.0)
    jsol, _ = jsolve((jnp.asarray([1.3, 1.3]), jnp.asarray(1.0)), jnp.asarray(x), jnp.asarray(rhs.numpy()),
                     jnp.asarray(_COND_JITTER), jnp.asarray(lpc.numpy()), early_stop=False)
    _close(sol, jsol, 1e-6)


def test_chunked_map_loss_matches_loss_matrixfree_and_jax():
    """The chunked MAP loss against the port's monolithic loss_matrixfree
    with the same draws (1e-10) and against JAX's chunked loss (1e-8), value
    and gradients; the prior's hypers get none."""
    n = 256
    x, y = _xy(n)
    jm, tm = _models(x)
    pre, tpre = _pre(n, 24, 64, 300, 1e-12)
    key = jax.random.PRNGKey(11)
    probes = _draws(key, 32, n, 4)
    loss = make_chunked_map_loss(2, block=64, chunk_iters=16, n_chunks=4, tol=1e-11, precond_rank=32,
                                 precond="pivchol", precond_shift=1.0, prior_chunk_iters=32, prior_n_chunks=8)
    v_c, g_c, info = loss.value_and_grad(tm, _t(x), _t(y), tpre, probes)
    assert float(info["relres_max"]) < 1e-7
    tm.trainable(train_noise=True, train_scale=True)
    v_m = tm.loss_matrixfree(_t(x), _t(y), probes, tpre, block=64, max_iters=64, tol=1e-11, precond_rank=32,
                             prior_max_iters=256)
    v_m.backward()
    _close(v_c, v_m.detach(), 1e-10)
    for name in ("log_ell", "raw_outputscale", "likelihood.raw_noise"):
        _close(g_c[name], tm.get_parameter(name).grad, 1e-10)
    assert all(float(g_c[k].abs().max()) == 0.0 for k in g_c if k.startswith("prior."))

    jloss = jmake_loss(2, block=64, num_probes=4, chunk_iters=16, n_chunks=4, tol=1e-11, precond_rank=32,
                       precond="pivchol", precond_shift=1.0, include_prior=True, prior_chunk_iters=32,
                       prior_n_chunks=8, fused_matvec=False)
    jv, jg, _ = jloss.value_and_grad(jm, jnp.asarray(x), jnp.asarray(y), pre, key)
    _close(v_c, jv)
    _grads_close(g_c, jg, 1e-8)


def test_chunked_map_loss_without_prior_matches_raw_mll():
    """include_prior=False is the raw-MLL trainer: its value is the chunked
    MLL ÷ (−n), the port's lazy_cg_mll's with the same draws (1e-10)."""
    n = 128
    x, y = _xy(n)
    _, tm = _models(x)
    probes = _draws(jax.random.PRNGKey(5), 16, n, 4)
    loss = make_chunked_map_loss(2, block=64, chunk_iters=8, n_chunks=4, tol=1e-11, precond_rank=16,
                                 precond="pivchol", precond_shift=1.0, include_prior=False, fused_matvec=False)
    v_c, g_c, _ = loss.value_and_grad(tm, _t(x), _t(y), None, probes)
    aug = torch.cat([_t(x), tm.log_ell.detach()], dim=1)
    v_mono = lazy_cg.lazy_cg_mll(tm.raw_outputscale.detach(), aug, _t(y), probes, tm.likelihood.noise.detach(),
                                 block=64, max_iters=32, tol=1e-11, precond_rank=16, cross_fn=packed_gibbs_cross(2))
    _close(v_c, -v_mono / n, 1e-10)
    assert bool(torch.isfinite(g_c["log_ell"]).all())


def _fit_case(n=128):
    x, y = _xy(n)
    jm, tm = _models(x)
    pre, tpre = _pre(n, 16, 64, 200, 1e-10)
    kw = dict(block=64, chunk_iters=8, n_chunks=4, tol=1e-7, precond_rank=16, precond="pivchol",
              precond_shift=1.0, include_prior=True, prior_chunk_iters=16, prior_n_chunks=8, fused_matvec=False)
    return x, y, jm, tm, pre, tpre, kw


def test_fit_chunked_matches_jax_and_respects_the_mask():
    """Eight Adam steps from the same pose and draws: JAX's losses step by
    step, the relres evidence, the frozen leaves untouched (requires_grad is
    the port's mask, ``trainable()`` the JAX one), and the |Δloss| stop.
    The solves stop at relres 1e-7 (``tol``), so the two trajectories agree
    to about that: 1e-6."""
    x, y, jm, tm, pre, tpre, kw = _fit_case()
    key = jax.random.PRNGKey(0)
    probes = _draws(key, 16, 128, 4)
    frozen = {k: v.detach().clone() for k, v in tm.named_parameters() if not k.startswith("log_ell")}
    res = fit_chunked(tm, make_chunked_map_loss(2, **kw), _t(x), _t(y), tpre, probe_noise=probes, num_steps=8,
                      lr=0.05)
    jres = jfit_chunked(jm, jmake_loss(2, num_probes=4, **kw), jnp.asarray(x), jnp.asarray(y), pre, key=key,
                        num_steps=8, lr=0.05, mask=jm.trainable())
    assert res.steps == 8 and res.losses.shape == (8,) and res.relres.shape == (8,)
    np.testing.assert_allclose(res.losses, np.asarray(jres.losses), rtol=1e-6)
    np.testing.assert_allclose(res.relres, np.asarray(jres.relres), rtol=0.5, atol=1e-9)
    assert float(res.relres.max()) < 1e-2 and res.losses[-1] < res.losses[0]
    for k, v in frozen.items():
        assert torch.equal(tm.get_parameter(k).detach(), v), k
    _close(tm.log_ell.detach(), jres.model.log_ell, 1e-6)
    _, tm2 = _models(x)
    res2 = fit_chunked(tm2, make_chunked_map_loss(2, **kw), _t(x), _t(y), tpre, probe_noise=probes, num_steps=8,
                       lr=0.05, threshold=1e9)
    assert res2.steps == 2


def test_fit_chunked_nan_guard_returns_the_last_finite_model():
    """A loss that turns non-finite at step 3 stops the fit there with the
    parameters whose loss was last finite, as JAX's nan guard does."""
    x, y, _, tm, _, tpre, kw = _fit_case()
    inner = make_chunked_map_loss(2, **kw)
    seen = []

    class Poisoned:
        def value_and_grad(self, model, *a, **k):
            loss, grads, info = inner.value_and_grad(model, *a, **k)
            seen.append(model.log_ell.detach().clone())
            return (loss * math.nan if len(seen) == 4 else loss), grads, info

    res = fit_chunked(tm, Poisoned(), _t(x), _t(y), tpre, probe_noise=_draws(jax.random.PRNGKey(0), 16, 128, 4),
                      num_steps=8, lr=0.05)
    assert res.steps == 3
    assert torch.equal(tm.log_ell.detach(), seen[2])


def test_fit_chunked_composes_with_best_checkpointer(tmp_path):
    """fit_chunked's callback drives BestCheckpointer; the best checkpoint
    restores to the fitted model."""
    n = 96
    x, y = _xy(n)
    jm, tm = _models(x)
    tpre = _port_pre(tm, x, 12, 48)
    loss = make_chunked_map_loss(2, block=48, chunk_iters=8, n_chunks=3, tol=1e-7, precond_rank=12,
                                 precond="pivchol", precond_shift=1.0, prior_chunk_iters=16, prior_n_chunks=8,
                                 fused_matvec=False)
    ck = BestCheckpointer(tmp_path / "ck")
    res = fit_chunked(tm, loss, _t(x), _t(y), tpre, probe_noise=_draws(jax.random.PRNGKey(0), 12, n, 4),
                      num_steps=4, lr=0.05, callback=lambda step, m, losses: ck.update(step, m,
                                                                                        objective=losses[-1]))
    assert np.all(np.diff(res.losses) < 0)
    assert (tmp_path / "ck" / "best" / "meta.json").exists()
    _, fresh = _models(x)
    restored = restore_pytree(tmp_path / "ck" / "best" / "model", fresh)
    assert torch.equal(restored.log_ell, tm.log_ell)


def test_posterior_state_chunked_routes_match_monolithic_and_jax():
    """chunk_iters on the state and the query reproduce the monolithic ones
    and JAX's chunked routes, and the dense posterior."""
    n = 128
    x, y = _xy(n)
    xs, _ = _xy(24, seed=41)
    jm, tm = _models(x)
    pre, tpre = _pre(n, 24, 64, 200, 1e-12)
    kw = dict(block=64, tol=1e-13, precond_rank=16, prior_max_iters=400)
    st_m = tm.posterior_state_matrixfree(_t(x), _t(y), tpre, max_iters=600, **kw)
    st_c = tm.posterior_state_matrixfree(_t(x), _t(y), tpre, chunk_iters=50, n_chunks=12, **kw)
    _close(st_c[0].alpha, st_m[0].alpha, 1e-10)
    assert float(st_c[0].alpha_relres) < 1e-12
    _close(st_c[1], st_m[1], 1e-10)
    mf_m = tm.posterior_matrixfree_from_state(st_m, _t(xs), block=64, max_iters=600, tol=1e-12)
    mf_c, info = tm.posterior_matrixfree_from_state(st_c, _t(xs), block=64, tol=1e-12, chunk_iters=50,
                                                    n_chunks=12, return_info=True)
    _close(mf_c.mean, mf_m.mean, 1e-9)
    _close(mf_c.cov, mf_m.cov, 1e-9)
    assert float(info["relres_max"]) < 1e-10 and not bool(info["broke"])
    with torch.no_grad():
        _close(mf_c.mean, tm.posterior(_t(x), _t(y), _t(xs)).mean, 1e-6)
    jst = jm.posterior_state_matrixfree(jnp.asarray(x), jnp.asarray(y), pre, chunk_iters=50, n_chunks=12,
                                        fused_matvec=False, **kw)
    _close(st_c[0].alpha, jst[0].alpha)
    _close(st_c[1], jst[1])
    jmf = jm.posterior_matrixfree_from_state(jst, jnp.asarray(xs), block=64, tol=1e-12, fused_matvec=False,
                                             chunk_iters=50, n_chunks=12)
    _close(mf_c.mean, jmf.mean)
    _close(mf_c.cov, jmf.cov)


def test_default_auto_budget_query_matches_dense_oracle():
    """The shipped budgets (state at twice the auto budget, queries at it)
    against the dense posterior, with the returned evidence."""
    n = 512
    x, y = _xy(n)
    xs, _ = _xy(16, seed=41)
    jm, tm = _models(x)
    tpre = _port_pre(tm, x, 24, 128)
    st = tm.posterior_state_matrixfree(_t(x), _t(y), tpre, block=128)
    out, info = tm.posterior_matrixfree_from_state(st, _t(xs), block=128, return_info=True)
    assert float(info["relres_max"]) < 1e-2 and float(st[0].alpha_relres) < 1e-2
    with torch.no_grad():
        dense = tm.posterior(_t(x), _t(y), _t(xs))
    np.testing.assert_allclose(out.mean.numpy(), dense.mean.numpy(), rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(torch.diagonal(out.cov).numpy(), torch.diagonal(dense.cov).numpy(), rtol=5e-3,
                               atol=5e-5)


def _rp_draws(pk, rank, n):
    return _t(np.stack([np.asarray(jax.random.gumbel(jax.random.fold_in(pk, j), (n,), jnp.float64))
                        for j in range(rank)]))


def test_chunked_pkey_selects_the_keyed_factor_as_monolithic():
    """An explicit pkey (RPCholesky's draws) makes the chunked loss
    precondition with the keyed factor, as lazy_cg_mll(precond_key=...)
    and JAX's chunked loss do; keyed and greedy estimates differ."""
    n = 128
    x, y = _xy(n)
    le = np.random.default_rng(7).normal(scale=0.2, size=(n, 2))
    aug = _t(np.concatenate([x, le], axis=1))
    key, pk = jax.random.PRNGKey(11), jax.random.PRNGKey(99)
    probes, draws = _draws(key, 24, n, 4), _rp_draws(pk, 24, n)
    kw = dict(block=64, max_iters=48, tol=1e-10, precond_rank=24, cross_fn=packed_gibbs_cross(2))
    v_keyed = lazy_cg.lazy_cg_mll(None, aug, _t(y), probes, 0.05, precond_key=draws, **kw)
    v_greedy = lazy_cg.lazy_cg_mll(None, aug, _t(y), probes, 0.05, **kw)
    m = lazy_cg.make_chunked_mll(64, 12, 4, 1e-10, 24, "pivchol", 1.0, packed_gibbs_cross(2), None, None)
    v_ck = m.value_and_grad(None, aug, _t(y), 0.05, probes, pkey=draws)[0]
    v_cu = m.value_and_grad(None, aug, _t(y), 0.05, probes)[0]
    _close(v_ck, v_keyed, 1e-10)
    _close(v_cu, v_greedy, 1e-10)
    assert abs(float(v_keyed) - float(v_greedy)) > 1e-7
    jm = jlazy.make_chunked_mll(block=64, num_probes=4, chunk_iters=12, n_chunks=4, tol=1e-10, precond_rank=24,
                                precond="pivchol", precond_shift=1.0, cross_fn=jcross(2), matvec_builder=None,
                                panel_vjp=None)
    jv = jm.value_and_grad(None, jnp.asarray(aug.numpy()), jnp.asarray(y), jnp.asarray(0.05), key, pkey=pk)[0]
    _close(v_ck, jv)


def test_row_chunked_backward_matches_full_sweep():
    """bwd_row_chunks splits K3's sweep into row blocks (K3's row entry,
    ``packed_gibbs_panel_vjp(d, rows)``): the gradients equal the one-shot
    sweep's (each output row sums over all columns either way) and JAX's
    row-chunked loss's."""
    from nonstationary_precip_tpu_torch.ops.matvec import packed_gibbs_panel_vjp

    n = 256
    x, y = _xy(n)
    le = np.random.default_rng(7).normal(scale=0.2, size=(n, 2))
    aug = _t(np.concatenate([x, le], axis=1))
    key = jax.random.PRNGKey(11)
    probes = _draws(key, 32, n, 4)
    args = (64, 16, 2, 1e-8, 32, "pivchol", 1.0, packed_gibbs_cross(2), None)
    full = lazy_cg.make_chunked_mll(*args, packed_gibbs_panel_vjp(2)).value_and_grad(_t(0.4), aug, _t(y), 0.05,
                                                                                      probes)
    rows = lazy_cg.make_chunked_mll(*args, packed_gibbs_panel_vjp(2, 4)).value_and_grad(_t(0.4), aug, _t(y), 0.05,
                                                                                         probes)
    assert float(rows[0]) == float(full[0])
    for a, b in zip(rows[2], full[2]):
        _close(a, b, 1e-12)
    jm = jlazy.make_chunked_mll(block=64, num_probes=4, chunk_iters=16, n_chunks=2, tol=1e-8, precond_rank=32,
                                precond="pivchol", precond_shift=1.0, cross_fn=jcross(2), matvec_builder=None,
                                panel_vjp=None)
    jv, _, jg = jm.value_and_grad(jnp.asarray(0.4), jnp.asarray(aug.numpy()), jnp.asarray(y), jnp.asarray(0.05), key)
    _close(rows[0], jv)
    for a, b in zip(rows[2], jg):
        _close(a, b)


def test_product_loss_row_chunked_backward_matches():
    """make_chunked_map_loss(bwd_row_chunks=4) reproduces the one-shot
    product loss, prior included; without the fused path it refuses, as
    the JAX package does."""
    x, y, _, tm, _, tpre, kw = _fit_case()
    probes = _draws(jax.random.PRNGKey(3), 16, 128, 4)
    kw = {**kw, "tol": 1e-8, "fused_matvec": True}
    v1, g1, _ = make_chunked_map_loss(2, **kw).value_and_grad(tm, _t(x), _t(y), tpre, probes)
    v4, g4, _ = make_chunked_map_loss(2, bwd_row_chunks=4, **kw).value_and_grad(tm, _t(x), _t(y), tpre, probes)
    assert float(v4) == float(v1)
    for name in ("log_ell", "raw_outputscale", "likelihood.raw_noise"):
        _close(g4[name], g1[name], 1e-12)
    with pytest.raises(ValueError, match="bwd_row_chunks > 1 needs the fused"):
        make_chunked_map_loss(2, bwd_row_chunks=4, **{**kw, "fused_matvec": False})


def _broken_state(n=64):
    """A posterior state whose operator is indefinite (σ² < 0), so the
    variance solve breaks down, and a healthy α."""
    x, y = _xy(n)
    aug = _t(np.concatenate([x, np.zeros((n, 2))], axis=1))
    st = lazy_cg.lazy_posterior_state(None, aug, _t(y), 0.1, block=32, precond_rank=0,
                                      cross_fn=packed_gibbs_cross(2))
    return st._replace(sigma2=_t(-0.9)), aug


def test_chunked_query_breakdown_nans_mean_and_cov_regression():
    """F1: on a variance-solve breakdown the port's chunked query NaNs both
    mean and cov, as its one-shot query (and JAX's one-shot) does; JAX's
    chunked query NaNs only cov (``lazy_cg.py:1008-1023``), though its
    docstring promises the one-shot conventions.  The port departs from the
    reference here on purpose."""
    st, aug = _broken_state()
    xt = aug[:5] + 0.01
    mean, cov, info = lazy_cg.lazy_posterior_query_chunked(st, xt, block=32, chunk_iters=8, n_chunks=2,
                                                           cross_fn=packed_gibbs_cross(2), return_info=True)
    assert bool(info["broke"]) and bool(torch.isnan(mean).all()) and bool(torch.isnan(cov).all())
    m1, c1, i1 = lazy_cg.lazy_posterior_query(st, xt, block=32, max_iters=16, cross_fn=packed_gibbs_cross(2),
                                              return_info=True)
    assert bool(i1["broke"]) and bool(torch.isnan(m1).all()) and bool(torch.isnan(c1).all())
    jst = jlazy.LazyPosteriorState(None, jnp.asarray(st.x.numpy()), jnp.asarray(st.alpha.numpy()),
                                   jnp.asarray(st.lpc.numpy()), jnp.asarray(-0.9), jnp.asarray(0.0))
    jmean, jcov = jlazy.lazy_posterior_query_chunked(jst, jnp.asarray(xt.numpy()), block=32, chunk_iters=8,
                                                     n_chunks=2, cross_fn=jcross(2))
    assert np.isfinite(np.asarray(jmean)).all() and np.isnan(np.asarray(jcov)).all()


def test_chunked_query_broke_flag_from_the_carry_regression():
    """F2: ``info["broke"]`` is the CG carry's flag, and in the mean-only
    branch the α solve's (the state's NaN α); JAX takes isnan(sol[0]) and
    reports False in the mean-only branch even when α has broken down."""
    st, aug = _broken_state()
    xt = aug[:5] + 0.01
    _, _, info = lazy_cg.lazy_posterior_query_chunked(st, xt, block=32, chunk_iters=8, n_chunks=2,
                                                      cross_fn=packed_gibbs_cross(2), return_info=True)
    assert bool(info["broke"])
    dead = st._replace(alpha=torch.full_like(st.alpha, math.nan))
    mean, _, info = lazy_cg.lazy_posterior_query_chunked(dead, xt, mean_only=True, block=32,
                                                         cross_fn=packed_gibbs_cross(2), return_info=True)
    assert bool(info["broke"]) and bool(torch.isnan(mean).all())
    healthy = lazy_cg.lazy_posterior_query_chunked(st, xt, mean_only=True, block=32, cross_fn=packed_gibbs_cross(2),
                                                   return_info=True)[2]
    assert not bool(healthy["broke"])
    jdead = jlazy.LazyPosteriorState(None, jnp.asarray(aug.numpy()), jnp.full((64,), jnp.nan), jnp.zeros((64, 0)),
                                     jnp.asarray(0.1), jnp.asarray(0.0))
    jinfo = jlazy.lazy_posterior_query_chunked(jdead, jnp.asarray(xt.numpy()), mean_only=True, block=32,
                                               cross_fn=jcross(2), return_info=True)[2]
    assert not bool(jinfo["broke"])
