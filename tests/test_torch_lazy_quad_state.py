"""The frozen-operator primitives, ``precond_shift`` and the amortized
posterior of ``nonstationary_precip_tpu_torch/ops/lazy_cg.py`` against the
JAX package's ``ops/lazy_cg.py``, float64 on the CPU.

Both sides get the same operator (the packed Gibbs payload of
``test_torch_lazy_cg.py``), the same preconditioner factor and the same
probes: JAX draws them from a key, and the port gets the normal (or
Rademacher) draws that key yields.  Values and gradients then agree to
rtol 1e-8 of each array's largest entry at a budget of 8 mBCG iterations
(CG is not forward stable: two right implementations drift apart past ~10
iterations).  The shift's own checks follow the JAX package's tests: with
a converged budget the MLL, the quadratic and the logdet track the dense
float64 values whatever the shift.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonstationary_precip_tpu.kernels.gibbs import packed_gibbs_cross as jcross_of
from nonstationary_precip_tpu.ops import lazy_cg as jlazy
from nonstationary_precip_tpu_torch.kernels.base import Scale
from nonstationary_precip_tpu_torch.kernels.gibbs import packed_gibbs_cross
from nonstationary_precip_tpu_torch.kernels.stationary import RBF
from nonstationary_precip_tpu_torch.ops import lazy_cg

torch.set_num_threads(1)
RTOL = 1e-8
N, D, BLOCK, ITERS, RANK, PROBES = 128, 2, 64, 8, 20, 8
RAW, S2 = 0.8, 0.3


def _problem(seed=11):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, size=(N, D))
    aug = np.concatenate([x, 0.2 * rng.normal(size=(N, D))], axis=1)
    y = np.sin(2 * x[:, 0]) + 0.1 * rng.normal(size=N)
    lpc = np.asarray(jlazy.lazy_pivoted_cholesky(jnp.asarray(RAW), jnp.asarray(aug), RANK, cross_fn=jcross_of(D)))
    return aug, y, lpc, rng


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=grad)


def _close(a, b, rtol=RTOL):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=rtol * max(np.abs(b).max(), 1e-300))


def _draws(key, rank, n, num):
    """The normal draws ``sample_precond_probes(key, ...)`` makes."""
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.normal(k1, (rank, num), jnp.float64)),
            np.asarray(jax.random.normal(k2, (n, num), jnp.float64)))


def _rbf_setup(n, seed=30):
    """The JAX package's tests' problem (tests/test_lazy_cg.py ``_setup``):
    Scale(RBF-ARD) at its init on x ~ N(0, 1)², y ~ N(0, 1), σ² = 0.2; the
    dense float64 K + σ²I."""
    rng = np.random.default_rng(seed)
    x, y = rng.normal(size=(n, 2)), rng.normal(size=n)
    kernel = Scale.create(RBF.create(2, dtype=torch.float64), dtype=torch.float64)
    with torch.no_grad():
        k = kernel(_t(x)).numpy() + 0.2 * np.eye(n)
    return kernel, _t(x), y, k


@pytest.mark.parametrize("shift,precond", [(1.0, True), (4.0, True), (1.0, False)])
def test_lazy_cg_quad_value_and_diff_grad_match_jax(shift, precond):
    """The value and the gradient in ``diff`` (2·K⁻¹diff from the solve); the
    operator gets no gradient."""
    aug, _, lpc, rng = _problem()
    diff = rng.normal(size=N)
    kw = dict(block=BLOCK, max_iters=ITERS, tol=1e-10, precond_shift=shift)
    jv, jg = jax.jit(jax.value_and_grad(lambda d: jlazy.lazy_cg_quad(
        jnp.asarray(RAW), jnp.asarray(aug), d, jnp.asarray(S2), lpc=jnp.asarray(lpc) if precond else None,
        cross_fn=jcross_of(D), **kw)))(jnp.asarray(diff))
    k_t, a_t, d_t = _t(RAW, True), _t(aug, True), _t(diff, True)
    val = lazy_cg.lazy_cg_quad(k_t, a_t, d_t, S2, lpc=_t(lpc) if precond else None,
                               cross_fn=packed_gibbs_cross(D), **kw)
    val.backward()
    _close(val.detach(), jv)
    _close(d_t.grad, jg)
    assert k_t.grad is None and a_t.grad is None


@pytest.mark.parametrize("precond", [True, False])
def test_lazy_slq_logdet_matches_jax_on_the_same_probes(precond):
    aug, _, lpc, _ = _problem(seed=3)
    key = jax.random.PRNGKey(4)
    kw = dict(block=BLOCK, max_iters=ITERS, tol=1e-10, precond_shift=2.0)
    ref = jlazy.lazy_slq_logdet(jnp.asarray(RAW), jnp.asarray(aug), key, jnp.asarray(S2),
                                lpc=jnp.asarray(lpc) if precond else None, num_probes=PROBES,
                                cross_fn=jcross_of(D), **kw)
    if precond:
        noise = tuple(_t(u) for u in _draws(key, RANK, N, PROBES))
    else:
        noise = _t(jax.random.rademacher(key, (N, PROBES), dtype=jnp.float64))
    got = lazy_cg.lazy_slq_logdet(_t(RAW), _t(aug), noise, S2, lpc=_t(lpc) if precond else None,
                                  cross_fn=packed_gibbs_cross(D), **kw)
    _close(got, ref)


def test_lazy_mll_precond_shift_matches_jax_and_tracks_exact():
    """Shift 4 against the JAX core on the same probes (value and the
    gradients in raw s², the payload and σ²); shifts 10 and 100 at a
    converged budget against the dense float64 MLL (the JAX package's
    test_lazy_mll_precond_shift_tracks_exact band)."""
    aug, y, lpc, rng = _problem(seed=5)
    shift = 4.0
    u1, u2 = rng.normal(size=(RANK, PROBES)), rng.normal(size=(N, PROBES))
    probes = lpc @ u1 + np.sqrt(shift * S2) * u2
    core = jlazy._mll_machinery(BLOCK, PROBES, ITERS, 1e-10, RANK, jcross_of(D), None, None, shift)
    jv, jg = jax.jit(jax.value_and_grad(
        lambda k, a, s: core(k, a, jnp.asarray(y), jnp.asarray(probes), s, jnp.asarray(lpc)),
        argnums=(0, 1, 2)))(jnp.asarray(RAW), jnp.asarray(aug), jnp.asarray(S2))
    k_t, a_t, s_t = _t(RAW, True), _t(aug, True), _t(S2, True)
    val = lazy_cg.lazy_cg_mll(k_t, a_t, _t(y), (_t(u1), _t(u2)), s_t, block=BLOCK, max_iters=ITERS, tol=1e-10,
                              precond_lpc=_t(lpc), precond_shift=shift, cross_fn=packed_gibbs_cross(D))
    val.backward()
    _close(val.detach(), jv)
    for got, ref in zip((k_t.grad, a_t.grad, s_t.grad), jg):
        _close(got, ref)

    kernel, x, y, k = _rbf_setup(240)
    exact = -0.5 * y @ np.linalg.solve(k, y) - 0.5 * np.linalg.slogdet(k)[1] - 0.5 * 240 * np.log(2 * np.pi)
    noise = tuple(_t(u) for u in _draws(jax.random.PRNGKey(21), 8, 240, 16))  # the JAX test's probes
    for shift in (10.0, 100.0):
        with torch.no_grad():
            val = lazy_cg.lazy_cg_mll(kernel, x, _t(y), noise, 0.2, block=80, max_iters=300, tol=1e-12,
                                      precond_rank=8, precond_shift=shift)
        assert abs(float(val) - exact) < 0.02 * abs(exact) + 1.0, (shift, float(val), exact)


def test_lazy_quad_and_logdet_precond_shift_exact():
    """Shift 25 at a converged budget: the quadratic to 1e-6 of the dense
    float64 one (CG's limit does not depend on P) and the SLQ logdet within
    the JAX test's band of log det K̂."""
    kernel, x, y, k = _rbf_setup(160)
    lpc = lazy_cg.lazy_pivoted_cholesky(kernel, x, 12)
    with torch.no_grad():
        q = lazy_cg.lazy_cg_quad(kernel, x, _t(y), 0.2, lpc=lpc, block=80, max_iters=300, tol=1e-12,
                                 precond_shift=25.0)
    q_exact = y @ np.linalg.solve(k, y)
    assert abs(float(q) - q_exact) < 1e-6 * abs(q_exact)
    noise = tuple(_t(u) for u in _draws(jax.random.PRNGKey(4), 12, 160, 32))  # the JAX test's probes
    ld = lazy_cg.lazy_slq_logdet(kernel, x, noise, 0.2, lpc=lpc, block=80, max_iters=300, tol=1e-12,
                                 precond_shift=25.0)
    ld_exact = np.linalg.slogdet(k)[1]
    assert abs(float(ld) - ld_exact) < 0.05 * abs(ld_exact) + 1.0


def test_lazy_cg_posterior_precond_shift_matches_jax():
    aug, y, _, rng = _problem(seed=13)
    xt = np.concatenate([rng.uniform(-2, 2, size=(10, D)), 0.2 * rng.normal(size=(10, D))], axis=1)
    kw = dict(block=BLOCK, max_iters=ITERS, tol=1e-10, precond_rank=RANK, precond_shift=3.0)
    jm, jc = jax.jit(lambda k: jlazy.lazy_cg_posterior(k, jnp.asarray(aug), jnp.asarray(y), jnp.asarray(xt),
                                                       jnp.asarray(S2), cross_fn=jcross_of(D), **kw))(jnp.asarray(RAW))
    m, c = lazy_cg.lazy_cg_posterior(_t(RAW), _t(aug), _t(y), _t(xt), S2, cross_fn=packed_gibbs_cross(D), **kw)
    _close(m, jm)
    _close(c, jc)


def _state_pair(seed=17, shift=2.0, rank=RANK):
    aug, y, _, rng = _problem(seed=seed)
    xt = np.concatenate([rng.uniform(-2, 2, size=(12, D)), 0.2 * rng.normal(size=(12, D))], axis=1)
    kw = dict(block=BLOCK, max_iters=ITERS, tol=1e-10, precond_rank=rank, precond_shift=shift)
    jst = jax.jit(lambda k: jlazy.lazy_posterior_state(k, jnp.asarray(aug), jnp.asarray(y), jnp.asarray(S2),
                                                       cross_fn=jcross_of(D), **kw))(jnp.asarray(RAW))
    st = lazy_cg.lazy_posterior_state(_t(RAW), _t(aug), _t(y), S2, cross_fn=packed_gibbs_cross(D), **kw)
    return jst, st, xt


def test_lazy_posterior_state_and_query_match_jax():
    """α, the factor and α's relres of the state; the query's mean (no
    solve under ``mean_only``) and cov, and its ``return_info``."""
    shift = 2.0
    jst, st, xt = _state_pair(shift=shift)
    _close(st.alpha, jst.alpha)
    _close(st.lpc, jst.lpc)
    _close(st.alpha_relres, jst.alpha_relres)
    kw = dict(block=BLOCK, max_iters=ITERS, tol=1e-10, precond_shift=shift)
    jm, jc, jinfo = jax.jit(lambda s: jlazy.lazy_posterior_query(s, jnp.asarray(xt), cross_fn=jcross_of(D),
                                                                 return_info=True, **kw))(jst)
    m, c, info = lazy_cg.lazy_posterior_query(st, _t(xt), cross_fn=packed_gibbs_cross(D), return_info=True, **kw)
    _close(m, jm)
    _close(c, jc)
    _close(info["relres"], jinfo["relres"])
    _close(info["relres_max"], jinfo["relres_max"])
    assert bool(info["broke"]) is bool(jinfo["broke"]) is False

    jm0, jc0, jinfo0 = jlazy.lazy_posterior_query(jst, jnp.asarray(xt), mean_only=True, cross_fn=jcross_of(D),
                                                  return_info=True, **kw)
    m0, c0, info0 = lazy_cg.lazy_posterior_query(st, _t(xt), mean_only=True, cross_fn=packed_gibbs_cross(D),
                                                 return_info=True, **kw)
    assert jc0 is None and c0 is None and info0["relres"].numel() == 0
    _close(m0, jm0)
    _close(m0, m)  # the mean never depended on the variance solve
    _close(info0["relres_max"], jinfo0["relres_max"])
    m1, c1 = lazy_cg.lazy_posterior_query(st, _t(xt), mean_only=True, cross_fn=packed_gibbs_cross(D), **kw)
    assert c1 is None and torch.equal(m1, m0)


def test_query_breakdown_nans_mean_and_cov_as_jax_regression():
    """F1 (ROADMAP §3): on a variance-solve breakdown (here a negative ridge
    makes pᵀKp ≤ 0 in the unpreconditioned solve) the one-shot query turns
    both mean and cov to NaN, as the JAX package's ``lazy_posterior_query``
    does.  The port follows the reference on purpose (its chunked query NaNs
    only cov).  The mean-only query, which never solves, stays finite."""
    jst, st, xt = _state_pair(seed=19, rank=0)
    jbad, bad = jst._replace(sigma2=jnp.asarray(-5.0)), st._replace(sigma2=torch.tensor(-5.0, dtype=torch.float64))
    kw = dict(block=BLOCK, max_iters=ITERS, tol=1e-10)
    jm, jc, jinfo = jlazy.lazy_posterior_query(jbad, jnp.asarray(xt), cross_fn=jcross_of(D), return_info=True, **kw)
    m, c, info = lazy_cg.lazy_posterior_query(bad, _t(xt), cross_fn=packed_gibbs_cross(D), return_info=True, **kw)
    assert bool(jinfo["broke"]) and bool(info["broke"])
    assert np.isnan(np.asarray(jm)).all() and np.isnan(np.asarray(jc)).all()
    assert bool(torch.isnan(m).all()) and bool(torch.isnan(c).all())
    m0, _ = lazy_cg.lazy_posterior_query(bad, _t(xt), mean_only=True, cross_fn=packed_gibbs_cross(D), **kw)
    assert bool(torch.isfinite(m0).all())
