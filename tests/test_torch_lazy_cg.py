"""``nonstationary_precip_tpu_torch/ops/lazy_cg.py`` against the JAX
package's ``ops/lazy_cg.py``, float64 on the CPU.

Both sides get the same preconditioner factor and the same probes: the JAX
side through ``_mll_machinery``'s core, which takes the probes as an
argument, the port through ``precond_lpc`` and the normal draws behind the
probes.  The value and the gradients in the raw outputscale, the packed
payload [x, log ℓ] and σ² then agree to rtol 1e-8 (relative to each
array's largest entry), for the panel-loop backward and the fused
``panel_vjp`` alike.  CG is not forward stable, so the budget is 8
iterations, where the two implementations' rounding has not grown.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonstationary_precip_tpu.kernels.gibbs import packed_gibbs_cross as jcross_of
from nonstationary_precip_tpu.ops import lazy_cg as jlazy
from nonstationary_precip_tpu_torch.kernels.gibbs import packed_gibbs_cross
from nonstationary_precip_tpu_torch.ops import lazy_cg, matvec

torch.set_num_threads(1)
RTOL = 1e-8
N, D, BLOCK, ITERS, RANK, PROBES = 128, 2, 64, 8, 20, 8


def _problem(seed=11):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, size=(N, D))
    aug = np.concatenate([x, 0.2 * rng.normal(size=(N, D))], axis=1)
    y = np.sin(2 * x[:, 0]) + 0.1 * rng.normal(size=N)
    return aug, y, rng


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=grad)


def _close(a, b, rtol=RTOL):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=rtol * max(np.abs(b).max(), 1e-300))


def test_lazy_pivoted_cholesky_matches_jax():
    """Greedy pivots on random x and log ℓ (no ties): the same factor."""
    aug, _, _ = _problem()
    raw = 0.8
    ref = jlazy.lazy_pivoted_cholesky(jnp.asarray(raw), jnp.asarray(aug), RANK, cross_fn=jcross_of(D))
    got = lazy_cg.lazy_pivoted_cholesky(_t(raw), _t(aug), RANK, cross_fn=packed_gibbs_cross(D))
    _close(got, ref)


@pytest.mark.parametrize("route", ["scan", "fused", "builder+fused", "rademacher"])
def test_lazy_cg_mll_value_and_grads_match_jax(route):
    """Value and gradients in raw_s2, aug and σ².  ``scan`` is the panel
    loop with autograd (``make_jnp_panel_vjp``), ``fused`` the closed-form
    sweep (``packed_gibbs_panel_vjp``, K3's plain version here),
    ``builder+fused`` adds the fused matvec (K2's plain version), as the
    experiment runs; ``rademacher`` runs without a preconditioner."""
    aug, y, rng = _problem()
    raw, s2 = 0.8, 0.3
    jc = jcross_of(D)
    rank = 0 if route == "rademacher" else RANK
    if rank:
        lpc = np.asarray(jlazy.lazy_pivoted_cholesky(jnp.asarray(raw), jnp.asarray(aug), rank, cross_fn=jc))
        u1, u2 = rng.normal(size=(rank, PROBES)), rng.normal(size=(N, PROBES))
        probes = lpc @ u1 + np.sqrt(s2) * u2
        noise = (_t(u1), _t(u2))
    else:
        lpc = np.zeros((N, 0))
        probes = rng.choice([-1.0, 1.0], size=(N, PROBES))
        noise = _t(probes)
    core = jlazy._mll_machinery(BLOCK, PROBES, ITERS, 1e-10, rank, jc, None, None, 1.0)
    jv, jg = jax.value_and_grad(
        lambda k, a, s: core(k, a, jnp.asarray(y), jnp.asarray(probes), s, jnp.asarray(lpc)),
        argnums=(0, 1, 2))(jnp.asarray(raw), jnp.asarray(aug), jnp.asarray(s2))

    k_t, a_t, s_t = _t(raw, True), _t(aug, True), _t(s2, True)
    val = lazy_cg.lazy_cg_mll(
        k_t, a_t, _t(y), noise, s_t, block=BLOCK, max_iters=ITERS, tol=1e-10,
        precond_lpc=_t(lpc) if rank else None, cross_fn=packed_gibbs_cross(D),
        matvec_builder=matvec.scaled_packed_gibbs_matvec_builder(D) if route == "builder+fused" else None,
        panel_vjp=matvec.packed_gibbs_panel_vjp(D) if "fused" in route else None)
    val.backward()
    _close(val.detach(), jv)
    for got, ref in zip((k_t.grad, a_t.grad, s_t.grad), jg):
        _close(got, ref)


def test_lazy_cg_mll_resid_grad_is_minus_alpha():
    """The cotangent of the residual is −g·α, with the solve's α."""
    aug, y, rng = _problem(seed=5)
    probes = _t(rng.choice([-1.0, 1.0], size=(N, PROBES)))
    r_t = _t(y, True)
    val = lazy_cg.lazy_cg_mll(None, _t(aug), r_t, probes, 0.3, block=BLOCK, max_iters=64, tol=1e-12,
                              cross_fn=packed_gibbs_cross(D))
    val.backward()
    x, le = aug[:, :D], np.exp(aug[:, D:])
    sq = le[:, None] ** 2 + le[None] ** 2
    k = np.prod(np.sqrt(2 * le[:, None] * le[None] / sq), -1) * np.exp(-(((x[:, None] - x[None]) ** 2) / sq).sum(-1))
    _close(r_t.grad, -np.linalg.solve(k + 0.3 * np.eye(N), y), rtol=1e-6)


def test_lazy_cg_diagnostics_matches_jax():
    """Trained-pose evidence: JAX builds its factor and its probes from a
    key; the port gets the draws that key yields and builds the same."""
    aug, y, _ = _problem(seed=3)
    key = jax.random.PRNGKey(173)
    k1, k2 = jax.random.split(key)
    u1 = jax.random.normal(k1, (RANK, PROBES), jnp.float64)
    u2 = jax.random.normal(k2, (N, PROBES), jnp.float64)
    kw = dict(block=BLOCK, max_iters=ITERS, tol=1e-6, precond_rank=RANK)
    ref = jlazy.lazy_cg_diagnostics(jnp.asarray(0.5), jnp.asarray(aug), jnp.asarray(y), key, jnp.asarray(0.1),
                                    num_probes=PROBES, cross_fn=jcross_of(D), **kw)
    got = lazy_cg.lazy_cg_diagnostics(_t(0.5), _t(aug), _t(y), (_t(u1), _t(u2)), _t(0.1),
                                      cross_fn=packed_gibbs_cross(D), **kw)
    assert got["iters_max"] == ref["iters_max"] and got["broke"] == ref["broke"]
    for name in ("relres_solve", "relres_max"):
        _close(got[name], ref[name])


def test_unported_options_raise():
    """The Nyström factor and RPCholesky's keyed pivots, which raised until
    they were ported (tests/test_torch_precond.py holds them to JAX), build
    finite (N, rank) factors whose LLᵀ stays below K's diagonal; an
    unknown rule, malformed draws and an N the panels do not divide raise."""
    aug, _, _ = _problem()
    for rule, key in (("nystrom", None), ("pivchol", torch.Generator().manual_seed(1))):
        lpc = lazy_cg.build_precond_factor(rule, None, _t(aug), 4, packed_gibbs_cross(D), key)
        assert lpc.shape == (N, 4) and bool(torch.isfinite(lpc).all())
        assert float((lpc * lpc).sum(1).max()) <= 1.0 + 1e-10
    with pytest.raises(ValueError, match="'pivchol' or 'nystrom'"):
        lazy_cg.build_precond_factor("svd", None, _t(aug), 4, packed_gibbs_cross(D))
    with pytest.raises(ValueError, match="RPCholesky draws"):
        lazy_cg.lazy_pivoted_cholesky(None, _t(aug), 4, packed_gibbs_cross(D), key=_t(np.zeros((4, 3))))
    with pytest.raises(ValueError, match="divisible"):
        lazy_cg.lazy_cg_mll(None, _t(aug[:100]), _t(np.zeros(100)), _t(np.ones((100, 2))), 0.1, block=64,
                            cross_fn=packed_gibbs_cross(D))
