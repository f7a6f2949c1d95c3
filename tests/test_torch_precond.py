"""The port's preconditioner factors against the JAX package, float64 on
the CPU: the Nyström factor (``ops/lazy_cg.lazy_nystrom_factor``) with the
stride and the keyed landmarks, RPCholesky's sampled pivots
(``lazy_pivoted_cholesky`` with a key), the dead-rank guard, and the keyed
factor reaching the diagnostics.

Randomness comes from the caller: RPCholesky's key is the (rank, N) Gumbel
draws JAX's ``categorical(fold_in(key, j), log d)`` makes
(``gumbel(fold_in(key, j), (N,))``), the keyed landmarks JAX's
``permutation(key, n)[:rank]``.  Both factors within 1e-10 of each array's
largest entry: the same arithmetic on the same pivots and landmarks.  The
landmark Gram's eigenvectors are defined up to sign, which each LAPACK picks
its own way; the port fixes it (``lazy_cg.canonical_eigh``), and JAX's
``eigh`` gets the same rule here (``jax_eigh_canonical``), so that both
factors meet the probe draws with the same columns.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonstationary_precip_tpu.kernels.gibbs import packed_gibbs_cross as jcross
from nonstationary_precip_tpu.ops import lazy_cg as jlazy
from nonstationary_precip_tpu.priors.lognormal_process import _dim_cross as jdim
from nonstationary_precip_tpu_torch.kernels.gibbs import packed_gibbs_cross
from nonstationary_precip_tpu_torch.ops import lazy_cg
from nonstationary_precip_tpu_torch.priors.lognormal_process import _dim_cross

torch.set_num_threads(1)
F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _close(a, b, rtol=1e-10):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=rtol * max(np.abs(b).max(), 1e-300))


def _aug(n=256, seed=7):
    """A Gibbs payload [x, log ℓ] at a rough pose."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-2, 2, size=(n, 2)), np.log(0.4) + 0.3 * rng.normal(size=(n, 2))], axis=1)


def _gumbel(pk, rank, n):
    return np.stack([np.asarray(jax.random.gumbel(jax.random.fold_in(pk, j), (n,), jnp.float64)) for j in range(rank)])


@pytest.fixture
def jax_eigh_canonical(monkeypatch):
    """JAX's ``jnp.linalg.eigh`` with the port's sign rule, for the calls
    the JAX Nyström factor makes."""
    plain = jnp.linalg.eigh

    def eigh(w, *a, **k):
        lam, v = plain(w, *a, **k)
        lead = jnp.take_along_axis(v, jnp.argmax(jnp.abs(v), axis=0)[None], axis=0)
        return lam, v * jnp.where(lead < 0, -1.0, 1.0).astype(v.dtype)

    monkeypatch.setattr(jnp.linalg, "eigh", eigh)


def _pivots(l):
    """The pivot of each column but the last, read off the factor: pivot
    row p_j has L[p_j, j] = √d_max and zeros after column j (d[p_j] = 0 from
    then on); every other row of column j keeps entries past it."""
    l = np.asarray(l)
    last = np.array([np.flatnonzero(row)[-1] if row.any() else -1 for row in l])
    return [int(np.flatnonzero(last == j)[0]) for j in range(l.shape[1] - 1)]


@pytest.mark.parametrize("keyed", [False, True], ids=["stride", "keyed"])
def test_nystrom_factor_matches_jax(keyed, jax_eigh_canonical):
    """L (within 1e-10) and the zeroed directions (the same zero columns)
    with JAX's stride landmarks and with its keyed ones passed in."""
    aug = _aug()
    pk = jax.random.PRNGKey(3)
    rank = 48
    key = np.array(jax.random.permutation(pk, aug.shape[0])[:rank]) if keyed else None
    l = lazy_cg.lazy_nystrom_factor(None, _t(aug), rank, packed_gibbs_cross(2), key=key, block=100)
    jl = jlazy.lazy_nystrom_factor(None, jnp.asarray(aug), rank, jcross(2), key=pk if keyed else None)
    _close(l, jl)
    zeros, jzeros = (np.flatnonzero(np.abs(np.asarray(a)).max(0) == 0) for a in (l, jl))
    np.testing.assert_array_equal(zeros, jzeros)
    _close(l @ l.T, np.asarray(jl) @ np.asarray(jl).T)


def test_nystrom_cutoff_zeroes_the_directions_jax_does(jax_eigh_canonical):
    """A dense landmark set of a smooth kernel: most of the landmark Gram's
    spectrum sits below ridge·λmax, and exactly those directions are zero
    columns on both sides."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, size=(300, 2))
    params = (_t([1.5, 1.5]), _t(1.0))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        l = lazy_cg.lazy_nystrom_factor(params, _t(x), 64, _dim_cross)
        jl = jlazy.lazy_nystrom_factor((jnp.asarray([1.5, 1.5]), jnp.asarray(1.0)), jnp.asarray(x), 64, jdim)
    kept = np.abs(np.asarray(l)).max(0) > 0
    assert 0 < kept.sum() < 64
    np.testing.assert_array_equal(kept, np.abs(np.asarray(jl)).max(0) > 0)
    _close(l, jl)


def test_rpcholesky_pivots_and_factor_match_jax():
    """Given JAX's Gumbel draws the sampled pivots are JAX's, one for one,
    and the factor agrees within 1e-10; a ``torch.Generator`` key draws its
    own (reproducibly), and the greedy factor differs from the sampled."""
    aug = _aug(n=200)
    rank, pk = 24, jax.random.PRNGKey(99)
    l = lazy_cg.lazy_pivoted_cholesky(None, _t(aug), rank, packed_gibbs_cross(2), key=_t(_gumbel(pk, rank, 200)))
    jl = jlazy.lazy_pivoted_cholesky(None, jnp.asarray(aug), rank, jcross(2), key=pk)
    assert _pivots(l) == _pivots(jl)
    _close(l, jl)
    greedy = lazy_cg.lazy_pivoted_cholesky(None, _t(aug), rank, packed_gibbs_cross(2))
    assert _pivots(greedy) != _pivots(l)
    g1, g2 = (lazy_cg.lazy_pivoted_cholesky(None, _t(aug), rank, packed_gibbs_cross(2),
                                            key=torch.Generator().manual_seed(5)) for _ in range(2))
    assert torch.equal(g1, g2)
    with pytest.raises(ValueError, match="RPCholesky draws"):
        lazy_cg.lazy_pivoted_cholesky(None, _t(aug), rank, packed_gibbs_cross(2), key=_t(np.zeros((rank, 3))))


def test_landmarks_and_factor_dispatch():
    """The stride rule, a generator's permutation, the eigenvectors' sign
    rule, the dispatcher's two rules and its refusal of a third."""
    torch.testing.assert_close(lazy_cg.nystrom_landmarks(10, 4), torch.tensor([0, 2, 4, 6]))
    perm = lazy_cg.nystrom_landmarks(50, 8, torch.Generator().manual_seed(1))
    assert perm.shape == (8,) and len(set(perm.tolist())) == 8
    w = _t(np.random.default_rng(2).normal(size=(6, 6)))
    lam, v = lazy_cg.canonical_eigh(w + w.T)
    torch.testing.assert_close(v @ torch.diag(lam) @ v.T, w + w.T)
    assert bool((v.gather(0, v.abs().argmax(0, keepdim=True)) > 0).all())
    aug = _t(_aug(n=64))
    for rule, fn in (("pivchol", lazy_cg.lazy_pivoted_cholesky), ("nystrom", lazy_cg.lazy_nystrom_factor)):
        assert torch.equal(lazy_cg.build_precond_factor(rule, None, aug, 8, packed_gibbs_cross(2)),
                           fn(None, aug, 8, packed_gibbs_cross(2)))
    with pytest.raises(ValueError, match="'pivchol' or 'nystrom'"):
        lazy_cg.build_precond_factor("svd", None, aug, 8, packed_gibbs_cross(2))


def test_nystrom_dead_rank_guard_warns_eagerly():
    """Fewer than rank/8 directions above the cutoff warns, with a rank to
    prefer, as JAX's eager build does (``tests/test_chunked_api.py:461``);
    a healthy rank does not."""
    rng = np.random.default_rng(0)
    x = _t(rng.uniform(-1, 1, size=(512, 2)))
    params = (_t([1.5, 1.5]), _t(1.0))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        lazy_cg.lazy_nystrom_factor(params, x, 256, _dim_cross)
    assert any("eigendirections" in str(m.message) and "Prefer rank" in str(m.message) for m in w)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        lazy_cg.lazy_nystrom_factor((_t([0.1, 0.1]), _t(1.0)), x, 32, _dim_cross)
    assert not any("eigendirections" in str(m.message) for m in w)


def test_keyed_diagnostics_certify_the_keyed_factor(jax_eigh_canonical):
    """lazy_cg_diagnostics with a landmark key builds the keyed Nyström
    factor that lazy_cg_mll solves with: a starved budget against a manual
    mbcg run with that factor, and against JAX's keyed diagnostics."""
    from nonstationary_precip_tpu_torch.ops.bbmm import mbcg, sample_precond_probes, woodbury_precond

    n = 256
    aug = _aug(n, seed=9)
    y = np.sin(2 * aug[:, 0]) + 0.1 * np.random.default_rng(9).normal(size=n)
    key, pk = jax.random.PRNGKey(7), jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    u1, u2 = (_t(jax.random.normal(k, shape, jnp.float64)) for k, shape in ((k1, (32, 4)), (k2, (n, 4))))
    lm = np.array(jax.random.permutation(pk, n)[:32])
    kw = dict(block=64, max_iters=6, tol=1e-12, precond_rank=32, precond="nystrom", cross_fn=packed_gibbs_cross(2))
    diag = lazy_cg.lazy_cg_diagnostics(None, _t(aug), _t(y), (u1, u2), 0.01, precond_key=lm, **kw)
    lpc = lazy_cg.build_precond_factor("nystrom", None, _t(aug), 32, packed_gibbs_cross(2), lm)
    probes = sample_precond_probes(lpc, _t(0.01), u1, u2)
    res = mbcg(lazy_cg._lazy_matvec(None, _t(aug), _t(0.01), 64, packed_gibbs_cross(2)),
               torch.cat([_t(y)[:, None], probes], dim=1), max_iters=6, tol=1e-12,
               precond=woodbury_precond(lpc, _t(0.01)))
    assert diag["relres_solve"] == float(res.residnorm[0]) and diag["relres_max"] == float(res.residnorm.max())
    jd = jlazy.lazy_cg_diagnostics(None, jnp.asarray(aug), jnp.asarray(y), key, jnp.asarray(0.01), num_probes=4,
                                   precond_key=pk, **{**kw, "cross_fn": jcross(2)})
    np.testing.assert_allclose(diag["relres_solve"], jd["relres_solve"], rtol=1e-8)
    np.testing.assert_allclose(diag["relres_max"], jd["relres_max"], rtol=1e-8)
