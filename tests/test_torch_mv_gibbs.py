"""The port's multivariate Gibbs kernel, its models and the latent priors
against the JAX package on the CPU.

Inputs are drawn with numpy and fed to both sides; the JAX side runs in
float64 (conftest turns x64 on) and jitted, loss, gradients and predictive
in one call.  Tolerances: rtol 1e-12 for Σ's components (a few elementwise
operations), 1e-10 for the closed-form Gram, the priors and the losses,
1e-8 for the gradients and the predictive (a Cholesky factor and its
pullback between them).  In float32, one input takes each clamp of the
Gram (det Σ at its floor, det M at Minkowski's bound, the jittered det at
its bound) at |h| ≈ 37, where the port must be finite wherever JAX is and
both must stay inside the bounds the clamps guarantee (0 ≤ k ≤ 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonstationary_precip_tpu.kernels import multivariate_gibbs as jax_mvk
from nonstationary_precip_tpu.models.multivariate_gibbs_gp import MultivariateGibbsGP as JaxMV
from nonstationary_precip_tpu.models.multivariate_gibbs_gp import SparseMultivariateGibbsGP as JaxSparseMV
from nonstationary_precip_tpu.priors.latent_gp import LatentGpPrior as JaxLatentGp
from nonstationary_precip_tpu.priors.matrix_normal import MatrixNormalPrior as JaxMN
from nonstationary_precip_tpu.priors.matrix_normal import latent_rbf_row_cov as jax_row_cov

from nonstationary_precip_tpu_torch import interop
from nonstationary_precip_tpu_torch.kernels import multivariate_gibbs as mvk
from nonstationary_precip_tpu_torch.priors.latent_gp import LatentGpPrior
from nonstationary_precip_tpu_torch.priors.matrix_normal import MatrixNormalPrior, latent_rbf_row_cov

torch.set_num_threads(1)
F64 = torch.float64
CPU = torch.device("cpu")
MV_PRIOR = ("loc", "row_cov", "col_cov")


def jax_leaves(tree) -> dict:
    """A JAX model's leaves by the port's parameter name (the matrix-normal
    prior's flattened children by name), as tools/pin_jax_serve.py names
    them."""
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [MV_PRIOR[k.key] if isinstance(k, jax.tree_util.FlattenedIndexKey) else k.name for k in path]
        out[".".join(parts)] = np.asarray(v)
    return out


def t64(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def close(got, want, rtol, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def data(seed, n=40, n_new=13):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.5, 1.5, (n, 2)), rng.normal(size=n), rng.uniform(-1.5, 1.5, (n_new, 2)), rng)


def models(sparse: bool, detach_h: bool, seed=5):
    """A JAX model in float64, its D moved to a full 2×2 and its noise off
    its init, and the port's model carried from its leaves."""
    x, y, xs, rng = data(seed)
    key = jax.random.PRNGKey(seed)
    if sparse:
        z = rng.uniform(-1.5, 1.5, (17, 2))
        jm = JaxSparseMV.create(key, jnp.asarray(z), noise=0.05, detach_h=detach_h, dtype=jnp.float64)
    else:
        jm = JaxMV.create(key, jnp.asarray(x), noise=0.05, detach_h=detach_h, dtype=jnp.float64)
    # D off its diagonal init, kept dominant on it so that every Σ is PD
    jm = jm.replace(d_mat=jnp.asarray(np.diag([1.3, 0.9]) + 0.25 * rng.normal(size=(2, 2))))
    jm = jm.replace(likelihood=jm.likelihood.replace(raw_noise=jnp.asarray(-2.3)))
    make = interop.mv_gibbs_sparse_from_jax if sparse else interop.mv_gibbs_from_jax
    return jm, make(jax_leaves(jm), CPU, F64, detach_h=detach_h), x, y, xs


@jax.jit
def _jax_all(jm, x, y, xs):
    loss, g = jax.value_and_grad(lambda m: m.loss(x, y))(jm)
    mask = jm.trainable()
    g = jax.tree_util.tree_map(lambda gr, tr: jnp.where(tr, gr, 0.0), g, mask)
    pred = jm.predictive(x, y, xs)
    return loss, g, jm._h_at(xs), pred.mean, pred.cov


@pytest.mark.parametrize("sparse", [False, True], ids=["exact", "sparse"])
@pytest.mark.parametrize("detach_h", [False, True], ids=["h_live", "h_detached"])
def test_mv_model_loss_grads_h_at_and_predictive_match_jax(sparse, detach_h):
    """Both models' loss, every trainable leaf's gradient (frozen leaves get
    none, as JAX's mask zeroes them), ``_h_at`` and the predictive, with H
    live in the Gram and detached (the reference's mode)."""
    jm, tm, x, y, xs = models(sparse, detach_h)
    loss, g, h_at, pmean, pcov = _jax_all(jm, jnp.asarray(x), jnp.asarray(y), jnp.asarray(xs))
    tx, ty, txs = t64(x), t64(y), t64(xs)
    tl = tm.loss(tx, ty)
    tl.backward()
    close(tl, loss, 1e-10)
    gl = jax_leaves(g)
    for name, p in tm.named_parameters():
        if p.requires_grad:  # a leaf the loss does not reach (z with H detached) has no grad: JAX's is 0
            grad = torch.zeros_like(p) if p.grad is None else p.grad
            close(grad, gl[name], 1e-8, atol=1e-12 * np.abs(gl[name]).max())
        else:
            assert p.grad is None and not np.any(gl[name]), name
    with torch.no_grad():
        close(tm._h_at(txs), h_at, 1e-10)
        pred = tm.predictive(tx, ty, txs)
    close(pred.mean, pmean, 1e-8)
    close(pred.cov, pcov, 1e-8, atol=1e-12)


@jax.jit
def _jax_gram(x1, h1, x2, h2, d):
    k = jax_mvk.MultivariateGibbsKernel(active_dims=(0, 2))
    return jax_mvk.sigma_components_2d(h1, d), k(x1, h1, d, x2, h2), k(x1, h1, d)


def test_sigma_components_and_gram_match_jax():
    """Σ's components (rtol 1e-12) and the cross and symmetric Grams (rtol
    1e-10) on random H, D and inputs, the kernel wrapper's active dims and
    its constant diagonal."""
    rng = np.random.default_rng(11)
    h1, h2 = rng.normal(size=(23, 2)), rng.normal(size=(31, 2))
    d = np.diag([1.5, 1.2]) + 0.2 * rng.normal(size=(2, 2))  # Σ well conditioned: k in (0, 1]
    x1, x2 = rng.uniform(-1, 1, (23, 3)), rng.uniform(-1, 1, (31, 3))
    s1, cross, sym = _jax_gram(*(jnp.asarray(a) for a in (x1, h1, x2, h2, d)))
    for a, b in zip(mvk.sigma_components_2d(t64(h1), t64(d)), s1):
        close(a, b, 1e-12)
    tk = mvk.MultivariateGibbsKernel(active_dims=(0, 2))
    assert 1e-3 < float(np.min(cross)) and np.all(np.isfinite(cross))
    close(tk(t64(x1), t64(h1), t64(d), t64(x2), t64(h2)), cross, 1e-10)
    close(tk(t64(x1), t64(h1), t64(d)), sym, 1e-10)
    close(tk.diag(t64(x1), t64(h1), t64(d)), np.ones(23), 0.0)


@jax.jit
def _jax_priors(x, loc, col, h, k_xz, loc_new, v):
    row = jax_row_cov(x, (0.4, 0.3), 1.7)
    mn = JaxMN(loc, row, col)
    lgp = JaxLatentGp.create(x, 1.3, (0.5, 0.7))
    return (row, mn.log_prob(h), mn.conditional_mean(k_xz, h), mn.conditional_mean(k_xz, h, loc_new), lgp.cov,
            lgp.log_prob(v))


def test_matrix_normal_and_latent_gp_priors_match_jax():
    """``MatrixNormalPrior.log_prob`` and ``conditional_mean`` (with and
    without a nonzero loc and a query loc) and ``LatentGpPrior.log_prob``,
    rtol 1e-10; a sample from a given draw is loc + L_U Z L_Vᵀ."""
    rng = np.random.default_rng(3)
    x, xs = rng.uniform(-1, 1, (30, 2)), rng.uniform(-1, 1, (9, 2))
    loc, h, loc_new, v = rng.normal(size=(30, 2)), rng.normal(size=(30, 2)), rng.normal(size=(9, 2)), \
        rng.normal(size=30)
    col = np.array([[2.0, 0.3], [0.3, 1.1]])
    k_xz = np.exp(-0.5 * ((xs[:, None, :] - x[None]) ** 2 / np.array([0.4, 0.3]) ** 2).sum(-1))
    row, logp, cm, cm_loc, lcov, llogp = _jax_priors(*(jnp.asarray(a) for a in (x, loc, col, h, k_xz, loc_new, v)))
    close(latent_rbf_row_cov(t64(x), (0.4, 0.3), 1.7), row, 1e-12)
    tp = MatrixNormalPrior(t64(loc), t64(row), t64(col))
    close(tp.log_prob(t64(h)), logp, 1e-10)
    close(tp.conditional_mean(t64(k_xz), t64(h)), cm, 1e-10)
    close(tp.conditional_mean(t64(k_xz), t64(h), t64(loc_new)), cm_loc, 1e-10)
    z = rng.normal(size=(30, 2))
    lu = np.linalg.cholesky(np.asarray(row) + 1e-5 * np.eye(30))
    close(tp.sample(t64(z)), loc + lu @ z @ np.linalg.cholesky(col).T, 1e-9)
    assert tuple(tp.sample(torch.Generator().manual_seed(0)).shape) == (30, 2)
    assert not any(p.requires_grad for p in tp.parameters())

    tl = LatentGpPrior.create(t64(x), 1.3, (0.5, 0.7))
    close(tl.cov, lcov, 1e-12)
    close(tl.log_prob(t64(v)), llogp, 1e-10)
    eps = rng.normal(size=30)
    close(tl.sample(t64(eps)), np.linalg.cholesky(np.asarray(lcov)) @ eps, 1e-9)


def _raw_dets(h1, d, h2, jitter=1e-5):
    """The three quantities each clamp bounds, in float32 as the Gram
    computes them: det Σ₁ (per row), det M and the jittered det M."""
    a1, b1, c1 = (t.numpy() for t in mvk.sigma_components_2d(torch.tensor(h1), torch.tensor(d)))
    a2, b2, c2 = (t.numpy() for t in mvk.sigma_components_2d(torch.tensor(h2), torch.tensor(d)))
    det1 = a1 * c1 - b1 * b1
    am, bm, cm = (0.5 * (p[:, None] + q[None, :]) for p, q in ((a1, a2), (b1, b2), (c1, c2)))
    return det1, am * cm - bm * bm, (am + jitter) * (cm + jitter) - bm * bm, am, cm


@jax.jit
def _jax_gram32(x1, h1, x2, h2, d):
    s1, s2 = jax_mvk.sigma_components_2d(h1, d), jax_mvk.sigma_components_2d(h2, d)
    return jax_mvk.paciorek_schervish_gram_2d(x1, s1, x2, s2)


def test_float32_clamps_at_large_h_finite_where_jax_is():
    """At |h| ≈ 37 (the measured UIB regime) float32 det Σ cancels to ≤ 0
    and det M below Minkowski's bound; on this input every clamp branch is
    taken somewhere, JAX's float32 Gram is finite, and the port's is finite
    at every entry JAX's is, both inside [0, 1]."""
    rng = np.random.default_rng(37)
    h1 = (37.0 + rng.uniform(-0.5, 0.5, (64, 2))) * rng.choice([-1.0, 1.0], (64, 2))
    h2 = (37.0 + rng.uniform(-0.5, 0.5, (48, 2))) * rng.choice([-1.0, 1.0], (48, 2))
    h1, h2 = h1.astype(np.float32), h2.astype(np.float32)
    d = np.diag(rng.uniform(0.01, 0.1, 2)).astype(np.float32)
    x1, x2 = rng.uniform(-1, 1, (64, 2)).astype(np.float32), rng.uniform(-1, 1, (48, 2)).astype(np.float32)
    det1, det_m, det_m_j, am, cm = _raw_dets(h1, d, h2)
    det2 = _raw_dets(h2, d, h2)[0]
    det1c, det2c = np.maximum(det1, 1e-8), np.maximum(det2, 1e-8)
    mink = np.sqrt(det1c[:, None] * det2c[None, :])
    assert (det1 <= 1e-8).any(), "det Σ's floor is taken"
    assert (det_m < mink).any(), "Minkowski's bound on det M is taken"
    assert (det_m_j < np.maximum(det_m, mink) + 1e-5 * (am + cm)).any(), "the jittered det's bound is taken"

    want = np.asarray(_jax_gram32(*(jnp.asarray(a) for a in (x1, h1, x2, h2, d))))
    assert want.dtype == np.float32 and np.isfinite(want).all()
    t1, t2 = (mvk.sigma_components_2d(torch.tensor(h), torch.tensor(d)) for h in (h1, h2))
    got = mvk.paciorek_schervish_gram_2d(torch.tensor(x1), t1, torch.tensor(x2), t2).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(np.isfinite(got), np.isfinite(want)) and np.isfinite(got).all()
    # a clamped entry is float32 rounding of a cancellation (XLA may also
    # contract ac − b² into an FMA), so the two agree only in the bounds the
    # clamps guarantee: the prefactor ≤ 1 (Minkowski) and a non-negative
    # quadratic form, so 0 ≤ k ≤ 1 in both
    for gram in (got, want):
        assert gram.min() >= 0.0 and gram.max() <= 1.0
    # the symmetric Gram's diagonal stays exactly 1 where the quotient would be 0/0
    sym = mvk.paciorek_schervish_gram_2d(torch.tensor(x1), t1, torch.tensor(x1), t1).numpy()
    assert np.isfinite(sym).all()


def test_create_draws_from_the_callers_generator():
    """``create`` draws H₀ from the prior and D₀ = diag(ε) from the caller's
    generator: the same seed gives the same model, the frozen leaves do not
    train, and the exact model's default trainability is JAX's mask."""
    from nonstationary_precip_tpu_torch.models.multivariate_gibbs_gp import (
        MultivariateGibbsGP,
        SparseMultivariateGibbsGP,
    )

    x = torch.tensor(np.random.default_rng(0).uniform(-1, 1, (25, 2)), dtype=torch.float32)
    a = MultivariateGibbsGP.create(torch.Generator().manual_seed(4), x, noise=0.011)
    b = MultivariateGibbsGP.create(torch.Generator().manual_seed(4), x, noise=0.011)
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert torch.count_nonzero(a.d_mat - torch.diag(torch.diagonal(a.d_mat))) == 0
    trains = {n for n, p in a.named_parameters() if p.requires_grad}
    assert trains == {"likelihood.raw_noise", "h", "d_mat"}
    s = SparseMultivariateGibbsGP.create(torch.Generator().manual_seed(4), x[:9], noise=0.011)
    assert {n for n, p in s.named_parameters() if p.requires_grad} == {"likelihood.raw_noise", "z", "h_z", "d_mat"}
    assert abs(float(a.likelihood.noise.detach()) - 0.011) < 1e-6
