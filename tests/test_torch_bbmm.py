"""``nonstationary_precip_tpu_torch/ops/bbmm.py`` against the JAX package's
``ops/bbmm.py`` in float64 on the CPU, on the same inputs and draws.

Both sides run the same recurrences on the same numbers; they differ only
in the order of a few sums (BLAS against XLA), so every output agrees to
1e-10 relative to its largest entry.  CG is not forward stable, so the
iteration budgets stay where that rounding has not yet grown (see
``test_mbcg_matches_jax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonstationary_precip_tpu.ops import bbmm as jbbmm
from nonstationary_precip_tpu_torch.ops import bbmm

torch.set_num_threads(1)
RTOL = 1e-10


def _spd(n=96, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, size=(n, 2))
    d2 = ((x[:, None] - x[None]) ** 2).sum(-1)
    return np.exp(-0.5 * d2 / 0.7**2), rng


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _close(a, b, rtol=RTOL):
    """|a − b| ≤ rtol·max|b|: relative to the array's largest entry."""
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=rtol * max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("precond", [False, True])
def test_mbcg_matches_jax(precond):
    """x, α, β, iterations, breakdown flags and residual norms over 8
    masked iterations, with a tolerance some columns reach and some do not.
    CG is not forward stable: past ~10 iterations on this Gram (cond ~300)
    the two implementations' rounding grows to ~1e-6 relative, so the
    budget stays where both are still exact to rounding."""
    kf, rng = _spd()
    k = kf + 0.05 * np.eye(kf.shape[0])
    # three generic columns, one in a 2-dim eigenspace (converges at step 2,
    # so its mask freezes it) and a zero column (done from the start)
    evecs = np.linalg.eigh(k)[1]
    b = np.column_stack([rng.normal(size=(k.shape[0], 3)), evecs[:, -1] + evecs[:, -2],
                         np.zeros(k.shape[0])])
    if precond:
        lpc, _ = jbbmm.pivoted_cholesky(jnp.asarray(kf), 12)
        jp, tp = jbbmm.woodbury_precond(lpc, 0.05), bbmm.woodbury_precond(_t(lpc), 0.05)
    else:
        jp = tp = None
    km, kt = jnp.asarray(k), _t(k)
    ref = jbbmm.mbcg(lambda v: km @ v, jnp.asarray(b), max_iters=8, tol=1e-8, precond=jp)
    got = bbmm.mbcg(lambda v: kt @ v, _t(b), max_iters=8, tol=1e-8, precond=tp)
    for name in ("x", "alphas", "betas", "residnorm", "resnorm_hist"):
        _close(getattr(got, name), getattr(ref, name))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(got.broke.numpy(), np.asarray(ref.broke))
    assert int(got.iters.min()) < 8 and int(got.iters.max()) == 8


def test_mbcg_flags_breakdown_like_jax():
    """An indefinite operator: the breakdown flags match."""
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.normal(size=(40, 40)))
    k = q @ np.diag(np.linspace(-1.0, 2.0, 40)) @ q.T
    b = rng.normal(size=(40, 3))
    km, kt = jnp.asarray(k), _t(k)
    ref = jbbmm.mbcg(lambda v: km @ v, jnp.asarray(b), max_iters=30, tol=1e-10)
    got = bbmm.mbcg(lambda v: kt @ v, _t(b), max_iters=30, tol=1e-10)
    np.testing.assert_array_equal(got.broke.numpy(), np.asarray(ref.broke))
    assert bool(got.broke.any())


def test_lanczos_logdet_matches_jax_and_exact():
    """SLQ from mBCG coefficients: the same estimate as JAX, and with probes
    that span the space, close to the exact log det."""
    kf, rng = _spd(n=64, seed=1)
    k = kf + 0.1 * np.eye(64)
    z = rng.choice([-1.0, 1.0], size=(64, 16))
    km, kt = jnp.asarray(k), _t(k)
    ref = jbbmm.mbcg(lambda v: km @ v, jnp.asarray(z), max_iters=12, tol=1e-12)
    got = bbmm.mbcg(lambda v: kt @ v, _t(z), max_iters=12, tol=1e-12)
    w = np.full(16, 64.0)
    lj = float(jbbmm.lanczos_logdet(ref.alphas, ref.betas, jnp.asarray(w)))
    lt = float(bbmm.lanczos_logdet(got.alphas, got.betas, _t(w)))
    _close(lt, lj)
    _close(bbmm.lanczos_tridiag(got.alphas, got.betas), jbbmm.lanczos_tridiag(ref.alphas, ref.betas))
    assert abs(lt - np.linalg.slogdet(k)[1]) < 0.1 * abs(np.linalg.slogdet(k)[1])


def test_lanczos_logdet_converged_columns_pad_like_jax():
    """Iterations past a column's convergence carry α = 0 and collapse to an
    identity pad with no weight: the estimate equals the one from the
    unpadded coefficients, on both sides."""
    kf, rng = _spd(n=48, seed=6)
    k = kf + 0.2 * np.eye(48)
    z = rng.choice([-1.0, 1.0], size=(48, 4))
    got = bbmm.mbcg(lambda v: _t(k) @ v, _t(z), max_iters=6, tol=1e-12)
    pad = torch.zeros((3, 4), dtype=torch.float64)
    alphas, betas = torch.cat([got.alphas, pad]), torch.cat([got.betas, pad])
    w = np.full(4, 48.0)
    padded = float(bbmm.lanczos_logdet(alphas, betas, _t(w)))
    _close(padded, float(bbmm.lanczos_logdet(got.alphas, got.betas, _t(w))))
    _close(padded, float(jbbmm.lanczos_logdet(jnp.asarray(alphas.numpy()), jnp.asarray(betas.numpy()),
                                              jnp.asarray(w))))


def test_pivoted_cholesky_matches_jax():
    kf, _ = _spd(n=80, seed=2)
    lj, hj = jbbmm.pivoted_cholesky(jnp.asarray(kf), 20)
    lt, ht = bbmm.pivoted_cholesky(_t(kf), 20)
    _close(lt, lj)
    _close(ht, hj)


def test_woodbury_and_precond_logdet_match_jax():
    kf, rng = _spd(n=80, seed=4)
    lj, _ = jbbmm.pivoted_cholesky(jnp.asarray(kf), 16)
    v = rng.normal(size=(80, 3))
    _close(bbmm.woodbury_precond(_t(lj), 0.3)(_t(v)), jbbmm.woodbury_precond(lj, 0.3)(jnp.asarray(v)))
    _close(bbmm.precond_logdet(_t(lj), 0.3, 80), jbbmm.precond_logdet(lj, 0.3, 80))
    # P⁻¹ really inverts P = LLᵀ + σ²I
    p = np.asarray(lj) @ np.asarray(lj).T + 0.3 * np.eye(80)
    _close(p @ bbmm.woodbury_precond(_t(lj), 0.3)(_t(v)).numpy(), v, rtol=1e-9)


def test_sample_precond_probes_matches_jax_on_its_keyed_draws():
    """The port takes the draws; given the ones JAX's key yields
    (``bbmm.py:297-299``) it makes JAX's probes."""
    kf, _ = _spd(n=64, seed=5)
    lj, _ = jbbmm.pivoted_cholesky(jnp.asarray(kf), 10)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    u1 = jax.random.normal(k1, (10, 8), jnp.float64)
    u2 = jax.random.normal(k2, (64, 8), jnp.float64)
    ref = jbbmm.sample_precond_probes(key, lj, 0.2, 8)
    _close(bbmm.sample_precond_probes(_t(lj), 0.2, _t(u1), _t(u2)), ref)


def test_woodbury_apply_is_float64_for_float32_operands_regression():
    """F-P9: at the JAX flagship's N = 1,048,576 (Nyström rank 1024, shift
    10) the float32 formula failed twice on an H100
    (tools/probe_woodbury_f32.py, chip_smoke.py --octave 1048576): LᵀL
    summed in one float32 product was off by more than the ridge c, which
    diverged the training solves at the init pose, and with that sum in
    float64 the float32 apply's cancellation, ε·λmax(P)/c, still left the
    serve's training solves at the relres gate.  Here 2²⁰ rows of a rank-4
    L, c = 4: a float32 sum over 64-row tiles, as a GEMM's K loop
    accumulates, is off by more than c; in L's range, where P⁻¹ differs from
    I/c, the port's apply (float64's on the same float32 operands) errs
    over 100 times less than the float32 apply on that sum or on float64's
    sum; float64 operands keep the plain formula's bits."""
    g = torch.Generator().manual_seed(0)
    n, k, c = 1 << 20, 4, 4.0
    l = (torch.randn(n, k, generator=g, dtype=torch.float64)
         * torch.tensor([3.0, 1.0, 0.3, 0.01], dtype=torch.float64)).float()
    l64 = l.double()
    exact = l64.T @ l64
    tiled = torch.zeros(k, k)
    for b in l.split(64):
        tiled += b.T @ b
    assert (tiled.double() - exact).abs().max() > c
    v = (l64 @ torch.randn(k, 3, generator=g, dtype=torch.float64)
         + torch.randn(n, 3, generator=g, dtype=torch.float64)).float()
    ref = bbmm.woodbury_precond(l64, c)(v.double())

    def f32_apply(gram):
        cf = torch.linalg.cholesky(c * torch.eye(k) + gram)
        return (v - l @ torch.cholesky_solve(l.T @ v, cf)) / c

    def range_err(a):
        return float((l64.T @ (a.double() - ref)).norm() / (l64.T @ ref).norm())

    got = bbmm.woodbury_precond(l, torch.tensor(c))(v)
    errs = (range_err(got), range_err(f32_apply(exact.float())), range_err(f32_apply(tiled)))
    assert got.dtype == torch.float32 and 100 * errs[0] < min(errs[1:]), errs
    cf = torch.linalg.cholesky(0.1 * torch.eye(k, dtype=torch.float64) + exact)
    v64 = v.double()
    assert torch.equal(bbmm.woodbury_precond(l64, 0.1)(v64), (v64 - l64 @ torch.cholesky_solve(l64.T @ v64, cf)) / 0.1)
