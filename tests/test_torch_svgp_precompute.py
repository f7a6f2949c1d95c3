"""K4 in the PyTorch port (nonstationary_precip_tpu_torch/ops/svgp_precompute.py)
against the JAX package's ``ops/pallas_svgp.py``.

Here there is no card, so the port's wrapper takes its plain version (the
tensors lie on the CPU); the JAX side runs its Pallas kernel in interpret
mode, as tests/test_pallas.py does, or its plain ``_reference``.  The CUDA
kernel itself is held against the same plain version on the card by
chip_smoke.py.

Tolerances.  The K_zz of random inducing points in 2-D is near-singular
(‖L⁻¹‖ ~ 3e2 at M = 128), so every f32 path is far from the f64 truth in W
and L⁻¹, and absolute closeness of two f32 paths means nothing.  As in
tests/test_pallas.py:352-369, the JAX kernel's f32 error from f64 must stay
within twice that of a plain f32 composition, here the port's plain
version (plus 1e-5 in L, 1e-3 in W and L⁻¹).  So that this also bounds the
port, its error must stay within four times that of JAX's own f32
composition ``_reference``: two LAPACK-style compositions whose errors
differ by up to 3× on these inputs (measured over three seeds).  In f64 the
port and ``_reference`` are the same arithmetic in another order: 1e-10 of
each output's largest entry.  Gradients: rtol 1e-7, the JAX test's band for
its closed-form pullback (the L⁻¹ cotangent reaches ~1e4 through the
inverse's conditioning).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import nonstationary_precip_tpu.ops.pallas_svgp as ps
from nonstationary_precip_tpu.utils.config import EPSILON
from nonstationary_precip_tpu_torch.ops import svgp_precompute as sp

torch.set_num_threads(1)


def _inputs(rng, t, mm, d):
    z = rng.normal(size=(t, mm, d))
    ell = np.exp(rng.normal(size=(t, d)) * 0.3) + 0.3
    s2 = np.exp(rng.normal(size=t) * 0.2)
    packed = rng.normal(size=(t, mm, 2 * mm + 1))
    return z, ell, s2, packed


def _jax_k4(args32):
    with pltpu.force_tpu_interpret_mode():
        return [np.asarray(a) for a in ps._forward(*(jnp.asarray(a, jnp.float32) for a in args32))]


def _port(args, jitter=False):
    out = sp.svgp_precompute_plain(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))
    return [o.numpy() for o in out] if jitter else [o.numpy() for o in out[:3]]


@pytest.mark.parametrize("t,mm,d", [(3, 128, 2), (2, 37, 3)])
def test_plain_matches_jax_k4_under_the_f64_criterion(t, mm, d):
    """The f32 paths against the f64 truth on the same f32 inputs: the JAX
    kernel within twice the port's error, the port within four times JAX's
    plain composition's.  No member needs a retry."""
    rng = np.random.default_rng(173 + mm)
    args32 = [a.astype(np.float32) for a in _inputs(rng, t, mm, d)]
    l, w, li, jit = _port(args32, jitter=True)
    assert l.dtype == np.float32 and np.isfinite(l).all() and np.isfinite(w).all() and np.isfinite(li).all()
    np.testing.assert_array_equal(jit, np.zeros(t, np.float32))
    np.testing.assert_array_equal(np.triu(l, 1), 0.0)
    np.testing.assert_array_equal(np.triu(li, 1), 0.0)
    ref64 = [np.asarray(a) for a in ps._reference(*(jnp.asarray(a, jnp.float64) for a in args32))]
    ref32 = [np.asarray(a) for a in ps._reference(*(jnp.asarray(a) for a in args32))]
    kj = _jax_k4(args32)
    for ours, k4, xla, truth, slack in zip((l, w, li), kj, ref32, ref64, (1e-5, 1e-3, 1e-3)):
        err, err_k4, err_xla = (np.abs(a - truth).max() for a in (ours, k4, xla))
        assert err_k4 <= 2.0 * err + slack, (err_k4, err)
        assert err <= 4.0 * err_xla + slack, (err, err_xla)


def test_plain_f64_matches_reference():
    """In f64 the plain forward is ``_reference``'s arithmetic: (L, W, L⁻¹)
    within 1e-10 of each output's largest entry.  (The diagonal is set to
    exactly s² + ε where ``_reference`` computes s²·exp(−½·max(q, 0)) + ε
    with q ≈ 1e-16: no difference at this band.)"""
    rng = np.random.default_rng(7)
    args = _inputs(rng, 2, 48, 2)
    ours = _port(args)
    ref = [np.asarray(a) for a in ps._reference(*(jnp.asarray(a) for a in args))]
    for o, r in zip(ours, ref):
        assert o.dtype == np.float64
        assert np.abs(o - r).max() <= 1e-10 * np.abs(r).max()


def test_gram_matches_the_model_gram_and_sets_the_diagonal():
    """``gram_zz_plain`` is the kernel's K: off the diagonal the JAX gram,
    on it exactly s² + ε."""
    rng = np.random.default_rng(9)
    z, ell, s2, _ = _inputs(rng, 3, 20, 2)
    k = sp.gram_zz_plain(*(torch.from_numpy(a) for a in (z, ell, s2))).numpy()
    zs = z / ell[:, None, :]
    d2 = ((zs[:, :, None, :] - zs[:, None, :, :]) ** 2).sum(-1)
    ref = s2[:, None, None] * np.exp(-0.5 * d2)
    off = ~np.eye(20, dtype=bool)
    np.testing.assert_allclose(k[:, off], ref[:, off], rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(np.diagonal(k, axis1=-2, axis2=-1), (s2 + EPSILON)[:, None] * np.ones(20))


@pytest.mark.parametrize("with_linv_cotangent", [False, True])
def test_autograd_matches_jax_bwd_and_vjp(with_linv_cotangent):
    """The autograd Function's gradients against JAX's closed-form ``_bwd``
    and against ``jax.vjp`` of ``_reference`` (f64), for the two cotangent
    sets of tests/test_pallas.py:389: (L̄, W̄, 0) and (L̄, W̄, X̄)."""
    rng = np.random.default_rng(11)
    t, mm, d = 2, 48, 2
    args = _inputs(rng, t, mm, d)
    wl = rng.normal(size=(t, mm, mm))
    ww = rng.normal(size=(t, mm, 2 * mm + 1))
    wx = rng.normal(size=(t, mm, mm)) if with_linv_cotangent else np.zeros((t, mm, mm))
    jargs = [jnp.asarray(a) for a in args]
    out, vjp = jax.vjp(ps._reference, *jargs)
    cots = (jnp.asarray(wl), jnp.asarray(ww), jnp.asarray(wx))
    ref_vjp = [np.asarray(g) for g in vjp(cots)]
    ref_bwd = [np.asarray(g) for g in ps._bwd((*jargs[:3], out), cots)]

    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    l, w, li = sp.svgp_precompute_fused(*targs)
    ours = torch.autograd.grad((l, w, li), targs, (torch.from_numpy(wl), torch.from_numpy(ww), torch.from_numpy(wx)))
    for o, rb, rv in zip(ours, ref_bwd, ref_vjp):
        np.testing.assert_allclose(o.numpy(), rb, rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(o.numpy(), rv, rtol=1e-7, atol=1e-9)


def test_unused_outputs_take_no_cotangent():
    """On the training path only W is used: L̄ and X̄ arrive as None and
    count as zeros, so the gradient equals the one with explicit zeros."""
    rng = np.random.default_rng(13)
    args = _inputs(rng, 2, 24, 2)
    ww = torch.from_numpy(rng.normal(size=(2, 24, 49)))

    def grads(explicit):
        targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
        l, w, li = sp.svgp_precompute_fused(*targs)
        if explicit:
            return torch.autograd.grad((l, w, li), targs, (torch.zeros_like(l), ww, torch.zeros_like(li)))
        return torch.autograd.grad(w, targs, ww)

    for a, b in zip(grads(False), grads(True)):
        torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-13)


def _ill_conditioned(rng, bad_members):
    """tests/test_pallas.py:449-458: duplicated z and s² = 40 make K_zz too
    ill-conditioned for a plain f32 Cholesky (min eigenvalue ≈ 2ε)."""
    t, mm, d = 2, 128, 2
    z = rng.normal(size=(t, mm, d))
    s2 = np.ones(t)
    for i in bad_members:
        z[i, 64] = z[i, 32]
        s2[i] = 40.0
    return [a.astype(np.float32) for a in (z, np.ones((t, d)), s2, rng.normal(size=(t, mm, 2 * mm + 1)))]


def _retry_level(args32, l):
    """The rung of K4's ladder whose K + extra·I the factor ``l`` (T, M, M)
    reconstructs best, per member."""
    z, ell, s2, _ = (a.astype(np.float64) for a in args32)
    zs = z / ell[:, None, :]
    d2 = ((zs[:, :, None, :] - zs[:, None, :, :]) ** 2).sum(-1)
    k = s2[:, None, None] * np.exp(-0.5 * d2) + EPSILON * np.eye(z.shape[1])
    recon = l.astype(np.float64) @ np.swapaxes(l, -1, -2).astype(np.float64)
    levels = (0.0, 1e-4, 1e-4 + 1e-2)
    errs = np.stack([np.abs(recon - (k + e * np.eye(z.shape[1]))).max(axis=(-2, -1)) for e in levels], axis=-1)
    return np.asarray(levels)[errs.argmin(axis=-1)], errs.min(axis=-1)


def test_retry_matches_jax_k4():
    """Both members fail the plain f32 factorisation: the port's ladder and
    JAX's in-kernel retry both come back finite, at the same rung, and both
    factors reconstruct K + extra·I (5e-2, the JAX test's band at s² = 40)."""
    rng = np.random.default_rng(173)
    args32 = _ill_conditioned(rng, (0, 1))
    l_plain32 = np.asarray(ps._reference(*(jnp.asarray(a) for a in args32))[0])
    assert not np.isfinite(l_plain32).all()  # the input really defeats a retry-free factor
    l, w, li, jit = _port(args32, jitter=True)
    assert np.isfinite(l).all() and np.isfinite(w).all() and np.isfinite(li).all()
    level, err = _retry_level(args32, l)
    np.testing.assert_allclose(jit, level, rtol=1e-6)
    assert (jit > 0).all() and (err < 5e-2).all(), (jit, err)
    lj, wj, _ = _jax_k4(args32)
    assert np.isfinite(lj).all() and np.isfinite(wj).all()
    level_j, err_j = _retry_level(args32, lj)
    np.testing.assert_array_equal(level, level_j)
    assert (err_j < 5e-2).all()


def test_retry_isolates_members_like_jax_k4():
    """tests/test_pallas.py:657: one ill-conditioned member leaves the other
    bit-identical to an all-healthy run with no jitter, as JAX's kernel
    does; the bad member takes the same rung as JAX's."""
    rng = np.random.default_rng(17)
    good = _ill_conditioned(rng, ())
    bad = [a.copy() for a in good]
    bad[0][1, 64] = bad[0][1, 32]
    bad[2][1] = 40.0
    l_a, w_a, li_a, j_a = _port(good, jitter=True)
    l_b, w_b, li_b, j_b = _port(bad, jitter=True)
    for o in (l_b, w_b, li_b):
        assert np.isfinite(o).all()
    np.testing.assert_array_equal(j_a, [0.0, 0.0])
    assert j_b[0] == 0.0 and j_b[1] > 0.0
    for a, b in ((l_a, l_b), (w_a, w_b), (li_a, li_b)):
        np.testing.assert_array_equal(a[0], b[0])
    lj, _, _ = _jax_k4(bad)
    np.testing.assert_array_equal(_retry_level(bad, l_b)[0], _retry_level(bad, lj)[0])
    np.testing.assert_allclose(j_b, _retry_level(bad, l_b)[0], rtol=1e-6)


def test_a_member_that_never_factors_comes_back_nan():
    """All three rungs fail (an indefinite K): that member is NaN, the
    others are untouched."""
    rng = np.random.default_rng(19)
    args = [a.astype(np.float32) for a in _inputs(rng, 2, 16, 2)]
    args[2][1] = -1.0  # s² < 0: K = −G + εI is indefinite
    l, w, li, jit = _port(args, jitter=True)
    assert np.isfinite(l[0]).all() and not np.isfinite(l[1]).any() and not np.isfinite(w[1]).any()
    np.testing.assert_allclose(jit, [0.0, np.float32(1e-4) + np.float32(1e-2)])


@pytest.mark.parametrize(
    "change,exc",
    [
        (lambda a: [x.double() for x in a], TypeError),
        (lambda a: [a[0].mT.contiguous().mT, *a[1:]], ValueError),  # not contiguous
        (lambda a: [torch.zeros(2, 257, 2), a[1], a[2], torch.zeros(2, 257, 515)], ValueError),  # M > 256
        (lambda a: [torch.zeros(2, 16, 9), torch.ones(2, 9), a[2], a[3]], ValueError),  # D > 8
        (lambda a: [a[0], a[1][:1], a[2], a[3]], ValueError),  # shapes disagree
    ],
)
def test_kernel_wrapper_rejects_what_it_does_not_take(change, exc):
    """The kernel's wrapper checks type, shape and contiguity before any CUDA
    call and raises; there is no fallback."""
    base = [torch.zeros(2, 16, 2), torch.ones(2, 2), torch.ones(2), torch.zeros(2, 16, 33)]
    with pytest.raises(exc):
        sp.svgp_precompute_cuda(*change(base))


def test_cpu_dispatch_takes_the_plain_version():
    """A CPU tensor goes to the plain version and never counts a launch."""
    rng = np.random.default_rng(23)
    args = [torch.from_numpy(a.astype(np.float32)) for a in _inputs(rng, 2, 30, 2)]
    before = sp.LAUNCHES
    out = sp.svgp_precompute_fused(*args, return_jitter=True)
    ref = sp.svgp_precompute_plain(*args)
    assert sp.LAUNCHES == before
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
