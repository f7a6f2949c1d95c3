"""K1 in the PyTorch port (nonstationary_precip_tpu_torch/ops/chol_inv.py)
against the JAX package's ``chol_inv_batched_safe``.

Here there is no card, so the port's wrapper takes its plain version (the
input tensors lie on the CPU); the JAX side runs its Pallas kernel in
interpret mode, as tests/test_pallas.py does.  The CUDA kernel itself is
held against the same plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from nonstationary_precip_tpu.ops import pallas_chol
from nonstationary_precip_tpu_torch.ops import chol_inv, cuda_build

torch.set_num_threads(1)


def _spd(rng, t, n):
    b = rng.normal(size=(t, n, n))
    return np.einsum("tij,tkj->tik", b, b) / n + 0.5 * np.eye(n)


def _jax_k1(a32):
    with pltpu.force_tpu_interpret_mode():
        l, li = pallas_chol.chol_inv_batched_safe(jnp.asarray(a32, jnp.float32))
    return np.asarray(l), np.asarray(li)


@pytest.mark.parametrize("t,n", [(3, 140), (2, 316)])
def test_chol_inv_matches_f64_and_jax(t, n):
    """f32 (L, L⁻¹) of the port against a float64 numpy Cholesky and against
    the JAX kernel.  Tolerances: an f32 Cholesky of these well-conditioned
    stacks is good to a few ulps of its largest entry × √N (5e-6 relative);
    L⁻¹L − I collects N rounding terms of L⁻¹'s magnitude (5e-5); the two f32
    implementations differ only in summation order (1e-5 relative)."""
    rng = np.random.default_rng(173)
    a = _spd(rng, t, n)
    a32 = a.astype(np.float32)
    l, li, jit = chol_inv.chol_inv_batched_safe(torch.from_numpy(a32), return_jitter=True)
    l, li = l.numpy(), li.numpy()
    assert l.dtype == np.float32 and li.dtype == np.float32
    np.testing.assert_array_equal(jit.numpy(), np.zeros(t, np.float32))

    l64 = np.linalg.cholesky(a32.astype(np.float64))
    scale = np.abs(l64).max()
    assert np.abs(l - l64).max() / scale <= 5e-6
    eye = np.eye(n)
    for i in range(t):
        assert np.abs(li[i].astype(np.float64) @ l[i] - eye).max() <= 5e-5
        np.testing.assert_array_equal(np.triu(l[i], 1), 0.0)
        np.testing.assert_array_equal(np.triu(li[i], 1), 0.0)

    l_j, li_j = _jax_k1(a32)
    assert np.abs(l - l_j).max() / np.abs(l_j).max() <= 1e-5
    assert np.abs(li - li_j).max() / np.abs(li_j).max() <= 1e-5


def test_chol_inv_backward_matches_jax_civ2_bwd():
    """The autograd backward is the JAX package's matmul-only ``_civ2_bwd``,
    transcribed: same (L, L⁻¹, cotangents) in f64 → same K̄ to rtol 1e-10
    (identical products, possibly another summation order)."""
    rng = np.random.default_rng(7)
    t, n = 2, 40
    a = _spd(rng, t, n)
    l = np.linalg.cholesky(a)
    li = np.linalg.inv(l)
    lbar = rng.normal(size=(t, n, n))
    libar = rng.normal(size=(t, n, n))
    (ref,) = pallas_chol._civ2_bwd((jnp.asarray(l), jnp.asarray(li)), (jnp.asarray(lbar), jnp.asarray(libar)))
    ours = chol_inv.civ2_bwd(*(torch.from_numpy(v) for v in (l, li, lbar, libar)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12 * np.abs(ref).max())
    # a None cotangent counts as zeros
    (ref_l,) = pallas_chol._civ2_bwd((jnp.asarray(l), jnp.asarray(li)), (jnp.asarray(lbar), None))
    ours_l = chol_inv.civ2_bwd(torch.from_numpy(l), torch.from_numpy(li), torch.from_numpy(lbar), None)
    np.testing.assert_allclose(ours_l.numpy(), np.asarray(ref_l), rtol=1e-10, atol=1e-12 * np.abs(ref_l).max())


def test_chol_inv_gradient_matches_torch_autograd():
    """Gradient through the autograd Function against torch autograd through
    the plain composition (cholesky + solve_triangular), in f64.  K is built
    as S + Sᵀ so the gradient w.r.t. S is the same whichever symmetrisation
    convention each side uses.  rtol 1e-8: two exact pullbacks in f64 that
    differ by O(cond·ε) rounding."""
    rng = np.random.default_rng(11)
    t, n = 3, 30
    s0 = _spd(rng, t, n) / 2
    w1 = torch.from_numpy(rng.normal(size=(t, n, n)))
    w2 = torch.from_numpy(rng.normal(size=(t, n, n)))

    def grad_of(fn):
        s = torch.from_numpy(s0.copy()).requires_grad_(True)
        l, li = fn(s + s.mT)
        (torch.sum(w1 * l) + torch.sum(w2 * li)).backward()
        return s.grad.numpy()

    def composition(k):
        l = torch.linalg.cholesky(k)
        eye = torch.eye(n, dtype=k.dtype).expand_as(k)
        return l, torch.linalg.solve_triangular(l, eye, upper=False)

    ours = grad_of(chol_inv.chol_inv_batched_safe)
    ref = grad_of(composition)
    np.testing.assert_allclose(ours, ref, rtol=1e-8, atol=1e-10 * np.abs(ref).max())


def test_chol_inv_retry_matches_jax_and_isolates_members():
    """A rank-30 member (n = 140) in a stack of three fails the plain
    factorisation; both sides retry it up the same jitter ladder and return
    a finite factor of A + j·I at the same j, while the healthy members keep
    j = 0 and stay bit-identical to an all-healthy run.

    The jittered member has 110 eigenvalues ≈ j, so only its first 30
    columns are well determined in f32: they must agree to 1e-4 relative
    (measured 1.4e-5).  The other 110 pivots are ≈ √j and carry f32 noise of
    order one in relative terms, so the jitter level is read from the
    logdet: one rung of the ladder (×10) moves it by 110·ln 10 ≈ 253, and
    the two sides must agree, and match the f64 logdet of A + j·I, to
    within a tenth of that (measured 2.1 apart)."""
    rng = np.random.default_rng(173)
    n = 140
    base = rng.normal(size=(3, n, n))
    good = np.einsum("tij,tkj->tik", base, base) + 5.0 * np.eye(n)
    sing_base = rng.normal(size=(n, 30))
    singular = sing_base @ sing_base.T
    all_good = good.astype(np.float32)
    one_bad = np.stack([good[0], singular, good[2]]).astype(np.float32)

    l_a, li_a, j_a = chol_inv.chol_inv_batched_safe(torch.from_numpy(all_good), return_jitter=True)
    l_b, li_b, j_b = chol_inv.chol_inv_batched_safe(torch.from_numpy(one_bad), return_jitter=True)
    assert torch.isfinite(l_b).all() and torch.isfinite(li_b).all()
    assert j_a.tolist() == [0.0, 0.0, 0.0]
    assert j_b[0] == 0 and j_b[2] == 0
    ladder = [np.float32(1e-5)]
    for _ in range(5):
        ladder.append(ladder[-1] * np.float32(10.0))
    assert np.float32(j_b[1]) in ladder
    for i in (0, 2):
        np.testing.assert_array_equal(l_a[i].numpy(), l_b[i].numpy())
        np.testing.assert_array_equal(li_a[i].numpy(), li_b[i].numpy())

    l_j, _ = _jax_k1(one_bad)
    assert np.isfinite(l_j).all()
    ours = l_b[1].numpy()
    assert np.abs(ours[:, :30] - l_j[1][:, :30]).max() / np.abs(l_j[1]).max() <= 1e-4
    rung = (n - 30) * np.log(10.0)
    logdet_ours = 2 * np.log(np.diag(ours).astype(np.float64)).sum()
    logdet_jax = 2 * np.log(np.diag(l_j[1]).astype(np.float64)).sum()
    logdet_f64 = np.linalg.slogdet(singular + float(j_b[1]) * np.eye(n))[1]
    assert abs(logdet_ours - logdet_jax) <= 0.1 * rung
    assert abs(logdet_ours - logdet_f64) <= 0.1 * rung


def test_chol_inv_v2_is_one_try_of_the_same_path():
    """``chol_inv_batched_v2``: the retry off.  On a healthy stack it equals
    the safe form exactly; a failing member stays non-finite."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(_spd(rng, 2, 130).astype(np.float32))
    l2, li2 = chol_inv.chol_inv_batched_v2(a)
    l, li, _ = chol_inv.chol_inv_batched_safe_plain(a, max_tries=0)
    torch.testing.assert_close(l2, l, rtol=0, atol=0)
    torch.testing.assert_close(li2, li, rtol=0, atol=0)
    ls, lis = chol_inv.chol_inv_batched_safe(a)
    torch.testing.assert_close(l2, ls, rtol=0, atol=0)
    bad = a.clone()
    bad[1] = -bad[1]
    l2b, _ = chol_inv.chol_inv_batched_v2(bad)
    assert torch.isfinite(l2b[0]).all() and not torch.isfinite(l2b[1]).any()


@pytest.mark.parametrize(
    "make,exc",
    [
        (lambda: torch.eye(140, dtype=torch.float64).expand(2, 140, 140).contiguous(), TypeError),
        (lambda: torch.eye(140).expand(2, 140, 140), ValueError),  # not contiguous
        (lambda: torch.eye(400).expand(1, 400, 400).contiguous(), ValueError),  # N > MAX_N
        (lambda: torch.eye(140), ValueError),  # not a stack
    ],
)
def test_chol_inv_kernel_rejects_what_it_does_not_take(make, exc):
    """The kernel's wrapper checks type, shape and contiguity before any
    CUDA call and raises; there is no fallback."""
    with pytest.raises(exc):
        chol_inv.chol_inv_batched_cuda(make())


def test_chol_inv_build_raises_on_compiler_failure(tmp_path, monkeypatch):
    """A compile that fails raises with the compiler's output; nothing is
    loaded in its place."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\necho 'chol_inv_batched.cu(1): error: broken' >&2\nexit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(chol_inv, "_lib", None)
    with pytest.raises(RuntimeError, match="error: broken"):
        chol_inv.build(force=True)
    assert chol_inv._lib is None
    assert not list((tmp_path / "build").glob("*.so"))


def test_chol_inv_cpu_dispatch_takes_the_plain_version():
    """A CPU tensor goes to the plain version and never counts a launch."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(_spd(rng, 2, 128).astype(np.float32))
    before = chol_inv.LAUNCHES
    l, li = chol_inv.chol_inv_batched_safe(a)
    ref_l, ref_li, _ = chol_inv.chol_inv_batched_safe_plain(a)
    assert chol_inv.LAUNCHES == before
    torch.testing.assert_close(l, ref_l, rtol=0, atol=0)
    torch.testing.assert_close(li, ref_li, rtol=0, atol=0)
    assert jax is not None  # both frameworks live in this process
