"""K10b and K10c in the PyTorch port against the JAX package.

K10b is ``ops/chol_inv.chol_inv_batched`` (the JAX ``pallas_chol.
chol_inv_batched``: (L, L⁻¹) of a stack, no retry) and K10c is
``ops/chol_stream.streaming_cholesky_v1`` (the JAX ``pallas_chol.
streaming_cholesky``).  Here there is no card, so each entry takes its plain
version (the tensors lie on the CPU); the JAX kernels run in Pallas
interpret mode, as tests/test_pallas.py runs them, and the band is that
file's: rtol 5e-3 / atol 5e-4 on f32 inputs (atol 2e-3 on L⁻¹).  The
backwards are closed forms and are held to the JAX ones in float64 at 1e-9.
The CUDA kernels are held against the same plain versions on the card by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import nonstationary_precip_tpu.ops.pallas_chol as pc
from nonstationary_precip_tpu_torch.ops import chol_inv, chol_stream

torch.set_num_threads(1)


def _spd(rng, b, n):
    a = rng.normal(size=(b, n, n))
    return np.einsum("bij,bkj->bik", a, a) / n + np.eye(n)


@pytest.mark.parametrize("b,n", [(2, 130), (3, 250)])
def test_k10b_plain_matches_jax_kernel(b, n):
    """(L, L⁻¹) of the plain version against the JAX kernel in interpret
    mode (it pads to the next power of two), both f32."""
    a = _spd(np.random.default_rng(n), b, n).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        rl, rli = (np.asarray(t) for t in pc._chol_inv_forward(jnp.asarray(a)))
    l, li = chol_inv.chol_inv_batched(torch.from_numpy(a))
    assert l.dtype == torch.float32 and l.shape == (b, n, n) and li.shape == (b, n, n)
    np.testing.assert_allclose(l.numpy(), rl, rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(li.numpy(), rli, rtol=5e-3, atol=2e-3)
    np.testing.assert_array_equal(np.triu(l.numpy(), 1), 0.0)
    np.testing.assert_array_equal(np.triu(li.numpy(), 1), 0.0)


def test_k10b_backward_matches_jax_ci_bwd():
    """The entry's backward (``civ2_bwd``) is the JAX ``_ci_bwd`` in float64,
    for cotangents on both outputs, upper triangles included."""
    rng = np.random.default_rng(7)
    b, n = 2, 64
    a = _spd(rng, b, n)
    wl, wi = rng.normal(size=(b, n, n)), rng.normal(size=(b, n, n))
    l = np.linalg.cholesky(a)
    li = np.linalg.solve(l, np.broadcast_to(np.eye(n), (b, n, n)))
    with jax.enable_x64(True):
        (ref,) = pc._ci_bwd((jnp.asarray(l), jnp.asarray(li)), (jnp.asarray(wl), jnp.asarray(wi)))
    at = torch.tensor(a, requires_grad=True)
    tl, tli = chol_inv.chol_inv_batched(at)
    torch.sum(tl * torch.tensor(wl) + tli * torch.tensor(wi)).backward()
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(ref), rtol=1e-9, atol=1e-9)
    # one cotangent only: the other counts as zeros
    at.grad = None
    torch.sum(chol_inv.chol_inv_batched(at)[1] * torch.tensor(wi)).backward()
    with jax.enable_x64(True):
        (ref_i,) = pc._ci_bwd((jnp.asarray(l), jnp.asarray(li)), (None, jnp.asarray(wi)))
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(ref_i), rtol=1e-9, atol=1e-9)


def test_k10b_non_pd_member_is_nan_and_isolated():
    """No retry: a member that is not PD comes out NaN; the others are
    bitwise those of a run without it."""
    rng = np.random.default_rng(3)
    good = torch.tensor(_spd(rng, 3, 140), dtype=torch.float32)
    bad = good.clone()
    bad[1] = -bad[1]
    lg, lig = chol_inv.chol_inv_batched(good)
    lb, lib = chol_inv.chol_inv_batched(bad)
    assert bool(torch.isnan(lb[1]).all()) and bool(torch.isnan(lib[1]).all())
    assert torch.equal(lg[[0, 2]], lb[[0, 2]]) and torch.equal(lig[[0, 2]], lib[[0, 2]])
    assert bool(torch.isfinite(lg).all() and torch.isfinite(lig).all())


def test_k10b_cpu_never_reaches_the_kernel(monkeypatch):
    """A CPU stack takes the plain version and launches nothing; the
    kernel's wrapper refuses a CPU tensor; a meta tensor has no path."""
    monkeypatch.setattr(chol_inv, "chol_inv_grid_cuda", lambda m: (_ for _ in ()).throw(AssertionError("cuda")))
    before = chol_inv.GRID_LAUNCHES
    a = torch.tensor(_spd(np.random.default_rng(1), 2, 128))
    l, _ = chol_inv.chol_inv_batched(a)
    torch.testing.assert_close(l, torch.linalg.cholesky(a), rtol=0, atol=1e-12)
    assert chol_inv.GRID_LAUNCHES == before
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA tensor"):
        chol_inv.chol_inv_grid_cuda(torch.eye(128)[None])
    with pytest.raises(ValueError, match="no path"):
        chol_inv.chol_inv_batched(torch.empty((1, 128, 128), device="meta"))
    assert (chol_inv.GRID_MIN_N, chol_inv.GRID_MAX_N) == (pc.BLOCK, pc.MAX_N_CHOLINV)


@pytest.mark.parametrize("n", [256, 200])
def test_k10c_plain_matches_jax_kernel(n):
    """The right-looking plain version against the JAX v1 streaming kernel
    (left-looking, 256-wide panels) in interpret mode, both f32; N = 200
    pads to 256 on both sides."""
    a = _spd(np.random.default_rng(n), 1, n)[0].astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pc._forward_streaming(jnp.asarray(a)))
    got = chol_stream.streaming_cholesky_v1(torch.from_numpy(a)).numpy()
    assert got.dtype == np.float32 and got.shape == (n, n)
    np.testing.assert_allclose(got, ref, rtol=5e-3, atol=5e-4)
    np.testing.assert_array_equal(np.triu(got, 1), 0.0)


def test_k10c_plain_float64_and_nan_spreading():
    """In float64 the plain version is the library's factor (N = 700 spans
    three panels); a matrix that fails in its second panel is finite before
    that panel and NaN from it on, as the kernel's."""
    a = torch.tensor(_spd(np.random.default_rng(9), 1, 700)[0])
    ref = torch.linalg.cholesky(a)
    assert float((chol_stream.streaming_cholesky_v1_plain(a) - ref).abs().max()) <= 1e-10 * float(ref.abs().max())
    bad = a.clone()
    bad[300, 300] = -1.0
    l = chol_stream.streaming_cholesky_v1_plain(bad)
    assert bool(torch.isfinite(l[:, :256]).all())
    assert bool(torch.isnan(l[256:, 256:512]).all()) and bool(torch.isnan(l[512:, 512:]).all())


def test_k10c_pullback_matches_jax_sbwd():
    """The entry's backward is the JAX ``_sbwd`` (the closed-form pullback)
    in float64."""
    rng = np.random.default_rng(5)
    n = 300
    a = _spd(rng, 1, n)[0]
    w = rng.normal(size=(n, n))
    with jax.enable_x64(True):
        (ref,) = pc._sbwd(jnp.linalg.cholesky(jnp.asarray(a)), jnp.asarray(w))
    at = torch.tensor(a, requires_grad=True)
    torch.sum(chol_stream.streaming_cholesky_v1(at) * torch.tensor(w)).backward()
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(ref), rtol=1e-9, atol=1e-9)


def test_k10c_cpu_never_reaches_the_kernel(monkeypatch):
    monkeypatch.setattr(chol_stream, "streaming_cholesky_v1_cuda",
                        lambda m: (_ for _ in ()).throw(AssertionError("cuda")))
    before = chol_stream.V1_LAUNCHES
    chol_stream.streaming_cholesky_v1(torch.eye(300))
    assert chol_stream.V1_LAUNCHES == before
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA tensor"):
        chol_stream.streaming_cholesky_v1_cuda(torch.eye(256))
    with pytest.raises(ValueError, match="no path"):
        chol_stream.streaming_cholesky_v1(torch.empty((256, 256), device="meta"))
