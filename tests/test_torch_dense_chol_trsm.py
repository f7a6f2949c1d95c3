"""K10a's and K11's plain versions (``ops/chol_blocked``, ``ops/trsm``)
against the JAX package's blocked Cholesky and blocked triangular solve, their
pullbacks, and the dispatch of ``ops/linalg.cholesky_ex`` and ``tri_solve``.

The JAX kernels run as ``tests/test_pallas.py`` runs them on the CPU, in
Pallas interpret mode, on the same float32 inputs, and that file's band
holds (rtol 5e-3, atol 5e-4: both are f32 factorisations or solves, summed
in other orders).  In float64 the port's closed-form pullbacks equal the JAX
ones to 1e-10.  The CUDA kernels themselves run only on the card
(``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import nonstationary_precip_tpu.ops.pallas_chol as pc
import nonstationary_precip_tpu.ops.pallas_trsm as pt
from nonstationary_precip_tpu_torch.ops import chol_blocked, linalg, trsm

torch.set_num_threads(1)


def _spd(n, seed):
    a = np.random.default_rng(seed).normal(size=(n, n))
    return a @ a.T / n + np.eye(n)


@pytest.mark.parametrize("n", [256, 300])
def test_k10a_plain_matches_jax_blocked_cholesky(n):
    a = _spd(n, seed=n).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pc._forward(jnp.asarray(a)))
    got = chol_blocked.blocked_cholesky_plain(torch.tensor(a)).numpy()
    assert got.dtype == np.float32 and got.shape == (n, n)
    np.testing.assert_allclose(got, ref, rtol=5e-3, atol=5e-4)
    np.testing.assert_array_equal(np.triu(got, 1), 0.0)


def test_k10a_plain_fails_to_nan():
    b = np.random.default_rng(1).normal(size=(40, 5))
    got = chol_blocked.blocked_cholesky_plain(torch.tensor(b @ b.T))
    assert torch.isnan(got).all()


def test_safe_cholesky_pullback_is_jaxs_chol_pullback():
    """The pullback that ``safe_cholesky`` gives K10a's factor (the JAX
    ``_chol_pullback``'s formula) in float64."""
    n = 60
    a = torch.tensor(_spd(n, seed=5), requires_grad=True)
    g = np.random.default_rng(6).normal(size=(n, n))
    chol = linalg.safe_cholesky(a)
    chol.backward(torch.tensor(g))
    (ref,) = pc._chol_pullback(jnp.asarray(chol.detach().numpy()), jnp.asarray(g))
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-10 * np.abs(ref).max())


@pytest.mark.parametrize("n,k", [(256, 128), (300, 70)])
def test_k11_plain_matches_jax_blocked_trsm(n, k):
    rng = np.random.default_rng(n + k)
    l = np.linalg.cholesky(_spd(n, seed=n + 1)).astype(np.float32)
    b = rng.normal(size=(n, k)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pt._forward(jnp.asarray(l), jnp.asarray(b)))
    got = trsm.trsm_plain(torch.tensor(l), torch.tensor(b)).numpy()
    assert got.dtype == np.float32 and got.shape == (n, k)
    np.testing.assert_allclose(got, ref, rtol=5e-3, atol=5e-4)


def test_k11_backward_matches_jax_bwd_in_float64():
    n, k = 50, 7
    rng = np.random.default_rng(7)
    l = np.linalg.cholesky(_spd(n, seed=8))
    b, g = rng.normal(size=(n, k)), rng.normal(size=(n, k))
    lt, bt = torch.tensor(l, requires_grad=True), torch.tensor(b, requires_grad=True)
    x = trsm.blocked_trsm(lt, bt)
    x.backward(torch.tensor(g))
    lbar, bbar = pt._bwd((jnp.asarray(l), jnp.asarray(x.detach().numpy())), jnp.asarray(g))
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(bbar), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(lbar), rtol=1e-10, atol=1e-12)
    # and the closed form is the library solve's own gradient
    lt2, bt2 = torch.tensor(l, requires_grad=True), torch.tensor(b, requires_grad=True)
    torch.linalg.solve_triangular(lt2, bt2, upper=False).backward(torch.tensor(g))
    np.testing.assert_allclose(bt.grad.numpy(), bt2.grad.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(lt.grad.numpy(), torch.tril(lt2.grad).numpy(), rtol=1e-10, atol=1e-12)


def _jax_chol_gate(shape, dtype):
    """pallas_chol.py:43-67 as written, the switch on and the backend a TPU."""
    if dtype != np.float32 or len(shape) != 2:
        return False
    return 768 <= shape[-1] <= pc.MAX_N


@pytest.mark.parametrize("shape,dtype", [
    ((767, 767), np.float32), ((768, 768), np.float32), ((1280, 1280), np.float32), ((1281, 1281), np.float32),
    ((1000, 1000), np.float64), ((2, 1000, 1000), np.float32)])
def test_k10a_gate_is_jaxs(shape, dtype):
    t = torch.empty(shape, dtype=torch.float32 if dtype == np.float32 else torch.float64, device="meta")
    assert chol_blocked.eligible(t) is _jax_chol_gate(shape, dtype)
    assert (chol_blocked.MIN_N, chol_blocked.MAX_N, chol_blocked.BLOCK) == (768, pc.MAX_N, pc.BLOCK)


def _jax_trsm_gate(lshape, bshape, dtype):
    """pallas_trsm.py:37-54 as written, the switch on and the backend a TPU."""
    if dtype != np.float32 or len(lshape) != 2 or len(bshape) != 2:
        return False
    n = lshape[-1]
    return 768 <= n <= 1280 and n * n + 2 * n * bshape[-1] <= pt.MAX_TOTAL_ELEMS


@pytest.mark.parametrize("n,k,dtype,batched", [
    (767, 64, np.float32, False), (768, 64, np.float32, False), (1280, 256, np.float32, False),
    (1281, 64, np.float32, False), (1000, 1250, np.float32, False), (1000, 1251, np.float32, False),
    (1000, 64, np.float64, False), (1000, 64, np.float32, True)])
def test_k11_gate_is_jaxs(n, k, dtype, batched):
    lshape = (2, n, n) if batched else (n, n)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    lt, bt = torch.empty(lshape, dtype=tdt, device="meta"), torch.empty((n, k), dtype=tdt, device="meta")
    assert trsm.eligible(lt, bt) is _jax_trsm_gate(lshape, (n, k), dtype)
    assert (trsm.MAX_TOTAL_ELEMS, trsm.BLOCK) == (pt.MAX_TOTAL_ELEMS, pt.BLOCK)


def test_dispatch_on_the_cpu(monkeypatch):
    """A CPU float32 matrix in K10a's window takes its plain version, and
    safe_cholesky's retries of a 2-D matrix go through it too; a stack's
    retries stay on the library (the JAX dispatch takes 2-D matrices only);
    a lower, non-transposed solve of 2-D operands in K11's gate takes K11's
    function, any other solve the library."""
    chol_calls, trsm_calls = [], []
    real_chol, real_trsm = chol_blocked.blocked_cholesky, trsm.blocked_trsm
    monkeypatch.setattr(chol_blocked, "blocked_cholesky", lambda m: chol_calls.append(m.shape) or real_chol(m))
    monkeypatch.setattr(trsm, "blocked_trsm", lambda l, b: trsm_calls.append(b.shape) or real_trsm(l, b))
    n = 800
    a = torch.tensor(_spd(n, seed=2), dtype=torch.float32)
    chol = linalg.safe_cholesky(a)
    assert chol_calls == [(n, n)]
    torch.testing.assert_close(chol, torch.linalg.cholesky(a), rtol=0, atol=0)
    b = np.random.default_rng(3).normal(size=(n, 4))
    low_rank = torch.tensor(b @ b.T, dtype=torch.float32)
    fixed = linalg.safe_cholesky(low_rank)
    assert torch.isfinite(fixed).all() and len(chol_calls) >= 3
    chol_calls.clear()
    assert torch.isfinite(linalg.safe_cholesky(torch.stack([a, low_rank]))).all() and chol_calls == []
    rhs = torch.tensor(np.random.default_rng(4).normal(size=(n, 5)), dtype=torch.float32)
    x = linalg.tri_solve(chol, rhs)
    assert trsm_calls == [(n, 5)]
    torch.testing.assert_close(x, torch.linalg.solve_triangular(chol, rhs, upper=False), rtol=0, atol=0)
    linalg.tri_solve(chol, rhs, trans=True)
    linalg.tri_solve(chol, rhs[:, 0])
    linalg.tri_solve(chol.mT, rhs, lower=False)
    linalg.tri_solve(chol.double(), rhs.double())
    assert trsm_calls == [(n, 5)]


def test_wrappers_refuse_without_cuda():
    with pytest.raises(ValueError, match="CUDA tensor"):
        chol_blocked.blocked_cholesky_cuda(torch.eye(800))
    with pytest.raises(ValueError, match="no path"):
        chol_blocked.blocked_cholesky(torch.empty((800, 800), device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        trsm.trsm_cuda(torch.eye(800), torch.ones(800, 3))
    with pytest.raises(ValueError, match="no path"):
        trsm.blocked_trsm(torch.empty((800, 800), device="meta"), torch.empty((800, 3), device="meta"))
