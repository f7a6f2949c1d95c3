"""K8's plain version (``ops/gibbs_fused.gibbs_chol_solve_plain``), its
closed-form backward and its jitter ladder against the JAX package's fused
Gram → Cholesky → solve kernel, and the gate.

The JAX kernel runs as ``tests/test_pallas.py`` runs it on the CPU, in
Pallas interpret mode, on the same float32 inputs, with that file's band
(:161-182: rtol 3e-4 / atol 3e-5 on L; α passes through an N-step f32
substitution, rtol 3e-3 / atol 5e-3).  In float64 the plain version equals
the JAX ``_reference`` to 1e-10 and the port's backward the JAX ``_bwd`` to
1e-9 (``test_pallas.py:218``'s band).  The CUDA kernel itself runs only on
the card (``chip_smoke.py``).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import nonstationary_precip_tpu.ops.pallas_fused as pf
from nonstationary_precip_tpu_torch.kernels.gibbs import gibbs_gram_reference
from nonstationary_precip_tpu_torch.ops import gibbs_fused

torch.set_num_threads(1)

S2, NOISE = 0.644, 0.011


def _payload(n, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    ell = np.exp(0.3 * rng.normal(size=(n, d))) + 0.2
    y = rng.normal(size=n)
    return tuple(a.astype(dtype) for a in (x, ell, y))


def _plain(x, ell, y, s2=S2, noise=NOISE, dtype=torch.float32):
    t = [torch.tensor(a) for a in (x, ell, y)]
    return gibbs_fused.gibbs_chol_solve_plain(*t, torch.tensor(s2, dtype=dtype), torch.tensor(noise, dtype=dtype))


@pytest.mark.parametrize("n", [256, 300])
def test_plain_matches_jax_fused_kernel_in_interpret_mode(n):
    x, ell, y = _payload(n, 2, seed=n)
    with pltpu.force_tpu_interpret_mode():
        chol_j, alpha_j = pf._forward(*(jnp.asarray(a) for a in (x, ell, y)), jnp.float32(S2), jnp.float32(NOISE))
    chol, alpha, tries = _plain(x, ell, y)
    assert tries == 1 and chol.dtype == torch.float32
    np.testing.assert_allclose(chol.numpy(), np.asarray(chol_j), rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(alpha_j), rtol=3e-3, atol=5e-3)
    np.testing.assert_array_equal(np.triu(chol.numpy(), 1), 0.0)


@pytest.mark.parametrize("n,d", [(120, 2), (90, 3)])
def test_plain_float64_matches_jax_reference(n, d):
    x, ell, y = _payload(n, d, seed=7 * n, dtype=np.float64)
    chol_j, alpha_j = pf._reference(*(jnp.asarray(a) for a in (x, ell, y)), jnp.float64(S2), jnp.float64(NOISE))
    chol, alpha, tries = _plain(x, ell, y, dtype=torch.float64)
    assert tries == 1
    np.testing.assert_allclose(chol.numpy(), np.asarray(chol_j), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(alpha_j), rtol=1e-10, atol=1e-10)


def test_backward_matches_jax_bwd_in_float64():
    """The port's closed-form pullback against the JAX ``_bwd`` at n = 96,
    every input's cotangent (x, ℓ, y, s², σ²)."""
    n = 96
    x, ell, y = _payload(n, 2, seed=96, dtype=np.float64)
    rng = np.random.default_rng(97)
    wl, wa = rng.normal(size=(n, n)), rng.normal(size=n)
    args_j = tuple(jnp.asarray(a) for a in (x, ell, y)) + (jnp.float64(S2), jnp.float64(NOISE))
    out_j = pf._reference(*args_j)
    ref = pf._bwd(args_j + (out_j,), (jnp.asarray(wl), jnp.asarray(wa)))
    ts = [torch.tensor(a, requires_grad=True) for a in (x, ell, y)]
    ts += [torch.tensor(S2, dtype=torch.float64, requires_grad=True),
           torch.tensor(NOISE, dtype=torch.float64, requires_grad=True)]
    chol, alpha = gibbs_fused.gibbs_chol_solve_fused(*ts)
    (torch.sum(torch.tensor(wl) * chol) + torch.sum(torch.tensor(wa) * alpha)).backward()
    for t, r in zip(ts, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-9, atol=1e-9)


def test_ladder_on_a_singular_payload():
    """A duplicated row at noise 0 (``test_pallas.py:400``'s payload): the
    first attempt fails, the second (extra jitter 1e-4) succeeds, and the
    plain factor is the float64 factor of s²K + 1e-4·I to f32 accuracy; the
    JAX kernel lands on the same rung."""
    n = 256
    x, ell, y = _payload(n, 2, seed=400)
    x[100], ell[100] = x[50], ell[50]
    chol, alpha, tries = _plain(x, ell, y, noise=0.0)
    assert tries == 2 and torch.isfinite(chol).all() and torch.isfinite(alpha).all()
    x64, e64 = torch.tensor(x, dtype=torch.float64), torch.tensor(ell, dtype=torch.float64)
    k64 = S2 * gibbs_gram_reference(x64, e64, x64, e64) + 1e-4 * torch.eye(n, dtype=torch.float64)
    l64 = torch.linalg.cholesky(k64)
    assert float((chol.double() - l64).abs().max()) <= 2e-3 * float(l64.abs().max())
    k_noladder = S2 * gibbs_gram_reference(*(torch.tensor(a) for a in (x, ell, x, ell)))
    assert not torch.isfinite(gibbs_fused.blocked_cholesky_plain(k_noladder)).all()
    with pltpu.force_tpu_interpret_mode():
        chol_j, _ = pf._forward(*(jnp.asarray(a) for a in (x, ell, y)), jnp.float32(S2), jnp.float32(0.0))
    np.testing.assert_allclose(chol.numpy(), np.asarray(chol_j), rtol=2e-3, atol=2e-3)


def on_card(shape, dtype):
    """What the gate reads of a tensor of ``shape`` and ``dtype`` on the
    card (this machine has none)."""
    return SimpleNamespace(device=torch.device("cuda"), dtype=dtype, ndim=len(shape), shape=torch.Size(shape))


def _jax_gate(xs, es, dtype):
    """pallas_fused.py:54-88 as written, the switch on and the backend a TPU."""
    if dtype != np.float32 or len(xs) != 2 or len(es) != 2:
        return False
    if xs[-1] > pf._MAX_D:
        return False
    return 768 <= xs[0] <= 1280


@pytest.mark.parametrize("xs,es,dtype", [
    ((767, 2), (767, 2), np.float32), ((768, 2), (768, 2), np.float32), ((1280, 2), (1280, 2), np.float32),
    ((1281, 2), (1281, 2), np.float32), ((1000, 8), (1000, 8), np.float32), ((1000, 9), (1000, 9), np.float32),
    ((1000, 2), (1000, 2), np.float64), ((3, 1000, 2), (3, 1000, 2), np.float32),
    ((1000, 2), (3, 1000, 2), np.float32)])
def test_gate_is_jaxs(xs, es, dtype):
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    assert gibbs_fused.eligible(on_card(xs, tdt), on_card(es, tdt)) is _jax_gate(xs, es, dtype), (xs, es)
    # off the card the gate is closed, as the JAX gate is on the CPU backend
    assert not gibbs_fused.eligible(*(torch.empty(s, dtype=tdt, device="meta") for s in (xs, es)))
    assert gibbs_fused.EXTRA_JITTER == (0.0, 1e-4, 1e-2) and gibbs_fused.MAX_D == pf._MAX_D


def test_dispatcher_takes_the_fused_function_inside_its_gate(monkeypatch):
    """With the gate open (on the card) the dispatcher calls K8's function,
    which on the CPU runs the plain version: the same (L, α) as the composed
    path on a healthy matrix."""
    x, ell, y = (torch.tensor(a) for a in _payload(200, 2, seed=5))
    s2, noise = torch.tensor(S2), torch.tensor(NOISE)
    composed = gibbs_fused.gibbs_noisy_chol_alpha(x, ell, y, s2, noise)
    calls = []
    real = gibbs_fused.gibbs_chol_solve_fused
    monkeypatch.setattr(gibbs_fused, "eligible", lambda a, b: True)
    monkeypatch.setattr(gibbs_fused, "gibbs_chol_solve_fused", lambda *a: calls.append(1) or real(*a))
    fused = gibbs_fused.gibbs_noisy_chol_alpha(x, ell, y, s2, noise)
    assert calls == [1]
    for a, b in zip(fused, composed):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_wrapper_refuses_without_cuda():
    x = torch.zeros(800, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gibbs_fused.gibbs_chol_solve_cuda(x, x, torch.zeros(800), 1.0, 0.1)
    meta = [torch.empty(s, device="meta") for s in ((800, 2), (800, 2), (800,), (), ())]
    with pytest.raises(ValueError, match="no path"):
        gibbs_fused.gibbs_chol_solve_fused(*meta)
