"""K9's plain version (``kernels/gibbs.gibbs_gram_reference``) and its
dispatch against the JAX package's Gibbs Gram kernel, and the split of the
Gibbs Gram into dispatcher and plain Gram (fault F-P2).

The JAX kernel runs as ``tests/test_pallas.py`` runs it on the CPU, in
Pallas interpret mode, on the same float32 inputs: both compute the same
elementwise formula in f32 (rtol 1e-5 covers a few ulps of sqrt and exp).
In float64 the plain Gram equals the JAX plain Gram to 1e-12, and the
autograd backward of the port's K9 function equals the JAX custom VJP to
1e-10.  The CUDA kernel itself runs only on the card (``chip_smoke.py``).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import nonstationary_precip_tpu.ops.pallas_gram as pg
from nonstationary_precip_tpu.kernels.gibbs import gibbs_gram_reference as jax_gibbs_gram_reference
from nonstationary_precip_tpu_torch.experiments import gibbs_largen
from nonstationary_precip_tpu_torch.kernels import gibbs
from nonstationary_precip_tpu_torch.ops import gibbs_gram as k9
from nonstationary_precip_tpu_torch.ops import matvec

torch.set_num_threads(1)


def _payload(n1, n2, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x1, x2 = rng.normal(size=(n1, d)), rng.normal(size=(n2, d))
    e1, e2 = np.exp(0.3 * rng.normal(size=(n1, d))), np.exp(0.3 * rng.normal(size=(n2, d)))
    return tuple(a.astype(dtype) for a in (x1, e1, x2, e2))


def test_plain_matches_jax_pallas_gram_in_interpret_mode():
    args = _payload(300, 520, 2, seed=9)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pg._forward(*(jnp.asarray(a) for a in args)))
    got = gibbs.gibbs_gram_reference(*(torch.tensor(a) for a in args)).numpy()
    assert got.dtype == np.float32 and got.shape == (300, 520)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("shape", [(40, 70, 2), (33, 17, 5)])
def test_plain_float64_matches_jax_reference(shape):
    args = _payload(*shape, seed=shape[0], dtype=np.float64)
    ref = np.asarray(jax_gibbs_gram_reference(*(jnp.asarray(a) for a in args)))
    got = gibbs.gibbs_gram_reference(*(torch.tensor(a) for a in args)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-300)


def test_k9_backward_matches_jax_bwd_in_float64():
    """The port's K9 function (on the CPU: plain forward, autograd through
    the plain Gram) against the JAX ``_bwd``, every input's cotangent."""
    args = _payload(30, 45, 2, seed=11, dtype=np.float64)
    g = np.random.default_rng(12).normal(size=(30, 45))
    ref = pg._bwd(tuple(jnp.asarray(a) for a in args), jnp.asarray(g))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    k9.gibbs_gram_pallas(*ts).backward(torch.tensor(g))
    for t, r in zip(ts, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-10, atol=1e-12 * np.abs(r).max())


def _jax_gate(x1, x2):
    """pallas_gram.py:41-66 as written, the environment switch on and the
    backend a TPU.  A stack with one leading shape is what JAX's vmap hands
    the gate a member at a time: each member decides."""
    if x1.ndim > 2 and x1.shape[:-2] == x2.shape[:-2]:
        return _jax_gate(x1.reshape(-1, *x1.shape[-2:])[0], x2.reshape(-1, *x2.shape[-2:])[0])
    if x1.dtype != np.float32 or x2.dtype != np.float32:
        return False
    if x1.ndim != 2 or x2.ndim != 2:
        return False
    if x1.shape[-1] > pg._MAX_D:
        return False
    return x1.shape[0] * x2.shape[0] >= 128 * 128


def on_card(shape, dtype):
    """What the gate reads of a tensor of ``shape`` and ``dtype`` on the
    card (this machine has none)."""
    return SimpleNamespace(device=torch.device("cuda"), dtype=dtype, ndim=len(shape), shape=torch.Size(shape))


@pytest.mark.parametrize("s1,s2,dtype", [
    ((128, 2), (128, 2), np.float32), ((127, 2), (129, 2), np.float32), ((1, 2), (16384, 2), np.float32),
    ((1, 2), (16383, 2), np.float32), ((200, 8), (200, 8), np.float32), ((200, 9), (200, 9), np.float32),
    ((3, 200, 2), (3, 200, 2), np.float32), ((10, 316, 2), (10, 250, 2), np.float32),
    ((10, 79, 2), (10, 79, 2), np.float32), ((2, 5, 200, 2), (2, 5, 200, 2), np.float32),
    ((3, 200, 9), (3, 200, 9), np.float32), ((200, 2), (200, 2), np.float64)])
def test_gate_is_jaxs(s1, s2, dtype):
    a1, a2 = np.zeros(s1, dtype), np.zeros(s2, dtype)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    assert k9.eligible(on_card(s1, tdt), on_card(s2, tdt)) is _jax_gate(a1, a2), (s1, s2, dtype)
    # off the card the gate is closed, as the JAX gate is on the CPU backend
    assert not k9.eligible(*(torch.empty(s, dtype=tdt, device="meta") for s in (s1, s2)))
    assert k9.MAX_D == pg._MAX_D


def test_dispatch_takes_k9_inside_its_gate(monkeypatch):
    """gibbs_gram sends a pair the gate admits to the K9 function and every
    other pair to the plain Gram; on the CPU the gate is closed."""
    calls = []
    monkeypatch.setattr(k9, "gibbs_gram_pallas", lambda *a: calls.append(a[0].shape) or gibbs.gibbs_gram_reference(*a))
    x1, e1, x2, e2 = (torch.tensor(a) for a in _payload(150, 120, 2, seed=3))
    ref = gibbs.gibbs_gram_reference(x1, e1, x2, e2)
    assert torch.equal(gibbs.gibbs_gram(x1, e1, x2, e2), ref) and calls == []
    monkeypatch.setattr(k9, "eligible", lambda a, b: True)
    assert torch.equal(gibbs.gibbs_gram(x1, e1, x2, e2), ref) and calls == [(150, 2)]


def test_wrapper_refuses_without_cuda():
    x = torch.zeros(130, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k9.gibbs_gram_cuda(x, x, x, x)
    with pytest.raises(ValueError, match="no path"):
        k9.gibbs_gram_pallas(*(torch.empty((130, 2), device="meta") for _ in range(4)))


def test_matrix_free_paths_never_reach_k9_regression(monkeypatch):
    """F-P2: the port's matrix-free Gibbs paths called the dispatching
    ``gibbs_gram``, so on the card the pivot loop's rows, the panel
    pullback and the dense N = 16384 oracle would have launched K9, which
    the JAX package's paths never run (they call the plain Gram by name).
    With the gate forced open and the K9 entry raising, the packed cross
    function, K2's plain version and the large-N experiment's dense oracle
    still run, and agree with the plain Gram."""
    def k9_entry(*a):
        raise AssertionError("K9 reached from a matrix-free path")

    monkeypatch.setattr(k9, "eligible", lambda a, b: True)
    monkeypatch.setattr(k9, "gibbs_gram_pallas", k9_entry)
    rng = np.random.default_rng(160)
    n = 160
    x = torch.tensor(rng.normal(size=(n, 2)), dtype=torch.float32)
    log_ell = torch.tensor(0.2 * rng.normal(size=(n, 2)), dtype=torch.float32)
    y = torch.sin(x[:, 0])
    ell = torch.exp(log_ell)
    aug = torch.cat([x, log_ell], dim=1)
    raw_s2 = torch.tensor(0.5)
    cross = gibbs.packed_gibbs_cross(2)(raw_s2, aug, aug)
    ref = torch.nn.functional.softplus(raw_s2) * gibbs.gibbs_gram_reference(x, ell, x, ell)
    torch.testing.assert_close(cross, ref, rtol=1e-6, atol=1e-7)
    v = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    torch.testing.assert_close(matvec.gibbs_gram_matvec_plain(x, ell, x, ell, v),
                               gibbs.gibbs_gram_reference(x, ell, x, ell) @ v, rtol=1e-5, atol=1e-5)
    params = {"log_ell_pp": log_ell, "raw_s2": raw_s2, "log_noise": torch.tensor(-2.0)}
    assert torch.isfinite(gibbs_largen.loss_dense(params, x, y))
    with pytest.raises(AssertionError, match="K9 reached"):
        gibbs.gibbs_gram(x, ell, x, ell)  # the dispatcher itself does reach it


def test_stacked_pairs_reach_k9_as_jax_vmap_does_regression(monkeypatch):
    """F-P5: the JAX package builds every split-stacked Gibbs Gram under
    ``jax.vmap`` (the slice step's ``gibbs_map_loss_batched``, its
    evaluation, ``GibbsSparseGP._roots``), where each member passes K9's 2-D
    gate and Pallas runs the split axis as one more grid axis.  The port's
    gate took 2-D pairs only, so on the card each of those Grams ran the
    plain Gram.  With the device test patched open on the CPU: the slice's
    stacked noisy Gram and the sparse model's two stacked Grams reach the
    K9 entry as stacks, a stack whose member fails the 2-D gate (79 × 79)
    or whose sides differ in leading shape does not, and the stacked plain
    Gram equals the per-member 2-D Grams bit for bit."""
    from nonstationary_precip_tpu_torch.models.gibbs_gp import GibbsExactGP, GibbsSparseGP, noisy_gibbs_gram
    from nonstationary_precip_tpu_torch.priors.lognormal_process import LogNormalProcess
    from nonstationary_precip_tpu_torch.train.vmapped import stack_modules

    calls = []

    def k9_entry(x1, ell1, x2, ell2):
        calls.append((tuple(x1.shape), tuple(x2.shape)))
        return gibbs.gibbs_gram_reference(x1, ell1, x2, ell2)

    real_eligible = k9.eligible
    monkeypatch.setattr(k9, "eligible", lambda a, b: real_eligible(on_card(a.shape, a.dtype), on_card(b.shape, b.dtype)))
    monkeypatch.setattr(k9, "gibbs_gram_pallas", k9_entry)
    rng = np.random.default_rng(316)
    prior = LogNormalProcess.create(input_dim=2, mean=np.log(0.3), outputscale=1.0, lengthscale=1.3)
    xs = [torch.tensor(rng.normal(size=(316, 2)), dtype=torch.float32) for _ in range(3)]
    exact = stack_modules([GibbsExactGP.create(x, prior, noise=0.011, outputscale=0.644) for x in xs])
    with torch.no_grad():
        noisy_gibbs_gram(exact, torch.stack(xs))
    assert calls == [((3, 316, 2), (3, 316, 2))]

    calls.clear()
    sparse = stack_modules([GibbsSparseGP.create(x[:250], prior, noise=0.011, outputscale=0.644) for x in xs])
    with torch.no_grad():
        sparse._roots(torch.stack(xs))
    assert calls == [((3, 316, 2), (3, 250, 2)), ((3, 250, 2), (3, 250, 2))]

    calls.clear()
    x79, e79 = torch.stack([x[:79] for x in xs]), torch.ones(3, 79, 2)
    out = gibbs.gibbs_gram(x79, e79, x79, e79)  # 79² < 128² a member: plain, as in JAX
    out_mixed = gibbs.gibbs_gram(torch.stack(xs), torch.ones(3, 316, 2), xs[0], torch.ones(316, 2))
    assert calls == [] and out.shape == (3, 79, 79) and out_mixed.shape == (3, 316, 316)

    x1, e1, x2, e2 = (torch.tensor(rng.normal(size=(4, n, 2)) * s + c, dtype=torch.float32)
                      for n, s, c in ((200, 1.0, 0.0), (200, 0.3, 1.0), (150, 1.0, 0.0), (150, 0.3, 1.0)))
    e1, e2 = e1.abs(), e2.abs()
    stacked = gibbs.gibbs_gram_reference(x1, e1, x2, e2)
    for t in range(4):
        assert torch.equal(stacked[t], gibbs.gibbs_gram_reference(x1[t], e1[t], x2[t], e2[t]))


def test_stacked_wrapper_refuses_what_the_entry_does_not_take():
    """The wrapper's shape checks on stacks (it raises before any launch)."""
    assert k9.members(torch.empty(2, 5, 7, 3)) == 10 and k9.members(torch.empty(7, 3)) == 1
    x = torch.zeros(2, 130, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k9.gibbs_gram_cuda(x, x, x, x)
    assert not k9.eligible(on_card((70000, 130, 2), torch.float32), on_card((70000, 130, 2), torch.float32))
    assert k9.eligible(on_card((65535, 130, 2), torch.float32), on_card((65535, 130, 2), torch.float32))
