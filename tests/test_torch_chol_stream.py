"""K5's plain version (``ops/chol_stream.streaming_cholesky_plain``) against
the JAX package's streaming Cholesky, and the dispatch that sends a matrix
to K5 (``ops/linalg.cholesky``).

The JAX kernel runs as ``tests/test_pallas.py`` runs it on the CPU, in
Pallas interpret mode, on the same float32 SPD inputs; its own test holds
it to float64 numpy at rtol 5e-3 / atol 5e-4, and that is the band here.
In float64 the plain version is held to ``torch.linalg.cholesky`` at
1e-10.  The CUDA kernel itself runs only on the card (``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import nonstationary_precip_tpu.ops.pallas_chol as pc
from nonstationary_precip_tpu_torch.ops import chol_stream, linalg

torch.set_num_threads(1)


def _spd(n, seed=3):
    a = np.random.default_rng(seed).normal(size=(n, n))
    return a @ a.T / n + np.eye(n)


@pytest.mark.parametrize("n", [256, 512, 700])
def test_plain_matches_jax_streaming_kernel(n):
    a = _spd(n).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pc._forward_streaming2(jnp.asarray(a), p=256))
    got = chol_stream.streaming_cholesky_plain(torch.tensor(a)).numpy()
    assert got.dtype == np.float32 and got.shape == (n, n)
    np.testing.assert_allclose(got, ref, rtol=5e-3, atol=5e-4)
    np.testing.assert_array_equal(np.triu(got, 1), 0.0)


@pytest.mark.parametrize("n", [300, 512])
def test_plain_float64_matches_torch_cholesky(n):
    a = torch.tensor(_spd(n, seed=n))
    ref = torch.linalg.cholesky(a)
    got = chol_stream.streaming_cholesky_plain(a)
    assert float((got - ref).abs().max()) <= 1e-10 * float(ref.abs().max())
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))


def test_dispatch_thresholds_are_jaxs():
    assert (chol_stream.MIN_N, chol_stream.MAX_N, chol_stream.PANEL) == (pc.MIN_N_STREAM2, pc.MAX_N_STREAM,
                                                                          pc.SPANEL)
    for n, want in ((6143, False), (6144, True), (8192, True), (8193, False)):
        assert chol_stream.stream_eligible(torch.empty((n, n), device="meta")) is want, n
    assert not chol_stream.stream_eligible(torch.empty((8192, 8192), dtype=torch.float64, device="meta"))
    assert not chol_stream.stream_eligible(torch.empty((2, 8192, 8192), device="meta"))


def test_cpu_and_float64_never_reach_the_cuda_path(monkeypatch):
    """A CPU float32 matrix in the window takes the plain version, a
    float64 one the library; neither reaches the kernel's wrapper."""
    calls = []

    def no_cuda(mat):
        raise AssertionError("the CUDA wrapper was reached")

    monkeypatch.setattr(chol_stream, "streaming_cholesky_cuda", no_cuda)
    monkeypatch.setattr(chol_stream, "streaming_cholesky_plain", lambda mat: calls.append(mat.shape) or mat)
    cpu32 = torch.ones(1).expand(6144, 6144)  # in the window, no memory behind it
    chol, info = linalg.cholesky_ex(cpu32)
    assert calls == [(6144, 6144)] and chol is cpu32 and int(info) == 0
    small64 = torch.tensor(_spd(40))
    torch.testing.assert_close(linalg.cholesky(small64), torch.linalg.cholesky(small64), rtol=0, atol=0)
    assert calls == [(6144, 6144)]


def test_wrapper_refuses_without_cuda():
    with pytest.raises(ValueError, match="CUDA tensor"):
        chol_stream.streaming_cholesky_cuda(torch.eye(256))
    with pytest.raises(ValueError, match="no path"):
        chol_stream.streaming_cholesky(torch.empty((256, 256), device="meta"))


def test_failed_factor_is_nan_from_the_failing_block_and_safe_cholesky_retries(monkeypatch):
    """With the window lowered to N = 700, ``safe_cholesky`` runs the plain
    version: a non-SPD matrix comes back NaN from the failing 256-block on
    (finite before it), the retry refactors it with jitter, and the
    closed-form backward gives the library's gradient on an SPD input."""
    monkeypatch.setattr(chol_stream, "MIN_N", 256)
    bad = torch.tensor(_spd(700), dtype=torch.float32)
    bad[600, 600] = -1.0
    l = chol_stream.streaming_cholesky_plain(bad)
    assert bool(torch.isfinite(l[:, :512]).all()) and bool(torch.isnan(l[512:, 512:]).all())
    (out,), failed = linalg._cholesky_attempt(bad[None])
    assert bool(failed[0]) and bool(torch.isnan(out).any())
    rank_def = torch.tensor(np.ones((700, 700)), dtype=torch.float32)  # rank 1: needs jitter
    assert not bool(torch.isfinite(chol_stream.streaming_cholesky_plain(rank_def)).all())
    assert bool(torch.isfinite(linalg.safe_cholesky(rank_def)).all())

    a = torch.tensor(_spd(700, seed=9), requires_grad=True)
    w = torch.tensor(np.random.default_rng(1).normal(size=(700, 700)))
    torch.sum(w * linalg.safe_cholesky(a.float()).double()).backward()
    g = a.grad.clone()
    a.grad = None
    torch.sum(w * torch.linalg.cholesky(a.float()).double()).backward()
    assert float((g - a.grad).abs().max()) <= 1e-3 * float(a.grad.abs().max())
