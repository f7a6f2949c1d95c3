"""K9 (csrc/gibbs_gram.cu) on the CPU: its element replayed in float32 numpy
and held to the JAX kernel and to float64, its store map, and its source's
constants.

There is no card here, so the kernel cannot run (``chip_smoke.py`` holds it
to float64 and, at d = 2, bit for bit to K2 on the card).  At d = 2 its
element is csrc/gibbs_elem.cuh's ``d2_elem``, K2's, replayed by
tests/gibbs_d2_replay.py and held to float64 within the bound derived in
tests/test_torch_matvec_d2.py; at other d it is the header's per-dim
``gibbs_elem`` (K2's and K3's at d ≠ 2): per dim ss_k = l_ik² + l_jk²,
1/ss_k by IEEE division, sqrtf(2·(l_ik·l_jk)·(1/ss_k)) into a running
product and (x_ik − x_jk)²·(1/ss_k) into a running sum, then
product·expf(−sum).  Its float64 bound, to first order in u = 2⁻²⁴
relative to K, with Q the exponent: ss_k carries 2u, 1/ss_k 3u, the ratio
5u and its square root 3.5u, so the product (4.5d − 1)·u; each quadratic
term 7u and the running sum (d − 1)·u more, so (6 + d)·u·Q, and expf's
result that plus 2u; one more u for the product: (4.5d + 2 + (6 + d)·Q)·u.
The test allows (6d + 4 + (8 + 2d)·Q)·u·K, plus 2⁻¹²⁶ where an element
underflows.  Against the JAX kernel in Pallas interpret mode (as
tests/test_pallas.py runs it), both in float32: rtol 2e-5, atol 1e-7 (an
element whose two bounds exceed 2e-5 relative has Q > 13, so K < 1e-5 and
its error < 1e-9).
"""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import nonstationary_precip_tpu.ops.pallas_gram as pg
from chip_smoke import PEAK_BYTES, PEAK_F32
from gibbs_d2_replay import F32, bound_ratio, replay_d2
from nonstationary_precip_tpu_torch.kernels.gibbs import gibbs_gram_reference
from nonstationary_precip_tpu_torch.ops import gibbs_gram, matvec
from nonstationary_precip_tpu_torch.ops.cuda_build import CSRC

torch.set_num_threads(1)
U = 2.0**-24
RTOL, ATOL = 2e-5, 1e-7


def _payload(rng, n, d, spread=0.3):
    x = rng.uniform(-2, 2, size=(n, d)).astype(F32)
    ell = np.exp(spread * rng.normal(size=(n, d))).astype(F32)
    return x, ell


def replay_per_dim(x1, l1, x2, l2):
    """K(x1, x2) in float32 by ``gibbs_elem``, in its order of operations,
    IEEE division and square root correctly rounded as on the card; expf
    through float64."""
    n1, d = x1.shape
    pref = np.ones((n1, x2.shape[0]), F32)
    quad = np.zeros_like(pref)
    for k in range(d):
        li, lj = l1[:, k, None], l2[None, :, k]
        ss = li * li + lj * lj
        inv = F32(1.0) / ss
        dk = x1[:, k, None] - x2[None, :, k]
        pref = pref * np.sqrt((F32(2.0) * (li * lj)) * inv)
        quad = quad + (dk * dk) * inv
    return pref * np.exp(-quad.astype(np.float64)).astype(F32)


def _jax_gram(*args):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pg._forward(*(jnp.asarray(a) for a in args)))


@pytest.mark.parametrize("spread", [0.0, 0.3, 1.0], ids=["init", "trained", "wide"])
def test_d2_element_meets_its_float64_bound_at_the_paths_shapes(spread):
    """K9's d = 2 element over the slice's 394 × 316 field Gram and a ragged
    130 × 257, at ℓ = 1, exp(0.3·N(0, 1)) and exp(N(0, 1)): every element
    within test_torch_matvec_d2.py's (24 + 24·Q)·u of float64's."""
    rng = np.random.default_rng(29 + int(10 * spread))
    for n1, n2 in ((394, 316), (130, 257)):
        x1, l1 = _payload(rng, n1, 2, spread)
        x2, l2 = _payload(rng, n2, 2, spread)
        k = replay_d2(x1, l1, x2, l2)
        assert np.all(np.isfinite(k)) and np.all(k >= 0.0)
        ratio = bound_ratio(k, x1, l1, x2, l2)
        assert ratio.max() <= 1.0, (n1, n2, ratio.max())


def test_d2_element_matches_jax_gibbs_gram_pallas():
    """The replayed d = 2 element against the JAX kernel's own per-dim form
    in interpret mode, both f32, on a ragged 130 × 257 pair and the square
    K(x, x) of 200 points (its diagonal: no special case on either side)."""
    rng = np.random.default_rng(31)
    x1, l1 = _payload(rng, 130, 2)
    x2, l2 = _payload(rng, 257, 2)
    np.testing.assert_allclose(replay_d2(x1, l1, x2, l2), _jax_gram(x1, l1, x2, l2), rtol=RTOL, atol=ATOL)
    x, ell = _payload(rng, 200, 2)
    k = replay_d2(x, ell, x, ell)
    np.testing.assert_allclose(k, _jax_gram(x, ell, x, ell), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.diag(k), 1.0, rtol=4e-6)


@pytest.mark.parametrize("d", [1, 3])
def test_per_dim_element_matches_jax_and_float64(d):
    """The generic element at d = 1 and 3 (``gibbs_elem``) against the JAX
    kernel in interpret mode and against float64 within
    (6d + 4 + (8 + 2d)·Q)·u."""
    rng = np.random.default_rng(37 + d)
    x1, l1 = _payload(rng, 70, d)
    x2, l2 = _payload(rng, 90, d)
    k = replay_per_dim(x1, l1, x2, l2)
    np.testing.assert_allclose(k, _jax_gram(x1, l1, x2, l2), rtol=RTOL, atol=ATOL)
    t = [torch.from_numpy(a.astype(np.float64)) for a in (x1, l1, x2, l2)]
    ref = gibbs_gram_reference(*t).numpy()
    ss = t[1][:, None, :] ** 2 + t[3][None, :, :] ** 2
    q = (((t[0][:, None, :] - t[2][None, :, :]) ** 2) / ss).sum(-1).numpy()
    ratio = np.abs(k - ref) / ((6 * d + 4 + (8 + 2 * d) * q) * U * ref + 2.0**-126)
    assert ratio.max() <= 1.0, ratio.max()


def _constants():
    text = gibbs_gram.SOURCE.read_text()
    c = {name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
         for name in ("kThreads", "kColsPerThread", "kColThreads", "kRowsPerThread")}
    c["kRowThreads"] = c["kThreads"] // c["kColThreads"]
    c["kTileN"] = c["kColThreads"] * c["kColsPerThread"]
    c["kTileM"] = c["kRowThreads"] * c["kRowsPerThread"]
    return text, c


def _store_width(n2: int, base_align: int = 16) -> int:
    """Floats a store, as the C entry picks them: 4 where the rows stay
    16-byte aligned, 2 where they stay 8-byte aligned, else 1."""
    if n2 % 4 == 0 and base_align % 16 == 0:
        return 4
    if n2 % 2 == 0 and base_align % 8 == 0:
        return 2
    return 1


def test_tile_constants_are_the_sources():
    """A 256-thread block, 16 threads across 64 columns (a float4 each, so a
    warp writes two whole 256-byte rows), 8 rows a thread: 128 × 64 tiles,
    200 blocks at 1280² (at least one an SM, where 128² tiles gave 100); the
    store-width rule is the replay's; both elements are the header's,
    compiled by K9 and K2 alike, and defined nowhere else."""
    text, c = _constants()
    assert (c["kThreads"], c["kColsPerThread"], c["kColThreads"], c["kRowsPerThread"]) == (256, 4, 16, 8)
    assert (c["kTileM"], c["kTileN"]) == (128, 64) and 32 % c["kColThreads"] == 0
    assert math.ceil(1280 / c["kTileM"]) * math.ceil(1280 / c["kTileN"]) == 200 >= 132
    assert "if (n2 % 4 == 0 && a % 16 == 0) gibbs_gram_kernel<D, 4>" in text
    assert "else if (n2 % 2 == 0 && a % 8 == 0) gibbs_gram_kernel<D, 2>" in text
    header = (CSRC / "gibbs_elem.cuh").read_text()
    walk = matvec.SOURCE.read_text()
    assert "gibbs::d2_elem(f, xq[v], cn[v])" in text and "return gibbs::d2_elem(r, c.xq, c.n);" in walk
    assert "gibbs::gibbs_elem<D>(xi, li, xj[v], lj[v], d, diff, inv_ss)" in text and "gibbs_elem<D>(" in walk
    for name in ("float rsqrt_approx(", "float exp2_approx(", "constexpr float kLn2", "D2Row d2_row(",
                 "float gibbs_elem("):
        assert header.count(name) == 1 and name not in text and name not in walk, name


@pytest.mark.parametrize("n1,n2,width", [(1280, 1280, 4), (394, 394, 2), (256, 316, 4), (394, 316, 4),
                                         (131, 130, 2), (130, 257, 1)])
def test_store_map_writes_every_element_once(n1, n2, width):
    """The kernel's stores replayed over its grid: block (bx, by), thread
    (tr, tc), row u, chunk h of ``width`` floats: every element of the
    n1 × n2 output written exactly once, each store inside its row and
    aligned to its width in the output."""
    _, c = _constants()
    assert _store_width(n2) == width
    cpt, rt = c["kColsPerThread"], c["kRowThreads"]
    by, bx, tr, tc, u = np.meshgrid(np.arange(-(-n1 // c["kTileM"])), np.arange(-(-n2 // c["kTileN"])),
                                    np.arange(rt), np.arange(c["kColThreads"]), np.arange(c["kRowsPerThread"]),
                                    indexing="ij")
    col = (bx * c["kTileN"] + cpt * tc).ravel()
    row = (by * c["kTileM"] + tr + u * rt).ravel()
    live = (col < n2) & (row < n1)  # the thread's return and its row loop's break
    count = np.zeros(n1 * n2, np.int64)
    for h in range(0, cpt, width):
        start = col + h
        s = live & (start < n2)  # the chunk loop's break
        flat = row[s] * n2 + start[s]
        assert np.all(start[s] + width <= n2) and np.all(flat % width == 0)
        for v in range(width):
            np.add.at(count, flat + v, 1)
    assert np.all(count == 1), (count.min(), count.max())


def test_bound_counts():
    """K9's bound at d = 2: 15 f32 operations an element (d2_elem, an FMA
    as 2: K2's count) and the four payloads read once and the Gram written
    once; bytes bound it at 1280² (1.96 µs against 0.37)."""
    n = 1280
    assert gibbs_gram.gram_ops(n, n, 2) == 15 * n * n == n * n * matvec._k2_elem_ops(2)
    assert gibbs_gram.gram_ops(10, 20, 3) == 10 * 20 * (13 * 3 + 3) == 10 * 20 * matvec._k2_elem_ops(3)
    assert gibbs_gram.gram_bytes(n, n, 2) == 4 * (2 * 2 * 2 * n + n * n)
    t_bytes = gibbs_gram.gram_bytes(n, n, 2) / PEAK_BYTES * 1e6
    t_ops = gibbs_gram.gram_ops(n, n, 2) / PEAK_F32 * 1e6
    assert 1.9 < t_bytes < 2.0 and t_ops < 0.4
