"""K2's d = 2 element (csrc/gibbs_elem.cuh's ``d2_elem``, on K2's walk in
csrc/gibbs_matvec.cu) replayed in float32 numpy in the kernel's order of
operations (tests/gibbs_d2_replay.py), and its walk's column splits.

There is no card here, so the kernel cannot run: ``chip_smoke.py`` holds
the kernel itself to float64 on the card.

The element's error bound, to first order in u = 2⁻²⁴, relative to K, with
Q = quadnum / p the exponent: the scaled squares q = l²·ln 2 carry 3u (two
roundings and ln 2's), the sums s_k = fma(l_ik², ln 2, q_jk) 4u, p = s₀s₁ 9u, rs 5.5u, rs² 12u;
quadnum (a square, a product and one fused add of positive terms) 9u, so
y = quadnum·rs² carries 22u and 2⁻ʸ carries 22u·Q + u; the prefactor
(n_i n_j)·rs, 15u with 2 ln 2's rounding.  So |K − K₆₄| ≤ (16 + 22·Q)·u·K
to first order; the test allows (24 + 24·Q)·u·K, plus 2⁻¹²⁶ where an
element underflows.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gibbs_d2_replay import LN2, TWO_LN2, bound_ratio, replay_d2
from nonstationary_precip_tpu.ops import pallas_matvec as pm
from nonstationary_precip_tpu_torch.ops import matvec
from nonstationary_precip_tpu_torch.ops.cuda_build import CSRC

torch.set_num_threads(1)
F32 = np.float32
RTOL, ATOL = 2e-5, 2e-4  # tests/test_torch_matvec.py's band against the JAX kernel


def _payload(rng, n, spread):
    x = rng.uniform(-2, 2, size=(n, 2)).astype(F32)
    ell = np.exp(spread * rng.normal(size=(n, 2))).astype(F32)
    return x, ell


@pytest.mark.parametrize("spread", [0.0, 0.3, 1.0], ids=["init", "trained", "wide"])
def test_element_meets_its_float64_bound(spread):
    """ℓ = 1 (the gate's init pose), ℓ = exp(0.3·N(0, 1)) as chip_smoke.py's
    trained-like payloads, and exp(N(0, 1)), over 300 × 280 pairs: every
    element within (24 + 24·Q)·u of float64's, relative to it (plus 2⁻¹²⁶
    absolute, where it underflows)."""
    rng = np.random.default_rng(11 + int(10 * spread))
    x1, l1 = _payload(rng, 300, spread)
    x2, l2 = _payload(rng, 280, spread)
    k = replay_d2(x1, l1, x2, l2).astype(np.float64)
    assert np.all(np.isfinite(k)) and np.all(k >= 0.0)
    ratio = bound_ratio(k, x1, l1, x2, l2)
    assert ratio.max() <= 1.0, ratio.max()


@pytest.mark.parametrize("n1,n2,r", [(40, 64, 1), (130, 200, 9)])
def test_replayed_matvec_matches_jax_k2(n1, n2, r):
    """K·V from the replayed element (f32, summed over the columns in f64 and
    rounded) against the JAX kernel's own d = 2 path in interpret mode, in
    tests/test_torch_matvec.py's band."""
    rng = np.random.default_rng(n1 + r)
    x1, l1 = _payload(rng, n1, 0.3)
    x2, l2 = _payload(rng, n2, 0.3)
    v = rng.normal(size=(n2, r)).astype(F32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pm.gibbs_gram_matvec(*(jnp.asarray(a) for a in (x1, l1, x2, l2, v))))
    got = (replay_d2(x1, l1, x2, l2).astype(np.float64) @ v.astype(np.float64)).astype(F32)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def _constant(text, name):
    return int(re.search(rf"constexpr int {name} = (\w+);", text).group(1))


def test_walk_constants_are_the_kernels():
    """K2_ROWS, K2_ROWS_PER_THREAD and COLS are the source's kK2Rows (its
    threads × rows a thread), kK2RowsPerThread and kCols; the element's ln 2
    constants (csrc/gibbs_elem.cuh's) are the replay's."""
    text = matvec.SOURCE.read_text()
    elem = (CSRC / "gibbs_elem.cuh").read_text()
    threads, per = _constant(text, "kK2Threads"), _constant(text, "kK2RowsPerThread")
    assert "constexpr int kK2Rows = kK2Threads * kK2RowsPerThread;" in text
    assert (threads * per, per, _constant(text, "kCols")) == (matvec.K2_ROWS, matvec.K2_ROWS_PER_THREAD, matvec.COLS)
    for name, value in (("kLn2", LN2), ("kTwoLn2", TWO_LN2)):
        assert F32(float(re.search(rf"constexpr float {name} = ([\d.]+)f;", elem).group(1))) == value


@pytest.mark.parametrize("n_rows,n_cols,groups", [(16384, 16384, 1), (1000, 1500, 5), (2048, 16384, 1),
                                                  (40, 64, 1), (16384, 2048, 4)])
def test_k2_column_splits_cover_the_columns(n_rows, n_cols, groups):
    """Under K2's K2_ROWS-row blocks: whole COLS-wide passes per split, every
    column covered, no empty split, and at least half the blocks the card is
    meant to hold unless every pass is its own split."""
    splits, per = matvec.column_splits(n_rows, n_cols, groups, 132, matvec.K2_ROWS)
    assert per % matvec.COLS == 0 and splits * per >= n_cols > (splits - 1) * per
    blocks = -(-n_rows // matvec.K2_ROWS) * groups * splits
    assert 2 * blocks >= matvec.BLOCKS_PER_SM * 132 or splits == -(-n_cols // matvec.COLS)


def test_k2_operation_counts():
    """The bound's counts at d = 2 are the element as the kernel computes it
    (15 FP32-lane operations, an FMA as 2, plus the contraction's 2R; its
    rsqrt and ex2 counted once, on the SFU); other d keep the per-dim
    tile."""
    assert matvec.matvec_ops(16384, 16384, 2, 9) == 16384 * 16384 * (15 + 18)
    assert matvec.matvec_sfu_ops(16384, 16384, 2) == 2 * 16384 * 16384
    assert matvec.matvec_ops(100, 50, 3, 4) == 100 * 50 * (13 * 3 + 3 + 8)
    assert matvec.matvec_sfu_ops(100, 50, 3) == 100 * 50 * 7
