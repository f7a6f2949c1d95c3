"""K6's d = 2 element on K2's walk (csrc/gibbs_matvec.cu, ``RbfElem``)
replayed in float32 numpy in the kernel's order of operations, the
source's one Gram·V walk, and K6's register tile and column splits on it.

There is no card here, so the kernel cannot run.  The replay rounds every
operation to float32 as the kernel does: the row's z and each column's z
scaled by c = √(log₂e / 2) (the source's ``kRbfScale``), the two
differences, d₀² and one fused multiply-add (the exact product and sum in
float64, then one rounding), and exp2 of the negation correctly rounded,
where the card uses the special-function unit's ``ex2.approx.ftz`` (~2⁻²²):
``chip_smoke.py`` holds the kernel itself to float64 on the card.

The element's error bound, to first order in u = 2⁻²⁴, relative to
K = exp(−½‖z_i − z_j‖²) = 2^−Q, Q = c²‖z_i − z_j‖²: the scaled payloads
carry c's rounding and their own (u each), so each difference is off by at
most 2u|c Δz_k| + c·u(|z_ik| + |z_jk|); the square and the fused add add
2u·Q, the differences' errors 4u·Q + 2c²u·S with S = Σ_k |Δz_k|(|z_ik| +
|z_jk|); 2^−q turns an error e in q into ln 2·e relative, plus u for its own
rounding.  So |K − K₆₄| ≤ (u + ln 2·(6u·Q + 2c²u·S))·K; the test allows
twice each term, plus 2⁻¹²⁶ where an element underflows.
"""

import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nonstationary_precip_tpu.ops import pallas_matvec as pm
from nonstationary_precip_tpu_torch.ops import matvec

torch.set_num_threads(1)
U = 2.0**-24
F32 = np.float32
C = F32(0.849321800288019111)  # the kernel's kRbfScale
RTOL, ATOL = 2e-5, 2e-4  # tests/test_torch_rbf_matvec.py's band against the JAX kernel


def replay_rbf_d2(z1, z2):
    """K(z1, z2) (N1, N2) in float32 as ``RbfElem`` forms it at d = 2:
    c·z once a row and once a column, then d_k = cz_ik − cz_jk,
    q = fma(d₁, d₁, d₀·d₀), K = 2⁻q."""
    r, c = z1 * C, z2 * C
    d0 = r[:, 0, None] - c[None, :, 0]
    d1 = r[:, 1, None] - c[None, :, 1]
    q = (d1.astype(np.float64) * d1.astype(np.float64) + (d0 * d0).astype(np.float64)).astype(F32)
    return np.exp2(-q.astype(np.float64)).astype(F32)


def _payload(rng, n, scale):
    """z = x/ℓ: the experiment's inputs lie in about [−2, 2]², so z spans
    ±2/ℓ; ``scale`` plays 1/ℓ."""
    return (rng.uniform(-2, 2, size=(n, 2)) * scale).astype(F32)


@pytest.mark.parametrize("scale", [1.0, 3.0, 8.0], ids=["ell1", "ell1/3", "ell1/8"])
def test_element_meets_its_float64_bound(scale):
    """Over 300 × 280 pairs at ℓ = 1, 1/3 and 1/8: every element within its
    first-order bound of float64's (twice each term), plus 2⁻¹²⁶ absolute
    where it underflows; finite and in [0, 1]."""
    rng = np.random.default_rng(5 + int(scale))
    z1, z2 = _payload(rng, 300, scale), _payload(rng, 280, scale)
    k = replay_rbf_d2(z1, z2).astype(np.float64)
    a, b = z1.astype(np.float64), z2.astype(np.float64)
    dz = a[:, None, :] - b[None, :, :]
    ref = np.exp(-0.5 * (dz**2).sum(-1))
    q = float(C) ** 2 * (dz**2).sum(-1)
    s = (np.abs(dz) * (np.abs(a)[:, None, :] + np.abs(b)[None, :, :])).sum(-1)
    bound = 2 * (U + np.log(2) * (6 * U * q + 2 * float(C) ** 2 * U * s)) * ref + 2.0**-126
    assert np.all(np.isfinite(k)) and np.all((k >= 0) & (k <= 1))
    ratio = np.abs(k - ref) / bound
    assert ratio.max() <= 1.0, ratio.max()


def test_scale_is_the_exponent_base_change():
    """c² = log₂e / 2 to float32's rounding, so 2^(−c²q) = exp(−q/2)."""
    assert abs(float(C) ** 2 - np.log2(np.e) / 2) <= 2 * U * np.log2(np.e) / 2


@pytest.mark.parametrize("n1,n2,r", [(40, 64, 1), (130, 200, 9)])
def test_replayed_matvec_matches_jax_k6(n1, n2, r):
    """K·V from the replayed element (f32, summed over the columns in f64 and
    rounded) against the JAX kernel's ``make_rbf_matvec`` in interpret mode,
    in tests/test_torch_rbf_matvec.py's band."""
    rng = np.random.default_rng(n1 + r)
    x1 = rng.uniform(-2, 2, size=(n1, 2)).astype(F32)
    x2 = rng.uniform(-2, 2, size=(n2, 2)).astype(F32)
    ell = np.array([0.6, 1.3], F32)
    v = rng.normal(size=(n2, r)).astype(F32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pm.make_rbf_matvec(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(ell))(jnp.asarray(v)))
    z1, z2 = (torch.from_numpy(x1) / torch.from_numpy(ell)).numpy(), (torch.from_numpy(x2) / torch.from_numpy(ell)).numpy()
    got = (replay_rbf_d2(z1, z2).astype(np.float64) @ v.astype(np.float64)).astype(F32)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_source_has_one_gram_v_walk():
    """K2, K6 and K3 are one walk, ``gibbs_rows_kernel`` with an element
    policy: no ``rbf_matvec_kernel``, no ``bool kK2`` switch, no K3 kernel
    of its own; the C entries launch it with ``GibbsElem``, ``RbfElem``
    and ``PanelElem``; the RBF scale is the replay's.  K2's and K6's
    tensor-core contraction modes ('default', 'high3') are the one other
    walk, ``gibbs_mma_kernel``, on the same element policies."""
    text = matvec.SOURCE.read_text()
    kernels = set(re.findall(r"__global__[^;{]*?\b(\w+_kernel)\(", text, flags=re.S))
    assert kernels == {"gibbs_rows_kernel", "gibbs_mma_kernel", "sum_splits_kernel",
                       "panel_grads_finish_kernel"}, kernels
    assert "run_mma<GibbsElem>(" in text and "run_mma<RbfElem>(" in text
    assert "rbf_matvec_kernel" not in text and "bool kK2" not in text and "rbf_elem" not in text
    assert "template <class Elem, int D, int RB>" in text
    assert "run_matvec<GibbsElem>(" in text and "run_matvec<RbfElem>(" in text
    assert "launch_matvec<PanelElem, D, " in text
    assert F32(float(re.search(r"constexpr float kRbfScale = ([\d.]+)f;", text).group(1))) == C


def _constant(text, name):
    return int(re.search(rf"constexpr int {name} = (\w+);", text).group(1))


def test_k6_walk_constants_are_the_kernels():
    """K6_ROWS_PER_THREAD and K6_ROWS are the source's kK6RowsPerThread and
    kK6Rows (threads × rows a thread), RbfElem's; the wrapper cuts K6's
    columns for K6_ROWS-row blocks at K6_BLOCKS_PER_SM."""
    text = matvec.SOURCE.read_text()
    threads, per = _constant(text, "kK2Threads"), _constant(text, "kK6RowsPerThread")
    assert "constexpr int kK6Rows = kK2Threads * kK6RowsPerThread;" in text
    assert "static constexpr int kRowsPerThread = kK6RowsPerThread;" in text
    assert (threads * per, per) == (matvec.K6_ROWS, matvec.K6_ROWS_PER_THREAD)
    assert "K6_ROWS, K6_BLOCKS_PER_SM)" in inspect.getsource(matvec.rbf_gram_matvec_cuda)


@pytest.mark.parametrize("n_rows,n_cols,groups", [(16384, 16384, 1), (2048, 16384, 4), (1000, 1500, 5),
                                                  (40, 64, 1)])
def test_k6_column_splits_cover_the_columns(n_rows, n_cols, groups):
    """Under K6's K6_ROWS-row blocks at K6_BLOCKS_PER_SM: whole COLS-wide
    passes per split, every column covered, no empty split, and at least half
    the blocks meant unless every pass is its own split."""
    splits, per = matvec.column_splits(n_rows, n_cols, groups, 132, matvec.K6_ROWS, matvec.K6_BLOCKS_PER_SM)
    assert per % matvec.COLS == 0 and splits * per >= n_cols > (splits - 1) * per
    blocks = -(-n_rows // matvec.K6_ROWS) * groups * splits
    assert 2 * blocks >= matvec.K6_BLOCKS_PER_SM * 132 or splits == -(-n_cols // matvec.COLS)
