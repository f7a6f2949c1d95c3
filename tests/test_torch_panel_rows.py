"""K3 on K2's walk (csrc/gibbs_matvec.cu, ``PanelElem``): its division-free
d = 2 pullback terms and its walk replayed in float32 numpy in the kernel's
order of operations, the source's one Gram·V walk, and K3's register tile
and column splits on it.

There is no card here, so the kernel cannot run; ``chip_smoke.py`` holds it
to its plain version and to float64 on the card.  The replay rounds every
operation to float32 as the kernel does, fused multiply-adds once (the
exact product and sum in float64, then one rounding), and takes rsqrt and
exp2 correctly rounded where the card uses the special-function unit's
``rsqrt.approx.ftz`` and ``ex2.approx.ftz`` (~2⁻²² each).

The element's terms and their error bounds, to first order in u = 2⁻²⁴,
with λ = ln 2 rounded to float32 (the kernel's ``kLn2``; its ``kTwoLn2`` is
2λ exactly), Δ_k = x_ik − x_jk and ss_k = ℓ_ik² + ℓ_jk²: the squared
lengthscales q = ℓ²·λ carry 2u, s_k = fma(ℓ_ik², λ, q_jk) = ss_k·λ 3u; rs =
rsqrt(s₀s₁) 1.5u and rs² 4u relative to 1/(s₀s₁), so h₀ = s₁·rs² = 1/s₀
carries 5u, and 1/(ss₀·λ) 8u: the factor s₁ cancels exactly.  Hence
  * λ·h_k·d_k, the kernel's d_k/ss_k, carries 9u (d_k = fl(Δ_k) adds u);
  * m_k = d_k²·h_k = Δ_k²/(ss_k·λ) carries 12u, so E_k = fma(m_k, 2λ, −1)
    is off from 2Δ_k²/ss_k − 1 by 12u·2Δ_k²/ss_k + u·|E_k|, and λ·h_k·E_k,
    the kernel's (2d_k²/ss_k − 1)/ss_k, by (24Δ_k²/ss_k + 9|E_k|)·u/ss_k;
  * the exponent m₀ + m₁ carries 13u, and λ's own rounding (u/2) makes
    2^−(m₀+m₁) = exp(−Q)·(1 + 13.5u·Q + u), Q = Σ Δ_k²/ss_k; the prefactor
    (n_i·n_j)·rs, with n_i = 2λ·√(ℓ_i0·ℓ_i1) and rs's 1/λ cancelling, carries
    10.5u; so K carries (12.5 + 13.5·Q)·u.
The test allows twice each bound (plus 2⁻¹²⁶ absolute in K, where an
element underflows).
"""

import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import K3_TOL
from nonstationary_precip_tpu.ops import pallas_matvec as pm
from nonstationary_precip_tpu_torch.kernels.gibbs import gibbs_gram_reference
from nonstationary_precip_tpu_torch.ops import matvec
from nonstationary_precip_tpu_torch.ops.cuda_build import CSRC

torch.set_num_threads(1)
U = 2.0**-24
F32 = np.float32
LAM, TWO_LAM = F32(0.693147180559945309), F32(1.386294361119890618)  # the kernel's kLn2, kTwoLn2


def _fma(a, b, c):
    """fmaf: the exact product and sum, one rounding to float32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(F32)


def elem_terms(xi, li, xj, lj):
    """``PanelElem::pull2``'s element for rows (xi, li) against columns
    (xj, lj), float32, broadcast: (K, h₀, h₁, d₀, d₁, m₀, m₁, rs, e, n_i·n_j)."""
    ai0, ai1 = li[..., 0] * li[..., 0], li[..., 1] * li[..., 1]
    ni = np.sqrt(li[..., 0] * li[..., 1]) * TWO_LAM
    qj0, qj1 = (lj[..., 0] * lj[..., 0]) * LAM, (lj[..., 1] * lj[..., 1]) * LAM
    nj = np.sqrt(lj[..., 0] * lj[..., 1])
    s0, s1 = _fma(ai0, LAM, qj0), _fma(ai1, LAM, qj1)
    rs = (1.0 / np.sqrt((s0 * s1).astype(np.float64))).astype(F32)
    r2 = rs * rs
    d0, d1 = xi[..., 0] - xj[..., 0], xi[..., 1] - xj[..., 1]
    h0, h1 = s1 * r2, s0 * r2
    m0, m1 = (d0 * d0) * h0, (d1 * d1) * h1
    e = np.exp2(-(m0 + m1).astype(np.float64)).astype(F32)
    nij = ni * nj
    return (nij * rs) * e, h0, h1, d0, d1, m0, m1, rs, e, nij


def _payload(rng, n, spread, d=2):
    x = rng.uniform(-2, 2, size=(n, d)).astype(F32)
    ell = np.exp(spread * rng.normal(size=(n, d))).astype(F32)
    return x, ell


@pytest.mark.parametrize("spread", [0.0, 0.3, 1.0], ids=["init", "trained", "wide"])
def test_pullback_terms_meet_their_float64_bounds(spread):
    """Over 300 × 280 pairs at ℓ = 1, exp(0.3·N(0, 1)) and exp(N(0, 1)):
    the element and its two division-free pullback terms, each within
    twice its first-order bound (module docstring) of float64's."""
    rng = np.random.default_rng(21 + int(10 * spread))
    x1, l1 = _payload(rng, 300, spread)
    x2, l2 = _payload(rng, 280, spread)
    k, h0, h1, d0, d1, m0, m1, *_ = elem_terms(x1[:, None], l1[:, None], x2[None], l2[None])
    t = [torch.from_numpy(a.astype(np.float64)) for a in (x1, l1, x2, l2)]
    k64 = gibbs_gram_reference(*t).numpy()
    xd, ld = x1.astype(np.float64), l1.astype(np.float64)
    xc, lc = x2.astype(np.float64), l2.astype(np.float64)
    delta = xd[:, None, :] - xc[None, :, :]
    ss = ld[:, None, :] ** 2 + lc[None, :, :] ** 2
    q = (delta**2 / ss).sum(-1)
    assert np.all(np.isfinite(k)) and np.all(k >= 0)
    assert (np.abs(k - k64) / ((25 + 27 * q) * U * k64 + 2.0**-126)).max() <= 1.0
    lam = float(LAM)
    for kk, h, dk, mk in ((0, h0, d0, m0), (1, h1, d1, m1)):
        dss, ssk = delta[..., kk] / ss[..., kk], ss[..., kk]
        tx = lam * h.astype(np.float64) * dk.astype(np.float64)
        assert (np.abs(tx - dss) <= 18 * U * np.abs(dss) + 1e-300).all()
        two = 2 * delta[..., kk] ** 2 / ssk
        tt = lam * h.astype(np.float64) * _fma(mk, TWO_LAM, F32(-1.0)).astype(np.float64)
        bound = 2 * (12 * two + 9 * np.abs(two - 1)) * U / ssk  # 24Δ²/ss = 12·two
        assert (np.abs(tt - (two - 1) / ssk) <= bound + 1e-300).all()


def replay_walk(xr, lr, f1, xc, lc, f2, splits, per):
    """K3's output for rows (xr, lr, f1) against columns (xc, lc, f2) as
    the kernel forms it: per column slice, each row's five sums over the
    slice's columns in order (``pull2``), the slices added in order and the
    closed forms applied with λ (``panel_grads_finish_kernel``).  Rows are
    independent, so the thread's register tile of rows does not enter."""
    nr, n = xr.shape[0], xc.shape[0]
    parts = []
    for s in range(splits):
        acc = [np.zeros(nr, F32) for _ in range(5)]
        for j in range(s * per, min(n, (s + 1) * per)):
            _, h0, h1, d0, d1, m0, m1, rs, e, nij = elem_terms(xr, lr, xc[j], lc[j])
            w = np.zeros(nr, F32)
            for f in range(f1.shape[1]):
                w = _fma(f1[:, f], f2[j, f], w)
            p = ((w * nij) * rs) * e
            acc[0] = acc[0] + p
            g0, g1 = p * h0, p * h1
            acc[1] = _fma(g0, d0, acc[1])
            acc[2] = _fma(g1, d1, acc[2])
            acc[3] = _fma(g0, _fma(m0, TWO_LAM, F32(-1.0)), acc[3])
            acc[4] = _fma(g1, _fma(m1, TWO_LAM, F32(-1.0)), acc[4])
        parts.append(acc)
    tot = parts[0]
    for acc in parts[1:]:
        tot = [a + b for a, b in zip(tot, acc)]
    sp = tot[0]
    gx = np.stack([F32(-2.0) * LAM * tot[1], F32(-2.0) * LAM * tot[2]], 1)
    gl = np.stack([sp / (F32(2.0) * lr[:, k]) + lr[:, k] * (LAM * tot[3 + k]) for k in range(2)], 1)
    assert gx.dtype == F32 and gl.dtype == F32
    return gx, gl, sp


def test_replayed_walk_matches_jax_k3_rows():
    """200 of 300 rows against all 300 columns, R 3: the replay (at the
    splits the wrapper gives on a 132-SM card) against the JAX kernel's row
    form in interpret mode and against the plain version, each output
    within K3_TOL of its largest entry."""
    rng = np.random.default_rng(7)
    x, ell = _payload(rng, 300, 0.3)
    a, s, z = (rng.normal(size=shape).astype(F32) for shape in ((300,), (300, 3), (300, 3)))
    j = [jnp.asarray(v) for v in (x, ell, a, s, z)]
    with pltpu.force_tpu_interpret_mode():
        ref = pm.packed_gibbs_panel_grads_rows(*(v[:200] for v in j), *j)
    tt = [torch.from_numpy(v) for v in (x, ell, a, s, z)]
    f1, _ = matvec.cotangent_factors(tt[2][:200], tt[3][:200], tt[4][:200])
    _, f2 = matvec.cotangent_factors(*tt[2:])
    splits, per = matvec.column_splits(200, 300, 1, 132, matvec.ROWS, matvec.K3_BLOCKS_PER_SM)
    got = replay_walk(x[:200], ell[:200], f1.numpy(), x, ell, f2.numpy(), splits, per)
    plain = matvec.packed_gibbs_panel_grads_rows_plain(*(v[:200] for v in tt), *tt)
    for g, r, p in zip(got, ref, plain):
        r, p = np.asarray(r), p.numpy()
        assert np.abs(g - r).max() <= K3_TOL * np.abs(r).max()
        assert np.abs(g - p).max() <= K3_TOL * np.abs(p).max()


def test_source_has_one_walk_that_k3_instantiates():
    """K3 is the walk's ``PanelElem`` policy: its C entry launches
    ``gibbs_rows_kernel`` through ``launch_matvec<PanelElem`` and then the
    fixed-order finish, two launches; the one-row-a-thread kernel is gone;
    the element divides nowhere and reads its reciprocals off rs²."""
    text = matvec.SOURCE.read_text()
    assert "gibbs_panel_grads_kernel" not in text and "stage_cols" not in text
    assert "struct PanelElem" in text and "launch_matvec<PanelElem, D, " in text
    entry = text[text.index("int gibbs_panel_grads("):]
    assert entry.count("<<<") == 1 and "panel_fb<" in entry and "panel_grads_finish_kernel<<<" in entry
    pull = text[text.index("__device__ static void pull2("):text.index("// Blocks an SM the registers")]
    code = "\n".join(line.split("//")[0] for line in pull.splitlines())
    assert "/" not in code and "const float h0 = s1 * r2;" in code and "rsqrt_approx" in code


def _constant(text, name):
    return int(re.search(rf"constexpr int {name} = (\w+);", text).group(1))


def test_k3_walk_constants_are_the_kernels():
    """ROWS and K3_ROWS_PER_THREAD are the source's kK3Rows and
    kK3RowsPerThread (256 threads a block), K3_COLS its kK3Cols and
    MAX_FACTORS its kMaxF; the wrapper cuts K3's columns for ROWS-row
    blocks at K3_BLOCKS_PER_SM; the replay's λ is the kernel's (its d = 2
    element's, csrc/gibbs_elem.cuh)."""
    text = matvec.SOURCE.read_text()
    elem = (CSRC / "gibbs_elem.cuh").read_text()
    threads, per = _constant(text, "kK2Threads"), _constant(text, "kK3RowsPerThread")
    assert "constexpr int kK3Rows = kK2Threads * kK3RowsPerThread;" in text
    assert (threads * per, per) == (matvec.ROWS, matvec.K3_ROWS_PER_THREAD)
    assert (_constant(text, "kK3Cols"), _constant(text, "kMaxF")) == (matvec.K3_COLS, matvec.MAX_FACTORS)
    assert "ROWS, K3_BLOCKS_PER_SM)" in inspect.getsource(matvec._panel_grads_cuda)
    for name, value in (("kLn2", LAM), ("kTwoLn2", TWO_LAM)):
        assert F32(float(re.search(rf"constexpr float {name} = ([\d.]+)f;", elem).group(1))) == value
    assert TWO_LAM == 2 * LAM


@pytest.mark.parametrize("n_rows,n_cols", [(16384, 16384), (4096, 16384), (1000, 1500), (40, 64)])
def test_k3_column_splits_cover_the_columns(n_rows, n_cols):
    """Under K3's ROWS-row blocks at K3_BLOCKS_PER_SM: whole passes per
    split, every column covered, no empty split, and at least half the
    blocks meant unless every pass is its own split."""
    splits, per = matvec.column_splits(n_rows, n_cols, 1, 132, matvec.ROWS, matvec.K3_BLOCKS_PER_SM)
    assert per % matvec.COLS == 0 and per % matvec.K3_COLS == 0
    assert splits * per >= n_cols > (splits - 1) * per
    blocks = -(-n_rows // matvec.ROWS) * splits
    assert 2 * blocks >= matvec.K3_BLOCKS_PER_SM * 132 or splits == -(-n_cols // matvec.COLS)


def test_k3_operation_counts():
    """The bound's counts at d = 2 are the element as the walk computes it
    (17 FP32-lane operations for P given W, the cotangent's 2(1 + 2R), P's
    sum and 7 a dim: 66 at R = 8; rsqrt and ex2 on the SFU); the per-dim
    count it replaced stays beside it (83 at R = 8); other d keep it."""
    assert matvec.panel_grads_ops(16384, 16384, 2, 8) == 16384 * 16384 * 66
    assert matvec.panel_grads_ops_per_dim(16384, 16384, 2, 8) == 16384 * 16384 * 83
    assert matvec.panel_grads_sfu_ops(16384, 16384, 2) == 2 * 16384 * 16384
    assert matvec.panel_grads_ops(100, 50, 3, 4) == matvec.panel_grads_ops_per_dim(100, 50, 3, 4)
    assert matvec.panel_grads_sfu_ops(100, 50, 3) == 100 * 50 * 7
