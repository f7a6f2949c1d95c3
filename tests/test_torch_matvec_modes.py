"""K2's and K6's contraction modes ('vpu', 'default', 'high3'; the TPU
kernel's ``_contract``, ``pallas_matvec.py:90-112``) on the CPU: the plain
versions against the JAX kernel in interpret mode and against float64, the
tensor-core walk's fragment map (``gibbs_mma_kernel`` in
csrc/gibbs_matvec.cu) replayed in numpy, V's packing, the refusals, and the
operation counts of the modes' bounds.

The kernel itself cannot run here: ``chip_smoke.py`` (``k2_modes``,
``k6_modes``) holds it to its plain version and to float64 on the card
within the bounds below.

The bounds, with u = 2⁻⁸ bf16's unit roundoff (round to nearest: 8
significant bits) and S_ir = Σ_j |K_ij||V_jr|:
  * 'default' rounds K and V once each: |K̃Ṽ − KV| ≤ (|K̃ − K||Ṽ| +
    |K||Ṽ − V|) ≤ (2u + u²)|K||V| a term, so the row sum is off by at most
    (2u + u²)·S_ir, plus the f32 accumulation;
  * 'high3' keeps hi = bf16(a) and lo = bf16(a − hi) of both (a − hi is
    exact in f32; |a − hi| ≤ u|a|, so lo misses a by at most u²|a|) and
    drops lo·lo: the term is off by |lo_K lo_V| + the two lo roundings
    against the other factor, at most 3u²(1 + u) < 4u² of |K||V|, so the
    row sum by 4u²·S_ir, plus the f32 accumulation and the element's own
    f32 error (2⁻²⁰ relative covers both rsqrt.approx and ex2.approx);
  * 'vpu' is exact f32, the same estimand as 'highest'.
Measured here, the plain 'high3' against JAX's interpret-mode 'high3' is
within 7.7e-7·S (both take the same bf16 parts of f32 elements that differ
by rounding, summed in another order); 'vpu' 2.4e-7·S.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nonstationary_precip_tpu.ops import pallas_matvec as pm
from nonstationary_precip_tpu_torch.kernels.gibbs import gibbs_gram_reference
from nonstationary_precip_tpu_torch.ops import matvec
from nonstationary_precip_tpu_torch.ops.cuda_build import CSRC

torch.set_num_threads(1)
U = 2.0**-8
BOUND = {"default": 2 * U + U * U, "high3": 4 * U * U + 2.0**-20}
JAX_TOL = {"high3": 2e-6, "vpu": 1e-6}  # of S, against the interpret-mode kernel (measured 7.7e-7, 2.4e-7)


def _gibbs(rng, n1, n2, d, r):
    x1, x2 = (rng.uniform(-2, 2, size=(n, d)).astype(np.float32) for n in (n1, n2))
    e1, e2 = (np.exp(0.3 * rng.normal(size=(n, d))).astype(np.float32) for n in (n1, n2))
    return x1, e1, x2, e2, rng.normal(size=(n2, r)).astype(np.float32)


def _s(x1, e1, x2, e2, v):
    """float64 (K V, |K||V|)."""
    k = gibbs_gram_reference(*(torch.tensor(a, dtype=torch.float64) for a in (x1, e1, x2, e2)))
    vd = torch.tensor(v, dtype=torch.float64)
    return (k @ vd).numpy(), (k.abs() @ vd.abs()).numpy()


@pytest.mark.parametrize("mode", ["high3", "vpu"])
@pytest.mark.parametrize("n1,n2,d,r", [(256, 512, 2, 9), (300, 520, 3, 16)], ids=["d2", "d3"])
def test_plain_modes_match_the_jax_kernel(mode, n1, n2, d, r):
    """The plain 'high3' and 'vpu' against JAX's kernel in interpret mode
    (JAX_TOL of S), and both within the mode's float64 bound."""
    args = _gibbs(np.random.default_rng(n1 + d), n1, n2, d, r)
    with pltpu.force_tpu_interpret_mode():
        j = np.asarray(pm.gibbs_gram_matvec(*(jnp.asarray(a) for a in args), precision=mode))
    p = matvec.gibbs_gram_matvec_plain(*(torch.tensor(a) for a in args), precision=mode).numpy()
    ref, s = _s(*args)
    assert np.abs(p - j).max() <= JAX_TOL[mode] * s.max() and np.all(np.abs(p - j) <= JAX_TOL[mode] * s + 1e-30)
    assert np.all(np.abs(p - ref) <= BOUND["high3"] * s + 1e-30)


def test_plain_rbf_high3_matches_the_jax_kernel():
    rng = np.random.default_rng(5)
    x1, _, x2, _, v = _gibbs(rng, 256, 300, 2, 9)
    ell = np.array([0.7, 1.2], np.float32)
    with pltpu.force_tpu_interpret_mode():
        j = np.asarray(pm.rbf_gram_matvec(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(ell), jnp.asarray(v),
                                          precision="high3"))
    p = matvec.make_rbf_matvec(torch.tensor(x1), torch.tensor(x2), torch.tensor(ell), "high3")(torch.tensor(v))
    np.testing.assert_allclose(p.numpy(), j, rtol=0, atol=JAX_TOL["high3"] * float(np.abs(v).sum(0).max()))


@pytest.mark.parametrize("kind", ["gibbs", "rbf"])
def test_plain_default_is_the_bf16_rounded_product(kind):
    """'default' is the bf16-rounded Gram panel against the bf16-rounded V:
    against float64 of those rounded operands it differs by the f32
    accumulation alone (n·2⁻²⁴ of S), and against the exact product it
    stays inside (2u + u²)·S."""
    x1, e1, x2, e2, v = _gibbs(np.random.default_rng(3), 200, 700, 2, 9)
    t = [torch.tensor(a) for a in (x1, e1, x2, e2, v)]
    if kind == "gibbs":
        tile = gibbs_gram_reference(*t[:4])
        p = matvec.gibbs_gram_matvec_plain(*t, precision="default")
    else:
        tile = torch.exp(-0.5 * torch.cdist(t[0].double(), t[2].double()) ** 2).float()
        p = matvec.rbf_gram_matvec_plain(t[0], t[2], t[4], precision="default")
    rounded = tile.to(torch.bfloat16).double() @ t[4].to(torch.bfloat16).double()
    s = (tile.double().abs() @ t[4].double().abs()).numpy()
    assert np.all(np.abs(p.double().numpy() - rounded.numpy()) <= 700 * 2.0**-24 * s + 1e-30)
    exact = tile.double() @ t[4].double()
    assert np.all(np.abs(p.double().numpy() - exact.numpy()) <= BOUND["default"] * s + 1e-30)
    assert np.abs(p.double().numpy() - exact.numpy()).max() > 1e3 * 2.0**-24 * s.max()  # it does round


BIAS = {"default": 2.0**-9 + 7 * 2.0**-20, "high3": 7 * 2.0**-20}  # chip_smoke.py's MODE_BIAS


@pytest.mark.parametrize("kind", ["gibbs", "rbf"])
def test_bias_payload_shows_each_modes_share(kind):
    """chip_smoke.py's bias check: on the positive V = 2^e·(1 + 2⁻⁹ +
    7·2⁻²⁰), exact in f32, 'high3''s hi + lo keep 1 + 2⁻⁹ of each entry
    and 'default''s hi keeps 1, so each mode falls short of float64 by
    BIAS[mode] of every (positive) result on average, within 10 %.  The
    f32 product ('highest') falls short by under 2 % of 'high3''s share,
    so a kernel that ignored its mode fails the check."""
    rng = np.random.default_rng(11)
    x1, e1, x2, e2, _ = _gibbs(rng, 300, 400, 2, 1)
    v64 = torch.tensor(2.0 ** rng.integers(-2, 3, size=(400, 9)) * (1 + 2.0**-9 + 7 * 2.0**-20))
    v = v64.float()
    assert torch.equal(v.double(), v64)  # exact in f32
    t = [torch.tensor(a) for a in (x1, e1, x2, e2)]
    if kind == "gibbs":
        ref = gibbs_gram_reference(*(a.double() for a in t)) @ v.double()
        plain = lambda mode: matvec.gibbs_gram_matvec_plain(*t, v, precision=mode)  # noqa: E731
    else:
        ref = torch.exp(-0.5 * torch.cdist(t[0].double(), t[2].double()) ** 2) @ v.double()
        plain = lambda mode: matvec.rbf_gram_matvec_plain(t[0], t[2], v, precision=mode)  # noqa: E731
    bias = {mode: float(((ref - plain(mode).double()) / ref).mean()) for mode in ("highest", "default", "high3")}
    for mode in ("default", "high3"):
        assert abs(bias[mode] - BIAS[mode]) <= 0.1 * BIAS[mode], (mode, bias[mode])
    assert abs(bias["highest"]) < 0.02 * BIAS["high3"]


def _source_int(name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", (CSRC / "gibbs_matvec.cu").read_text())
    return m.group(1)


def test_source_constants():
    assert int(_source_int("kMmaMT")) == matvec.MMA_MT
    assert int(_source_int("kMmaPass")) == matvec.MMA_PASS
    assert int(_source_int("kMmaGroup")) == matvec.MMA_GROUP
    assert matvec.MMA_ROWS == 8 * matvec.MMA_MT * 16 and matvec.COLS % matvec.MMA_PASS == 0
    src = (CSRC / "gibbs_matvec.cu").read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src and "__floats2bfloat162_rn" in src


def _replay(n1, n2, rc, sms=132):
    """The walk's map, as the kernel computes it: for every block (row tile
    bx, column split s, rhs group z), warp w and lane (g = lane/4, t =
    lane%4), the rows row0 + 16mt + 8h and, in each pass and 16-column step,
    the columns 2t, 2t + 1, 2t + 8, 2t + 9; a column at or past the pass's
    jn is masked (its element 0).  Returns (builds (n1, n2) of one group,
    masked builds in range, rows computed past n1, stores (n1, rc))."""
    splits, per = matvec.column_splits(n1, n2, -(-rc // matvec.MMA_GROUP), sms, matvec.MMA_ROWS,
                                       matvec.MMA_BLOCKS_PER_SM)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    rows = (np.arange(-(-n1 // matvec.MMA_ROWS))[:, None, None, None, None] * matvec.MMA_ROWS
            + np.arange(8)[None, :, None, None, None] * (matvec.MMA_MT * 16)
            + np.arange(matvec.MMA_MT)[None, None, :, None, None] * 16
            + np.arange(2)[None, None, None, :, None] * 8 + g[None, None, None, None, :])
    rows = rows.ravel()
    cols_of_lane = np.stack([2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9], axis=1)  # (32, 4)
    built = np.zeros((n1, n2), np.int64)
    masked = 0
    for s in range(splits):
        c_begin, c_end = s * per, min(n2, s * per + per)
        for c0 in range(c_begin, c_end, matvec.MMA_PASS):
            jn = min(matvec.MMA_PASS, c_end - c0)
            for jb in range(0, matvec.MMA_PASS, 16):
                # a lane's rows pair with that lane's own columns
                lanes_rows = rows.reshape(-1, 32)  # (.., lane)
                for q in range(4):
                    j = jb + cols_of_lane[:, q]  # (32,)
                    ok = j < jn
                    r = lanes_rows[:, ok]
                    c = np.broadcast_to(c0 + j[ok], r.shape)
                    keep = r < n1
                    np.add.at(built, (r[keep], c[keep]), 1)
                    masked += int(((~ok) & (c0 + j < n2)).sum())
    stores = np.zeros((n1, rc), np.int64)
    for z in range(-(-rc // matvec.MMA_GROUP)):
        gw = min(matvec.MMA_GROUP, rc - z * matvec.MMA_GROUP)
        nt = 1 if gw <= 8 else 2 if gw <= 16 else 4
        out_cols = np.array([ntt * 8 + 2 * tt + e for ntt in range(nt) for tt in range(4) for e in range(2)])
        out_cols = out_cols[out_cols < gw]
        r = rows[rows < n1]
        # each lane stores its (g, g + 8) rows' 2 columns of each tile: every
        # lane of a quad (same g) covers the quad's 4·2 columns of a tile
        for rr in np.unique(r):
            stores[rr, z * matvec.MMA_GROUP + out_cols] += 1
    return built, masked, int(np.unique(rows[rows >= n1]).size), stores, splits


@pytest.mark.parametrize("n1,n2,rc", [(1000, 1300, 3), (394, 394, 9), (16, 8, 9), (300, 257, 40)],
                         ids=["ragged", "slice_field", "one_tile", "two_groups"])
def test_fragment_map_builds_every_element_once(n1, n2, rc):
    """Every (row, column) of a ragged Gram is built exactly once a rhs
    group, each split's columns past its end are masked (element 0, never
    a neighbour split's V), rows past n1 are computed but not stored, and
    every output (row, rhs) is stored once a split."""
    built, masked, padded_rows, stores, splits = _replay(n1, n2, rc)
    assert np.all(built == 1)
    assert padded_rows == (-(-n1 // matvec.MMA_ROWS)) * matvec.MMA_ROWS - n1
    assert np.all(stores == 1)
    assert masked >= 0 and splits >= 1


def test_bf16_pairs_pack_the_b_fragments():
    """V's hi (and lo) parts in column pairs: the low half of word [p, r] is
    bf16(v[2p, r]), the high half bf16(v[2p + 1, r]); odd rows and the
    columns past R padded with 0; hi + lo is v to 2⁻¹⁶."""
    v = torch.randn(7, 5)
    hi, lo, ldp = matvec._bf16_pairs(v, True)
    assert ldp == 8 and hi.shape == (4, 8) and hi.dtype == torch.int32

    def unpack(w):
        h = w.contiguous().view(torch.int16).reshape(4, 8, 2).transpose(1, 2).reshape(8, 8)
        return h.view(torch.bfloat16).float()

    vh, vl = unpack(hi), unpack(lo)
    torch.testing.assert_close(vh[:7, :5], v.to(torch.bfloat16).float(), rtol=0, atol=0)
    assert torch.all(vh[7] == 0) and torch.all(vh[:, 5:] == 0)
    assert float((vh[:7, :5] + vl[:7, :5] - v).abs().max()) <= 2.0**-16 * float(v.abs().max())
    hi1, lo1, _ = matvec._bf16_pairs(v, False)
    assert lo1 is hi1


def test_modes_dispatch_and_refusals():
    """The CPU takes each mode's plain version; 'vpu' is 'highest''s walk
    and refuses more than VPU_R_MAX right-hand sides, as JAX does; an
    unknown precision raises, and so do the mode kernels' wrappers on CPU
    tensors (the kernel never computes on the CPU)."""
    args = [torch.tensor(a) for a in _gibbs(np.random.default_rng(1), 40, 50, 2, 9)]
    for mode in matvec.PRECISIONS:
        torch.testing.assert_close(matvec.gibbs_gram_matvec(*args, precision=mode),
                                   matvec.gibbs_gram_matvec_plain(*args, precision=mode), rtol=0, atol=0)
    torch.testing.assert_close(matvec.gibbs_gram_matvec(*args, precision="vpu"), matvec.gibbs_gram_matvec(*args))
    wide = torch.randn(50, matvec.VPU_R_MAX + 1)
    with pytest.raises(ValueError, match="vpu: R ≤ 32"):
        matvec.gibbs_gram_matvec(*args[:4], wide, precision="vpu")
    with pytest.raises(ValueError, match="precision"):
        matvec.make_gibbs_matvec(*args[:4], precision="high")
    with pytest.raises(ValueError, match="precision"):
        matvec.make_rbf_matvec(args[0], args[2], torch.ones(2), precision="vpu")
    with pytest.raises(ValueError, match="CUDA"):
        matvec.gibbs_gram_matvec_mma_cuda(*args, "high3")
    with pytest.raises(ValueError, match="CUDA"):
        matvec.rbf_gram_matvec_mma_cuda(args[0], args[2], args[4], "default")
    with pytest.raises(ValueError, match="'default' or 'high3'"):
        matvec.gibbs_gram_matvec_mma_cuda(*args, "highest")


def test_mode_operation_counts():
    """Each mode's bound: the element (K2 15 FP32 operations at d = 2, K6 5)
    and its rounding (1 'default', 4 'high3') on the FP32 lanes, the SFU's
    as for 'highest', and 2R an element a pass on the tensor cores; the
    contraction's 2R FMAs (18 of K2's 33 at R = 9) leave the FP32 count."""
    n = 16384
    assert matvec.matvec_ops(n, n, 2, 9) == n * n * 33
    assert matvec.mode_ops(n, n, 2, "default") == n * n * 16
    assert matvec.mode_ops(n, n, 2, "high3") == n * n * 19
    assert matvec.mode_ops(n, n, 2, "high3", matvec._rbf_elem_ops) == n * n * 9
    assert matvec.mode_ops(n, n, 3, "default") == n * n * (13 * 3 + 3 + 1)
    assert matvec.mma_ops(n, n, 9, "default") == 2 * n * n * 9
    assert matvec.mma_ops(n, n, 9, "high3") == 3 * 2 * n * n * 9
    assert matvec.matvec_sfu_ops(n, n, 2) == 2 * n * n and matvec.rbf_matvec_sfu_ops(n, n) == n * n
