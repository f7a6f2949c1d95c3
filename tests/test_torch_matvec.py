"""K2 and K3 in the PyTorch port (``nonstationary_precip_tpu_torch/ops/
matvec.py``) against the JAX package's Pallas kernels, float32 on the CPU.

Here there is no card, so the port's wrappers take their plain versions
(the tensors lie on the CPU); the JAX side runs its Pallas kernels in
interpret mode, as tests/test_pallas_matvec.py does, with that file's band
(rtol 2e-5, atol 2e-4: both sides are f32 sums of up to 300 terms of size
≤ 1 in another order).  The CUDA kernels themselves are held against the
same plain versions on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nonstationary_precip_tpu.ops import pallas_matvec as pm
from nonstationary_precip_tpu_torch.kernels.gibbs import packed_gibbs_cross
from nonstationary_precip_tpu_torch.ops import lazy_cg, matvec

torch.set_num_threads(1)
RTOL, ATOL = 2e-5, 2e-4


def _gibbs_data(rng, n1, n2, d, r):
    x1 = rng.normal(size=(n1, d)).astype(np.float32)
    x2 = rng.normal(size=(n2, d)).astype(np.float32)
    e1 = np.exp(0.3 * rng.normal(size=(n1, d))).astype(np.float32)
    e2 = np.exp(0.3 * rng.normal(size=(n2, d))).astype(np.float32)
    v = rng.normal(size=(n2, r)).astype(np.float32)
    return x1, e1, x2, e2, v


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("n1,n2,d,r", [
    (40, 64, 2, 1),  # far below one TPU tile
    (300, 260, 3, 9),  # mBCG's R, odd sizes
    (96, 160, 2, 130),  # R over the per-launch 128: column chunks
])
def test_gibbs_matvec_matches_jax_k2(n1, n2, d, r):
    arrs = _gibbs_data(np.random.default_rng(173), n1, n2, d, r)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pm.gibbs_gram_matvec(*(jnp.asarray(a) for a in arrs)))
    before = dict(matvec.LAUNCHES)
    got = matvec.gibbs_gram_matvec(*(_t(a) for a in arrs))
    assert got.shape == (n1, r) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(matvec.gibbs_gram_matvec_plain(*(_t(a) for a in arrs)).numpy(), ref,
                               rtol=RTOL, atol=ATOL)
    assert matvec.LAUNCHES == before  # CPU tensors never launch


@pytest.mark.parametrize("scaled", [False, True])
def test_builders_match_jax(scaled):
    """K v + σ²v (s²·K v + σ²v when scaled) on the packed payload
    [x, log ℓ], as JAX's builders."""
    rng = np.random.default_rng(3)
    aug = np.concatenate([rng.uniform(-2, 2, size=(200, 2)), 0.2 * rng.normal(size=(200, 2))], 1).astype(np.float32)
    v = rng.normal(size=(200, 9)).astype(np.float32)
    name = "scaled_packed_gibbs_matvec_builder" if scaled else "packed_gibbs_matvec_builder"
    with pltpu.force_tpu_interpret_mode():
        ref = getattr(pm, name)(2)(jnp.float32(0.7), jnp.asarray(aug), jnp.float32(0.2))(jnp.asarray(v))
    got = getattr(matvec, name)(2)(torch.tensor(0.7), _t(aug), torch.tensor(0.2))(_t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def _panel_data(rng, n, d, r):
    x = rng.uniform(-2, 2, size=(n, d)).astype(np.float32)
    ell = np.exp(0.2 * rng.normal(size=(n, d))).astype(np.float32)
    a, s, z = (rng.normal(size=shape).astype(np.float32) for shape in ((n,), (n, r), (n, r)))
    return x, ell, a, s, z


def test_panel_grads_matches_jax_k3():
    """(∂x, ∂ℓ, rowsum Ŵ⊙K) of the sweep, full and on one row block."""
    x, ell, a, s, z = _panel_data(np.random.default_rng(5), 256, 2, 8)
    j = [jnp.asarray(v) for v in (x, ell, a, s, z)]
    t = [_t(v) for v in (x, ell, a, s, z)]
    sl = slice(128, 256)
    with pltpu.force_tpu_interpret_mode():
        ref = pm.packed_gibbs_panel_grads(*j)
        ref_rows = pm.packed_gibbs_panel_grads_rows(*(v[sl] for v in j), *j)
    got = matvec.packed_gibbs_panel_grads(*t)
    got_rows = matvec.packed_gibbs_panel_grads_rows(*(v[sl] for v in t), *t)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)
    for g, r in zip(got_rows, ref_rows):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)
    for g, r in zip(matvec.packed_gibbs_panel_grads_plain(*t), got):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_panel_vjp_rows_assemble_the_full_vjp():
    """Row blocks of ``packed_gibbs_panel_vjp_rows``, concatenated and
    chained, give ``packed_gibbs_panel_vjp``'s gradients; each block returns
    its rows' sp (JAX's returns their sum), so one sum over all rows gives
    the outputscale's gradient as the whole sweep sums it."""
    x, ell, a, s, z = (_t(v) for v in _panel_data(np.random.default_rng(7), 192, 2, 4))
    aug = torch.cat([x, torch.log(ell)], 1)
    raw, s2, g = torch.tensor(0.6), torch.tensor(0.1), torch.tensor(-1.5)
    kg, gaug, s2g = matvec.packed_gibbs_panel_vjp(2)(raw, aug, s2, a, s, z, g)
    parts = [matvec.packed_gibbs_panel_vjp_rows(2)(raw, aug, s2, a, s, z, g, i0, 64) for i0 in (0, 64, 128)]
    assert all(p[1].shape == (64,) for p in parts)
    sp = torch.sum(torch.cat([p[1] for p in parts]))
    torch.testing.assert_close(torch.nn.functional.softplus(raw) * torch.cat([p[0] for p in parts]), gaug)
    torch.testing.assert_close(g * sp * torch.sigmoid(raw), kg)


@pytest.mark.parametrize("scaled", [False, True])
def test_fused_panel_vjp_matches_scan(scaled):
    """The port's fused backward (K3's route) reroutes only the gradient:
    the value is bit-identical and every gradient matches the autograd
    panel loop to f32 rounding (test_pallas_matvec.py:177-212's band)."""
    rng = np.random.default_rng(11)
    n = 256
    x = torch.tensor(rng.uniform(-2, 2, size=(n, 2)), dtype=torch.float32)
    y = torch.tensor(rng.normal(size=n), dtype=torch.float32)
    aug0 = torch.cat([x, torch.tensor(0.2 * rng.normal(size=(n, 2)), dtype=torch.float32)], 1)
    probes = torch.tensor(rng.choice([-1.0, 1.0], size=(n, 8)), dtype=torch.float32)

    def run(pvjp):
        raw = torch.tensor(0.8, requires_grad=True) if scaled else None
        aug, s2 = aug0.clone().requires_grad_(), torch.tensor(0.3, requires_grad=True)
        val = lazy_cg.lazy_cg_mll(raw, aug, y, probes, s2, block=128, max_iters=64, tol=1e-7,
                                  cross_fn=packed_gibbs_cross(2), panel_vjp=pvjp)
        val.backward()
        return val.detach(), [t.grad for t in ((raw,) if scaled else ()) + (aug, s2)]

    vp, gp = run(None)
    vf, gf = run(matvec.packed_gibbs_panel_vjp(2))
    assert float(vf) == float(vp)
    for a, b in zip(gp, gf):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-3, atol=5e-4)


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    rng = np.random.default_rng(1)
    x1, e1, x2, e2, v = (_t(a) for a in _gibbs_data(rng, 16, 16, 9, 1))
    with pytest.raises(ValueError, match="D"):
        matvec.gibbs_gram_matvec(x1, e1, x2, e2, v)
    x1, e1, x2, e2, v = (_t(a) for a in _gibbs_data(rng, 16, 16, 2, 1))
    # the TPU's other contraction modes are ported (tests/test_torch_matvec_modes.py): on the CPU each
    # takes its plain version; an unknown one raises
    torch.testing.assert_close(matvec.make_gibbs_matvec(x1, e1, x2, e2, precision="high3")(v),
                               matvec.gibbs_gram_matvec_plain(x1, e1, x2, e2, v, precision="high3"))
    with pytest.raises(ValueError, match="precision"):
        matvec.make_gibbs_matvec(x1, e1, x2, e2, precision="high")
    with pytest.raises(ValueError, match="CUDA"):  # the kernel's wrapper never computes on the CPU
        matvec.gibbs_gram_matvec_cuda(x1, e1, x2, e2, v)
    x, ell, a, s, z = (_t(t) for t in _panel_data(rng, 32, 2, 40))
    f1, f2 = matvec.cotangent_factors(a, s, z)
    with pytest.raises(ValueError, match="R ≤ 32"):
        matvec._panel_grads_cuda(x, ell, f1, x, ell, f2)


@pytest.mark.parametrize("n_rows,n_cols,groups", [(16384, 16384, 1), (1000, 1500, 4), (2048, 16384, 1), (40, 64, 1)])
def test_column_splits_cover_the_columns(n_rows, n_cols, groups):
    """Whole COLS-wide passes per split, every column covered, no empty
    split, and at least half the blocks the card is meant to hold unless
    every pass is its own split."""
    splits, per = matvec.column_splits(n_rows, n_cols, groups, 132)
    assert per % matvec.COLS == 0 and splits * per >= n_cols > (splits - 1) * per
    blocks = -(-n_rows // matvec.ROWS) * groups * splits
    assert 2 * blocks >= matvec.BLOCKS_PER_SM * 132 or splits == -(-n_cols // matvec.COLS)
    assert jax is not None  # both frameworks live in this process
