"""K10b, the retry-free grid-batched (L, L⁻¹), on K1's cluster kernel: the
schedule of csrc/chol_inv_cluster.cu at ``max_tries = 0``, emulated in torch.

K10b (``ops/chol_inv.chol_inv_grid_cuda``) launches K1's kernel with its
retry off: one jitter-free try, a member whose try fails left NaN, each
member its own cluster.  There is no card here, so the kernel cannot run;
tests/cluster_emulation.py replays the cluster header's arithmetic with
K1's Source at one try, and this file holds it to what ``chip_smoke.py``'s
k10b phase holds the kernel to (``K10B_FLOOR``: each output's error from
float64 within twice the plain f32 version's plus a floor), and to the JAX
package's ``_chol_inv_forward`` in Pallas interpret mode, as
tests/test_torch_chol_k10.py runs it: on well-conditioned stacks in that
file's band (rtol 5e-3, atol 5e-4; atol 2e-3 on L⁻¹), on the deep GP's
K_zz at init (κ₂ ~5e6, where two f32 factorisations part by percents in
L⁻¹) to float64 within twice the JAX kernel's error plus the same floor, on
the members the JAX kernel factors.
The emulation runs in torch's f32, not the card's FMA and rsqrt: it is
held to the criteria the card is held to, not to the card's bits.
"""

import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import nonstationary_precip_tpu.ops.pallas_chol as pc
from chip_smoke import K10B_FLOOR, k4_payload
from cluster_emulation import B, PaddedSource, emulate
from nonstationary_precip_tpu_torch.ops import chol_inv, svgp_precompute
from nonstationary_precip_tpu_torch.ops.cuda_build import CSRC

torch.set_num_threads(1)

SMEM_OPTIN = 232448  # the H100's 227 KB a block may opt in to


def k10b(mats):
    """The kernel's (L, L⁻¹) at one try, NaN where the try fails."""
    t, n, _ = mats.shape
    l, li, jit, _ = emulate(PaddedSource(mats, max_tries=0), t, n, mats.dtype)
    assert not bool(jit.any())
    return l, li


def _spd(seed, b, n):
    gen = torch.Generator().manual_seed(seed)
    m = torch.randn(b, n, n, generator=gen, dtype=torch.float64)
    return (m @ m.mT / n + 0.5 * torch.eye(n, dtype=torch.float64)).float()


def _f64(a):
    l64 = torch.linalg.cholesky(a.double())
    eye = torch.eye(a.shape[-1], dtype=torch.float64)
    return l64, torch.linalg.solve_triangular(l64, eye.expand_as(l64), upper=False)


def _rel(x, ref):
    return float((torch.as_tensor(x).double() - ref).abs().max() / ref.abs().max())


def _jax(a):
    with pltpu.force_tpu_interpret_mode():
        return tuple(np.asarray(t) for t in pc._chol_inv_forward(jnp.asarray(a.numpy())))


def _kzz_init():
    """The deep GP's K_zz at init, splits 0 and 1: 10 members of 250 (every
    layer of each split), as chip_smoke.py's k10b builds its stack."""
    from nonstationary_precip_tpu_torch.data.dataprep import load_csv
    from nonstationary_precip_tpu_torch.experiments import deepgp_spatial
    from nonstationary_precip_tpu_torch.train.vmapped import stack_modules
    from nonstationary_precip_tpu_torch.utils.config import DATASET_DIR

    cfg = deepgp_spatial.default_config().parse_args(["--num_epochs", "1", "--device", "cpu"])
    data = load_csv(DATASET_DIR / "uib_spatial.csv")
    models = [deepgp_spatial.prep_split(data, s, cfg, torch.float32, torch.device("cpu"))[0] for s in range(2)]
    z, ell, s2, _ = k4_payload(stack_modules(models))
    with torch.no_grad():
        return svgp_precompute.gram_zz_plain(z, ell, s2).contiguous()


@pytest.mark.parametrize("b,n", [(2, 130), (1, 512)], ids=["ragged_130", "top_512"])
def test_random_stack_meets_the_k10b_criterion_and_matches_jax(b, n):
    """A ragged N = 130 (the identity pads it to 160) and the window's top,
    N = 512 (16 block steps): L and L⁻¹ within K10B_FLOOR of float64 beside
    the plain version, within the JAX kernel's band, zero upper triangles."""
    a = _spd(n, b, n)
    l, li = k10b(a)
    pl, pli = chol_inv.chol_inv_batched_plain(a)
    l64, li64 = _f64(a)
    assert _rel(l, l64) <= 2 * _rel(pl, l64) + K10B_FLOOR["L"]
    assert _rel(li, li64) <= 2 * _rel(pli, li64) + K10B_FLOOR["Linv"]
    rl, rli = _jax(a)
    np.testing.assert_allclose(l.numpy(), rl, rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(li.numpy(), rli, rtol=5e-3, atol=2e-3)
    assert bool((torch.triu(l, 1) == 0).all()) and bool((torch.triu(li, 1) == 0).all())


def test_kzz_stack_meets_the_k10b_criterion_beside_jax():
    """The deep GP's near-singular K_zz at init: every member factored at one
    try, L within K10B_FLOOR["L"] and L⁻¹ within K10B_FLOOR["Linv_kzz"] of
    float64 beside the plain version, and beside the JAX kernel on the
    members that kernel factors (it has no retry either, and its f32
    recurrence leaves 9 of these 10 non-finite)."""
    a = _kzz_init()
    assert tuple(a.shape) == (10, 250, 250)
    l, li = k10b(a)
    assert bool(torch.isfinite(l).all() and torch.isfinite(li).all())
    l64, li64 = _f64(a)
    pl, pli = chol_inv.chol_inv_batched_plain(a)
    rl, rli = (torch.from_numpy(x.copy()) for x in _jax(a))
    jax_ok = torch.isfinite(rl).flatten(1).all(1) & torch.isfinite(rli).flatten(1).all(1)
    assert bool(jax_ok.any()), jax_ok.tolist()  # 1 of the 10 at this writing
    for name, (ol, oli), ok in (("plain", (pl, pli), slice(None)), ("jax", (rl, rli), jax_ok)):
        assert _rel(l[ok], l64[ok]) <= 2 * _rel(ol[ok], l64[ok]) + K10B_FLOOR["L"], name
        assert _rel(li[ok], li64[ok]) <= 2 * _rel(oli[ok], li64[ok]) + K10B_FLOOR["Linv_kzz"], name


def test_non_pd_member_is_nan_and_the_others_bitwise():
    """No retry: a negative-definite member comes out NaN in L and L⁻¹; the
    others are bitwise those of a run without it."""
    good = _spd(3, 3, 100)
    bad = good.clone()
    bad[1] = -bad[1]
    lg, lig = k10b(good)
    lb, lib = k10b(bad)
    assert bool(torch.isnan(lb[1]).all()) and bool(torch.isnan(lib[1]).all())
    assert torch.equal(lg[[0, 2]], lb[[0, 2]]) and torch.equal(lig[[0, 2]], lib[[0, 2]])
    assert bool(torch.isfinite(lg).all() and torch.isfinite(lig).all())


def _factor_floats(n, cluster, header):
    """``factor_floats<cluster>(n)`` from the header's constants: a CTA's
    tile slots, the operand buffer (nb tiles), L_kk, the leaf's two column
    buffers and two flags."""
    kb = int(re.search(r"constexpr int kB = (\d+);", header).group(1))
    ld = kb + int(re.search(r"constexpr int kLd = kB \+ (\d+);", header).group(1))
    assert "return static_cast<size_t>(slots<kCluster>(nb) + nb + 1) * kTile + 2 * kB + 4;" in header
    nb = -(-n // kb)
    slots = -(-(nb * (nb + 1) // 2) // cluster)
    return (slots + nb + 1) * kb * ld + 2 * kb + 4


def test_window_top_fits_a_cluster_of_8():
    """At N = 512 a CTA of K1's cluster of 8 takes factor_floats<8>(512) =
    39,236 floats (157 KB), under the 227 KB a block may opt in to; a
    cluster of 4 would take 235 KB and not fit, which is why K10b keeps
    K1's 8."""
    header = (CSRC / "chol_inv_cluster.cuh").read_text()
    cluster = int(re.search(r"#define K1_CLUSTER (\d+)", chol_inv.SOURCE.read_text()).group(1))
    assert cluster == 8 and B == 32
    assert _factor_floats(512, 8, header) == 39236 and 4 * 39236 <= SMEM_OPTIN
    assert 4 * _factor_floats(512, 4, header) == 235280 > SMEM_OPTIN
    assert all(4 * _factor_floats(n, cluster, header) <= SMEM_OPTIN for n in range(1, chol_inv.GRID_MAX_N + 1))


def test_the_c_entry_takes_the_window_and_k1_keeps_its_gate():
    """The C entry takes N up to K10b's window top (the JAX MAX_N_CHOLINV,
    512); K1's wrapper still refuses 385 (its gate's MAX_N_CHOLINV_B); K10b's
    wrapper launches K1's library with max_tries = 0, and the old grid
    kernel and its sweep are gone."""
    text = chol_inv.SOURCE.read_text()
    assert int(re.search(r"constexpr int kMaxN = (\d+);", text).group(1)) == chol_inv.GRID_MAX_N == pc.MAX_N_CHOLINV
    assert chol_inv.MAX_N == pc.MAX_N_CHOLINV_B == 384
    with pytest.raises(ValueError, match="1 <= N <= 384"):
        chol_inv.chol_inv_batched_cuda(torch.zeros(1, 385, 385))
    src = inspect.getsource(chol_inv.chol_inv_grid_cuda)
    assert "_launch(mats.contiguous(), EPSILON, 0)" in src and "GRID_LAUNCHES += 1" in src
    assert "lib.chol_inv_cluster(" in inspect.getsource(chol_inv._launch)
    assert not (CSRC / "chol_inv_grid.cu").exists() and not (CSRC / "chol_sweep.cuh").exists()
    assert not any("chol_sweep" in p.read_text() for p in CSRC.iterdir())
