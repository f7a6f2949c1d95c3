"""K1's cluster schedule (csrc/chol_inv_cluster.cu on
csrc/chol_inv_cluster.cuh), emulated in torch.

There is no card here, so the kernel cannot run; tests/cluster_emulation.py
replays the header's arithmetic in the kernel's order, step by step, and
this file holds the result to what chip_smoke.py's k1 phase holds the
kernel to, with K1's Source: the member A + j·I read as it is, and K1's
ladder (j = 1e-5, ×10 after a jitter-free first try).

The emulation runs in float32 (torch's f32 arithmetic, not the card's FMA:
the criteria below are those the card is held to, not bitwise) on the
slice's Gibbs Gram at init (built on the CPU as chip_smoke.py's k1 phase
builds it), a random SPD stack at N = 384 and a ragged N = 100, and in
float64 against the JAX package's plain reference of ``chol_inv_batched_safe``
(its ``safe_cholesky`` and a triangular solve of the identity, under
``jax.enable_x64``; the Pallas kernel writes float32 only) and in float32
against the Pallas kernel in interpret mode, as tests/test_pallas.py runs it.
"""

import re

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cluster_emulation import B, PaddedSource
from cluster_emulation import emulate as emulate_source
from nonstationary_precip_tpu.ops import linalg as jax_linalg
from nonstationary_precip_tpu.ops import pallas_chol
from nonstationary_precip_tpu_torch.ops import chol_inv
from nonstationary_precip_tpu_torch.ops.cuda_build import CSRC

torch.set_num_threads(1)

CLUSTER_SIZES = (1, 2, 4, 8)

# chip_smoke.py's k1 criterion
TOL_L_F64, TOL_LINV_RESIDUAL, TOL_KERNEL_PLAIN = 5e-6, 5e-5, 1e-5


def emulate(mats, jitter=1e-5, max_tries=6):
    """The kernel's (L, L⁻¹, jitter per member)."""
    t, n, _ = mats.shape
    l, li, jit, _ = emulate_source(PaddedSource(mats, jitter, max_tries), t, n, mats.dtype)
    return l, li, jit


def _spd(gen, t, n):
    b = torch.randn(t, n, n, generator=gen, dtype=torch.float64)
    return b @ b.mT / n + 0.5 * torch.eye(n, dtype=torch.float64)


def _gibbs_gram():
    """The slice's stacked noisy Gibbs Gram at init, (10, 316, 316) f32, as
    chip_smoke.py's k1 phase builds it (here on the CPU)."""
    from nonstationary_precip_tpu_torch.data.datasets import load_uib_spatial
    from nonstationary_precip_tpu_torch.experiments import spatial_gibbs
    from nonstationary_precip_tpu_torch.models.gibbs_gp import noisy_gibbs_gram
    from nonstationary_precip_tpu_torch.train.config import ExperimentConfig
    from nonstationary_precip_tpu_torch.train.vmapped import stack_modules

    cfg = ExperimentConfig(device="cpu")
    _, x, y = load_uib_spatial()
    x_norm = (x - x.mean(0)) / x.std(0, ddof=1)
    y_norm = (y - y.mean()) / y.std(ddof=1)
    splits = [spatial_gibbs.make_split(x_norm, y_norm, s, cfg, torch.float32, torch.device("cpu")) for s in range(10)]
    with torch.no_grad():
        return noisy_gibbs_gram(stack_modules([s[0] for s in splits]), torch.stack([s[1][0] for s in splits]))


def _payload(name):
    gen = torch.Generator().manual_seed(173)
    if name == "gibbs_gram":
        return _gibbs_gram().contiguous(), False
    if name == "random_spd_384":
        return _spd(gen, 2, 384).float(), True
    return _spd(gen, 2, 100).float(), True  # ragged: 100 = 3 blocks + 4


@pytest.mark.parametrize("name", ["gibbs_gram", "random_spd_384", "ragged_100"])
def test_schedule_meets_the_k1_criterion(name):
    """The float32 schedule against float64 as chip_smoke.py's k1 holds the
    kernel: L within 5e-6 of float64 relative to its largest entry,
    ‖L⁻¹L − I‖∞ ≤ 5e-5, L⁻¹ within 1e-5 of the plain version on a
    well-conditioned stack and within twice the plain version's error from
    float64 (+1e-5) on the ill-conditioned Gram; the backward error within
    γ_(N+1)|L||Lᵀ| (Higham, Theorem 10.3); no jitter; zero upper triangles."""
    a, well = _payload(name)
    l, li, jit = emulate(a)
    pl, pli, pjit = chol_inv.chol_inv_batched_safe_plain(a)
    assert torch.equal(jit, pjit) and not bool(jit.any())
    n = a.shape[-1]
    a64 = a.double()
    l64 = torch.linalg.cholesky(a64)
    eye = torch.eye(n, dtype=torch.float64)
    li64 = torch.linalg.solve_triangular(l64, eye.expand_as(l64), upper=False)

    def rel(x, ref):
        return float((x.double() - ref).abs().max() / ref.abs().max())

    assert rel(l, l64) <= TOL_L_F64
    assert float((li.double() @ l.double() - eye).abs().max()) <= TOL_LINV_RESIDUAL
    if well:
        assert rel(l, pl.double()) <= TOL_KERNEL_PLAIN
        assert rel(li, pli.double()) <= TOL_KERNEL_PLAIN
    else:
        assert rel(li, li64) <= 2 * rel(pli, li64) + TOL_KERNEL_PLAIN
    gamma = (n + 1) * 2.0**-24 / (1 - (n + 1) * 2.0**-24)
    lk = l.double()
    ratio = ((lk @ lk.mT - a64).abs() / (gamma * (lk.abs() @ lk.abs().mT) + (n + 1) * 2.0**-149)).max()
    assert float(ratio) <= 1.0
    assert bool((torch.triu(l, 1) == 0).all()) and bool((torch.triu(li, 1) == 0).all())


def test_retry_ladder_matches_the_plain_version_and_isolates_the_member():
    """A rank-30 member beside healthy ones: the schedule climbs the same
    jitter ladder as ``chol_inv_batched_safe_plain``, comes out finite, and
    the healthy members are bitwise those of an all-healthy run."""
    gen = torch.Generator().manual_seed(5)
    n = 140
    good = _spd(gen, 3, n).float()
    sb = torch.randn(n, 30, generator=gen, dtype=torch.float64)
    bad = good.clone()
    bad[1] = (sb @ sb.T).float()
    l_a, li_a, j_a = emulate(good)
    l_b, li_b, j_b = emulate(bad)
    _, _, pj_b = chol_inv.chol_inv_batched_safe_plain(bad)
    assert torch.equal(j_b, pj_b) and float(j_b[1]) > 0 and j_b[0] == 0 and j_b[2] == 0
    assert bool(torch.isfinite(l_b).all() and torch.isfinite(li_b).all())
    for i in (0, 2):
        assert torch.equal(l_a[i], l_b[i]) and torch.equal(li_a[i], li_b[i])
    assert not bool(j_a.any())


def test_schedule_matches_jax_chol_inv_batched_safe():
    """In float64 the schedule is the JAX package's plain reference of
    ``chol_inv_batched_safe`` (``safe_cholesky``, then L⁻¹ by a triangular
    solve of the identity) to 1e-12 relative; in float32, its Pallas kernel
    in interpret mode to 1e-5 relative (two f32 implementations that differ
    in summation order, as tests/test_torch_chol_inv.py has it)."""
    gen = torch.Generator().manual_seed(11)
    a = _spd(gen, 2, 100)
    l, li, _ = emulate(a)
    with jax.enable_x64(True):
        lj = jax.vmap(lambda m: jax_linalg.safe_cholesky(m))(jnp.asarray(a.numpy()))
        lij = jsl.solve_triangular(lj, jnp.broadcast_to(jnp.eye(100), lj.shape), lower=True)
        lj, lij = np.asarray(lj), np.asarray(lij)
    assert np.abs(l.numpy() - lj).max() / np.abs(lj).max() <= 1e-12
    assert np.abs(li.numpy() - lij).max() / np.abs(lij).max() <= 1e-12
    a32 = a.float()
    l32, li32, _ = emulate(a32)
    with pltpu.force_tpu_interpret_mode():
        lk, lik = pallas_chol.chol_inv_batched_safe(jnp.asarray(a32.numpy()))
    lk, lik = np.asarray(lk), np.asarray(lik)
    assert np.abs(l32.numpy() - lk).max() / np.abs(lk).max() <= 1e-5
    assert np.abs(li32.numpy() - lik).max() / np.abs(lik).max() <= 1e-5


def _constants():
    text = chol_inv.SOURCE.read_text()
    header = (CSRC / "chol_inv_cluster.cuh").read_text()
    assert '#include "chol_inv_cluster.cuh"' in text
    get = {name: int(re.search(rf"constexpr int {name} = (\d+);", header).group(1)) for name in ("kB", "kThreads")}
    get["kCluster"] = int(re.search(r"#define K1_CLUSTER (\d+)", text).group(1))
    get["kLdPad"] = int(re.search(r"constexpr int kLd = kB \+ (\d+);", header).group(1))
    return get


def test_the_source_is_the_emulated_schedule_and_fits_shared_memory():
    """The block width is the emulation's (the header's); the shipped
    cluster size is a portable one; at every N the kernel takes, each tile lives in exactly
    one CTA's slot, and a CTA's shared memory (its slots, the operand
    buffer, L_kk, the leaf's columns and flags) fits the H100's 227 KB."""
    c = _constants()
    assert c["kB"] == B and c["kCluster"] in CLUSTER_SIZES and c["kThreads"] == B * B // 4
    tile_bytes = 4 * B * (B + c["kLdPad"])
    for n in range(1, chol_inv.MAX_N + 1):
        nb = -(-n // B)
        ntiles = nb * (nb + 1) // 2
        place = [(t % c["kCluster"], t // c["kCluster"]) for t in range(ntiles)]
        assert len(set(place)) == ntiles
        slots = -(-ntiles // c["kCluster"])
        assert max(s for _, s in place) < slots
        smem = (slots + nb + 1) * tile_bytes + 4 * (2 * B + 4)
        assert smem <= 232448, (n, smem)
