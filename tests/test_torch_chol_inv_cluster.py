"""K1's cluster schedule (csrc/chol_inv_cluster.cu), emulated in torch.

There is no card here, so the kernel cannot run; this file replays its
arithmetic in the kernel's order, step by step, and holds the result to
what chip_smoke.py's k1 phase holds the kernel to.  The member is padded
to a multiple of 32 with an identity block and kept as 32 × 32 tiles of
its lower triangle.  Block step k: the one-warp leaf factors S_kk and
inverts L_kk in one pass of 32 column steps (rsqrt, rank-1 updates); the
panel L_ik = S_ik L_kk⁻ᵀ and row k of L⁻¹, X_kj = L_kk⁻¹ W_kj, by forward
substitution; then every tile below row k takes its rank-32 update, the 32
products of each entry summed first and applied once: W_ij − L_ik X_kj
(j < k), −L_ik X_kk (j = k), S_ij − L_ik L_jkᵀ (j > k).  A non-positive or
non-finite pivot fails the try; a non-finite panel entry fails it after
the last step; a failed try restarts from A + j·I up the ladder.

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

from nonstationary_precip_tpu.ops import linalg as jax_linalg
from nonstationary_precip_tpu.ops import pallas_chol
from nonstationary_precip_tpu_torch.ops import chol_inv

torch.set_num_threads(1)

B = 32  # the kernel's block width (kB)
CLUSTER_SIZES = (1, 2, 4, 8)

# chip_smoke.py's k1 criterion
TOL_L_F64, TOL_LINV_RESIDUAL, TOL_KERNEL_PLAIN = 5e-6, 5e-5, 1e-5


def _leaf(s):
    """L_kk and L_kk⁻¹ of a 32 × 32 tile by the leaf's 32 column steps, or
    None where a pivot is not > 0 or an entry is not finite."""
    a = torch.tril(s).clone()
    x = torch.eye(B, dtype=s.dtype)
    lo = torch.zeros_like(s)
    xo = torch.zeros_like(s)
    for k in range(B):
        d = a[k, k]
        rs = torch.rsqrt(d)
        lcol = torch.zeros(B, dtype=s.dtype)
        lcol[k + 1:] = a[k + 1:, k] * rs
        lcol[k] = d * rs
        xk = x[k] * rs
        if not (bool(d > 0) and bool(torch.isfinite(lcol).all()) and bool(torch.isfinite(xk).all())):
            return None
        lo[:, k] = lcol
        xo[k] = xk
        a[:, k + 1:] -= lcol[:, None] * lcol[None, k + 1:]
        x[k + 1:] -= lcol[k + 1:, None] * xk[None, :]
    return lo, xo


def _substitute_rows(l, v):
    """Each row y of v solved from L y = v_row by forward substitution."""
    v = v.clone()
    for m in range(B):
        s = v[:, :m] @ l[m, :m] if m else torch.zeros(v.shape[0], dtype=v.dtype)
        v[:, m] = (v[:, m] - s) / l[m, m]
    return v


def _one_try(a, n, jit):
    """(L, L⁻¹) of the padded member A + jit·I by the block schedule, or
    None where the try fails."""
    nb = -(-n // B)
    npad = nb * B
    full = torch.eye(npad, dtype=a.dtype)
    full[:n, :n] = a + jit * torch.eye(n, dtype=a.dtype)
    w = {(i, j): full[i * B:(i + 1) * B, j * B:(j + 1) * B].clone() for i in range(nb) for j in range(i + 1)}
    lo = torch.zeros(npad, npad, dtype=a.dtype)
    xo = torch.zeros(npad, npad, dtype=a.dtype)
    bad = False
    for k in range(nb):
        out = _leaf(w[k, k])
        if out is None:
            return None
        lkk, xkk = out
        lo[k * B:(k + 1) * B, k * B:(k + 1) * B] = lkk
        xo[k * B:(k + 1) * B, k * B:(k + 1) * B] = xkk
        for i in range(k + 1, nb):  # the panel, a row a lane
            w[i, k] = _substitute_rows(lkk, w[i, k])
            bad = bad or not bool(torch.isfinite(w[i, k]).all())
            lo[i * B:(i + 1) * B, k * B:(k + 1) * B] = w[i, k]
        for j in range(k):  # row k of L⁻¹, a column a lane
            w[k, j] = _substitute_rows(lkk, w[k, j].T).T
            bad = bad or not bool(torch.isfinite(w[k, j]).all())
            xo[k * B:(k + 1) * B, j * B:(j + 1) * B] = w[k, j]
        buf = {j: w[k, j] for j in range(k)}  # X_kj, natural
        buf[k] = xkk
        buf.update({i: w[i, k].T for i in range(k + 1, nb)})  # L_ik^T
        for i in range(k + 1, nb):
            for j in range(i + 1):
                prod = buf[i].T @ buf[j]
                w[i, j] = -prod if j == k else w[i, j] - prod
    if bad:
        return None
    return lo[:n, :n], xo[:n, :n]


def emulate(mats, jitter=1e-5, max_tries=6):
    """The kernel's (L, L⁻¹, jitter per member), member by member."""
    t, n, _ = mats.shape
    ls, lis, jits = [], [], []
    for m in range(t):
        jit = np.array(0.0, dtype=np.float32 if mats.dtype == torch.float32 else np.float64)
        out = None
        for attempt in range(max_tries + 1):
            if attempt:
                jit = jit.dtype.type(jitter) if jit == 0 else jit * jit.dtype.type(10.0)
            out = _one_try(mats[m], n, torch.tensor(jit, dtype=mats.dtype))
            if out is not None:
                break
        if out is None:
            out = (torch.full((n, n), float("nan"), dtype=mats.dtype),) * 2
        ls.append(out[0])
        lis.append(out[1])
        jits.append(float(jit))
    return torch.stack(ls), torch.stack(lis), torch.tensor(jits, dtype=mats.dtype)


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
    get = {name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1)) for name in ("kB", "kThreads")}
    get["kCluster"] = int(re.search(r"#define K1_CLUSTER (\d+)", text).group(1))
    get["kLdPad"] = int(re.search(r"constexpr int kLd = kB \+ (\d+);", text).group(1))
    return get


def test_the_source_is_the_emulated_schedule_and_fits_shared_memory():
    """The block width is the emulation's; the shipped cluster size is a
    portable one; at every N the kernel takes, each tile lives in exactly
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
