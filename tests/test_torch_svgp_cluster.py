"""K4's cluster schedule (csrc/svgp_precompute.cu on csrc/chol_inv_cluster.cuh),
emulated in torch.

There is no card here, so the kernel cannot run.  tests/cluster_emulation.py
replays the header's block steps, here with K4's Source: the Gram tiles as
the kernel builds them from z/ℓ and s² (z/ℓ by IEEE division, the squared
norms and cross products summed in ascending dims with a rounding each,
q = (|z_r|² + |z_c|²) − 2 z_r·z_c clamped at 0, s²·exp(−q/2), the diagonal
exactly s² + ε), the substitutions' product with the diagonal's
reciprocal, and K4's ladder
(+1e-4, then +1e-2, at most 3 tries, the diagonal accumulating in f32 as
((s² + ε) + 1e-4) + 1e-2).  Then the cluster's tail: W = L⁻ᵀP, each
output a sum over k in ascending order.
This file holds the result to what chip_smoke.py's k4 phase holds the
kernel to: against float64 within twice the plain version's error plus
K4_SLACK, L⁻¹'s residual and W within γ_M of their entrywise bounds, and
L's backward error within γ_(M+1)|L||Lᵀ| (Higham, Theorem 10.3), on the
deep GP's K_zz stack at init (50 × 250, from ``deepgp_spatial.prep_split``
on the CPU) and a ragged (3, 37, D 3).  The replay fuses every
multiply-add as the card does (tests/cluster_emulation.py); these are the
card's criteria, not its bits.  The ragged payload's K_zz reaches
condition numbers of ~8e5, where two f32 factorisations land at errors
from float64 whose ratio is noise around 1 (1.9× in W on this draw, a
median of 1.4 over seeds 30–49 of the same draw).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import nonstationary_precip_tpu.ops.pallas_svgp as ps
from cluster_emulation import emulate, pad
from test_torch_chol_rl import _c_signatures, _FakeLib
from nonstationary_precip_tpu_torch.ops import svgp_precompute as sp
from nonstationary_precip_tpu_torch.ops.cuda_build import CSRC
from nonstationary_precip_tpu_torch.utils.config import EPSILON

torch.set_num_threads(1)

# chip_smoke.py's k4 criteria
K4_SLACK = {"L": 1e-5, "W": 1e-3, "Linv": 1e-3}
K4_RETRY_RECON = 5e-2
F32 = torch.float32


class GramSource:
    """K4's Source: the f32 Gram of z/ℓ as the kernel builds it, K4's ladder,
    the substitutions multiplying by the diagonal's reciprocal."""

    tries = 3
    recip = True

    def __init__(self, z, ell, s2):
        zs = z / ell[:, None, :]
        sq = zs[..., 0] * zs[..., 0]
        cross = zs[:, :, None, 0] * zs[:, None, :, 0]
        for k in range(1, z.shape[-1]):
            sq = sq + zs[..., k] * zs[..., k]
            cross = cross + zs[:, :, None, k] * zs[:, None, :, k]
        q = (sq[:, :, None] + sq[:, None, :]) - 2.0 * cross
        self.gram = s2[:, None, None] * torch.exp(-0.5 * torch.clamp(q, min=0.0))
        self.s2 = s2

    def jitter(self, prev, attempt):
        return float(np.float32([0.0, 1e-4, np.float32(1e-4) + np.float32(1e-2)][attempt]))

    def matrix(self, attempt, jit, idx):
        k = self.gram[idx].clone()
        dg = self.s2[idx] + EPSILON
        for extra in (1e-4, 1e-2)[:attempt]:
            dg = dg + extra
        torch.diagonal(k, dim1=-2, dim2=-1).copy_(dg[:, None].expand(-1, k.shape[-1]))
        return pad(k, k.shape[-1])


def emulate_k4(z, ell, s2, packed):
    """The kernel's (L, W, L⁻¹, jitter per member): the factor, then the
    tail's ascending-k sums over the padded L⁻¹ (zero rows of P past M)."""
    t, m, _ = z.shape
    l, li, jit, (_, li_pad) = emulate(GramSource(z, ell, s2), t, m, F32)
    npad = li_pad.shape[-1]
    pp = torch.zeros(t, npad, packed.shape[-1], dtype=F32)
    pp[:, :m] = packed
    acc = torch.zeros(t, npad, packed.shape[-1], dtype=F32)
    for k in range(npad):  # W[i] = Σ_{k ≥ i} L⁻¹[k, i] P[k], k ascending
        acc[:, :k + 1] += li_pad[:, k, :k + 1, None] * pp[:, k, None, :]
    return l, acc[:, :m], li, jit


def _f64(args, jit):
    z, ell, s2, packed = (a.double() for a in args)
    k = sp.gram_zz_plain(z, ell, s2) + jit.double()[:, None, None] * torch.eye(z.shape[1], dtype=torch.float64)
    l = torch.linalg.cholesky(k)
    eye = torch.eye(k.shape[-1], dtype=torch.float64).expand_as(k)
    li = torch.linalg.solve_triangular(l, eye, upper=False)
    return k, (l, li.mT @ packed, li)


def k4_criteria(args, out, vs_plain=True):
    """chip_smoke.py's k4 checks of (L, W, L⁻¹, jitter), plus L's backward
    error; returns the ratios.  ``vs_plain`` False leaves out the one
    against the plain version's error (see the interpret-mode test)."""
    plain = sp.svgp_precompute_plain(*args)
    assert all(bool(torch.isfinite(a).all()) for a in out[:3])
    assert bool((torch.triu(out[0], 1) == 0).all() and (torch.triu(out[2], 1) == 0).all())
    k64, ref_k = _f64(args, out[3])
    _, ref_p = _f64(args, plain[3])
    for i, name in enumerate(("L", "W", "Linv")):
        ek = float((out[i].double() - ref_k[i]).abs().max())
        ep = float((plain[i].double() - ref_p[i]).abs().max())
        assert ek <= 2 * ep + K4_SLACK[name] or not vs_plain, (name, ek, ep)
    l, w, li = (a.double() for a in out[:3])
    packed = args[3].double()
    m = l.shape[-1]
    gamma = m * 2.0**-24 / (1 - m * 2.0**-24)
    eye = torch.eye(m, dtype=torch.float64)
    ratios = {}
    for name, diff, scale in (("Linv", l @ li - eye, l.abs() @ li.abs()),
                              ("W", w - li.mT @ packed, li.abs().mT @ packed.abs())):
        ratios[name] = float((diff.abs() / (gamma * scale + 1e-300)).max())
    g1 = (m + 1) * 2.0**-24 / (1 - (m + 1) * 2.0**-24)
    ratios["L_backward"] = float(((l @ l.mT - k64).abs() / (g1 * (l.abs() @ l.abs().mT) + (m + 1) * 2.0**-149)).max())
    for name, r in ratios.items():
        assert r <= 1.0, (name, r)
    return ratios, plain


def _kzz_at_init():
    """K4's inputs on the deep GP's path at init: every layer of every split
    (10 splits × 5 outputs, M = 250, D 2, P 501), built on the CPU."""
    from nonstationary_precip_tpu_torch.data.dataprep import load_csv
    from nonstationary_precip_tpu_torch.experiments import deepgp_spatial
    from nonstationary_precip_tpu_torch.models.svgp import precompute_inputs
    from nonstationary_precip_tpu_torch.train.vmapped import stack_modules
    from nonstationary_precip_tpu_torch.utils.config import DATASET_DIR

    cfg = deepgp_spatial.default_config().parse_args(["--num_epochs", "1", "--device", "cpu"])
    data = load_csv(DATASET_DIR / "uib_spatial.csv")
    model = stack_modules([deepgp_spatial.prep_split(data, s, cfg)[0] for s in range(cfg.num_splits)])
    with torch.no_grad():
        return tuple(a.detach().contiguous() for a in precompute_inputs(list(model.layers) + [model.head]))


def _ragged():
    """chip_smoke.py's ragged K4 payload, (3, 37, D 3), P = 2M + 1."""
    gen = torch.Generator().manual_seed(37)
    rt, rm, rd = 3, 37, 3
    return (torch.randn(rt, rm, rd, generator=gen), torch.exp(0.3 * torch.randn(rt, rd, generator=gen)) + 0.3,
            torch.exp(0.2 * torch.randn(rt, generator=gen)), torch.randn(rt, rm, 2 * rm + 1, generator=gen))


@pytest.mark.parametrize("name", ["init_kzz", "ragged"])
def test_schedule_meets_the_k4_criteria(name):
    """The f32 schedule on the path's K_zz stack at init and on the ragged
    payload: finite, lower triangular, the plain version's jitter, within
    chip_smoke.py's criteria and L's backward-error bound."""
    args = _kzz_at_init() if name == "init_kzz" else _ragged()
    if name == "init_kzz":
        assert tuple(args[0].shape) == (50, 250, 2) and args[3].shape[-1] == 501
    out = emulate_k4(*args)
    _, plain = k4_criteria(args, out)
    assert torch.equal(out[3], plain[3])


def _retry_payload():
    """chip_smoke.py's retry case: member 1 has a duplicated z at s² = 40
    (K_zz's least eigenvalue ≈ 2ε: a plain f32 factor fails), member 0 is
    healthy."""
    gen = torch.Generator().manual_seed(41)
    z = torch.randn(2, 128, 2, generator=gen)
    good = (z.clone(), torch.ones(2, 2), torch.tensor([1.0, 1.0]), torch.randn(2, 128, 257, generator=gen))
    z[1, 64] = z[1, 32]
    bad = (z, good[1], torch.tensor([1.0, 40.0]), good[3])
    return good, bad


def test_retry_ladder_isolates_the_member_like_the_plain_version():
    """Only the bad member climbs the ladder, to the plain version's rung;
    its L Lᵀ reconstructs K + jI to 5e-2; the healthy member is bitwise the
    one of an all-healthy run; every output finite."""
    good, bad = _retry_payload()
    l_a, w_a, li_a, j_a = emulate_k4(*good)
    l_b, w_b, li_b, j_b = emulate_k4(*bad)
    _, _, _, pj_b = sp.svgp_precompute_plain(*bad)
    assert not bool(j_a.any())
    assert float(j_b[0]) == 0.0 and float(j_b[1]) > 0.0 and torch.equal(j_b, pj_b)
    assert all(bool(torch.isfinite(a).all()) for a in (l_b, w_b, li_b))
    for a, b in ((l_a, l_b), (w_a, w_b), (li_a, li_b)):
        assert torch.equal(a[0], b[0])
    kk = sp.gram_zz_plain(*(a.double() for a in bad[:3]))[1] + float(j_b[1]) * torch.eye(128, dtype=torch.float64)
    assert float((l_b[1].double() @ l_b[1].double().T - kk).abs().max()) <= K4_RETRY_RECON


def test_a_member_that_never_factors_comes_back_nan():
    """An indefinite K (s² < 0) fails all three rungs: NaN in L, L⁻¹ and W,
    the jitter of the last rung; the other member is untouched."""
    gen = torch.Generator().manual_seed(19)
    args = (torch.randn(2, 16, 2, generator=gen), torch.ones(2, 2), torch.tensor([1.0, -1.0]),
            torch.randn(2, 16, 33, generator=gen))
    l, w, li, jit = emulate_k4(*args)
    assert all(bool(torch.isfinite(a[0]).all()) and not bool(torch.isfinite(a[1]).any()) for a in (l, w, li))
    assert jit.tolist() == [0.0, float(np.float32(1e-4) + np.float32(1e-2))]


def _small(rng, spread, ell_scale):
    t, m, d = 2, 48, 2
    return (torch.from_numpy((spread * rng.normal(size=(t, m, d))).astype(np.float32)),
            torch.from_numpy((ell_scale * (np.exp(rng.normal(size=(t, d)) * 0.3) + 0.3)).astype(np.float32)),
            torch.from_numpy(np.exp(rng.normal(size=t) * 0.2).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(t, m, 2 * m + 1)).astype(np.float32)))


def _jax_k4(args):
    with pltpu.force_tpu_interpret_mode():
        return [torch.from_numpy(np.array(a))
                for a in ps.svgp_precompute_fused(*(jnp.asarray(a.numpy()) for a in args))]


def test_schedule_matches_jax_k4_in_interpret_mode():
    """At a small T against the JAX package's Pallas kernel (interpret mode,
    as tests/test_pallas.py runs it).  On a well-conditioned K_zz (inducing
    points spread wide against ℓ, condition numbers 2e2–7e2) the two f32
    factorisations agree to 1e-4 of each output's largest entry: each lies
    within ~4e-5 of float64 there (measured), in another order of sums.  On
    a near-singular one (z ~ N(0, 1) at ℓ ≈ 1) two f32 factorisations that
    round in other orders cannot be held to each other: there the JAX kernel
    is held to float64 within twice the port's plain version's error plus
    K4_SLACK, and the schedule to its γ bounds.  (On 20 such draws the
    replay's error was 2.6× the CPU plain version's at the median; on an
    H100 the kernel stayed within 1.01× of the card's plain version's on the
    path's payloads, where the card's plain version is itself up to 4.8×
    further from float64 than the CPU's.)"""
    rng = np.random.default_rng(173)
    args = _small(rng, 3.0, 0.5)
    out, kj = emulate_k4(*args), _jax_k4(args)
    assert not bool(out[3].any())
    for i in range(3):
        assert float((out[i] - kj[i]).abs().max()) <= 1e-4 * float(kj[i].abs().max()), i
    args = _small(rng, 1.0, 1.0)
    out, kj = emulate_k4(*args), _jax_k4(args)
    k4_criteria(args, out, vs_plain=False)
    plain = sp.svgp_precompute_plain(*args)
    _, ref = _f64(args, plain[3])
    for i, name in enumerate(("L", "W", "Linv")):
        ej = float((kj[i].double() - ref[i]).abs().max())
        ep = float((plain[i].double() - ref[i]).abs().max())
        assert ej <= 2 * ep + K4_SLACK[name], (name, ej, ep)


def _constants():
    text = sp.SOURCE.read_text()
    header = (CSRC / "chol_inv_cluster.cuh").read_text()
    get = {name: int(re.search(rf"constexpr int {name} = (\d+);", header).group(1)) for name in ("kB", "kThreads")}
    get["kLdPad"] = int(re.search(r"constexpr int kLd = kB \+ (\d+);", header).group(1))
    get["kCluster"] = int(re.search(r"#define K4_CLUSTER (\d+)", text).group(1))
    get["kMinBlocks"] = int(re.search(r"#define K4_MIN_BLOCKS (\d+)", text).group(1))
    get["kWC"] = int(re.search(r"constexpr int kWC = (\d+);", text).group(1))
    get["kMaxM"] = int(re.search(r"constexpr int kMaxM = (\d+);", text).group(1))
    get["kMaxD"] = int(re.search(r"constexpr int kMaxD = (\d+);", text).group(1))
    return get


def test_source_is_on_the_cluster_header_and_fits_shared_memory():
    """svgp_precompute.cu builds on chol_inv_cluster.cuh and no longer on
    chol_sweep.cuh, with one kernel and one launch; its limits are the
    wrapper's; a portable cluster size; and at every M ≤ 256 and D ≤ 8 a
    CTA's shared memory (the factor's slots, operand buffer, L_kk, the
    leaf's columns and flags; z/ℓ and the norms; the tail's two P stages)
    fits the H100's 227 KB, kMinBlocks of them an SM at the path's (250, 2)."""
    text = sp.SOURCE.read_text()
    assert '#include "chol_inv_cluster.cuh"' in text and "chol_sweep" not in text
    assert len(re.findall(r"__global__", text)) == 1 and len(re.findall(r"<<<", text)) == 1
    c = _constants()
    assert (c["kMaxM"], c["kMaxD"]) == (sp.MAX_M, sp.MAX_D)
    assert c["kB"] == 32 and c["kCluster"] in (1, 2, 4, 8) and c["kThreads"] == (c["kB"] // 4) * (c["kWC"] // 2)
    tile = c["kB"] * (c["kB"] + c["kLdPad"])

    def smem(m, d):
        nb = -(-m // c["kB"])
        slots = -(-(nb * (nb + 1) // 2) // c["kCluster"])
        floats = (slots + nb + 1) * tile + 2 * c["kB"] + 4 + 4 * -(-(m * d + m) // 4) + 2 * c["kB"] * c["kWC"]
        return 4 * floats

    for m in range(1, sp.MAX_M + 1):
        for d in (1, 2, 3, sp.MAX_D):
            assert smem(m, d) <= 232448, (m, d, smem(m, d))
    assert c["kMinBlocks"] * (smem(250, 2) + 1024) <= 233472  # the SM's 228 KB, 1 KB reserved a CTA


def test_ctypes_argtypes_match_the_c_entry_points(monkeypatch):
    """The wrapper binds every extern "C" function of its source, each with
    as many arguments as the C function takes (tests/test_torch_chol_rl.py
    checks that what a wrapper binds exists; this, that nothing of K4's C
    interface goes unbound)."""
    lib = _FakeLib()
    monkeypatch.setattr(sp, "build_library", lambda source, force=False: (lib, ""))
    monkeypatch.setattr(sp, "_lib", None)
    sp.build()
    sigs = _c_signatures(sp.SOURCE)
    bound = {k: len(v.argtypes) for k, v in lib.fns.items() if hasattr(v, "argtypes")}
    assert bound == sigs
    assert sigs["svgp_precompute"] == 14 and sigs["svgp_smem_bytes"] == 2 and sigs["svgp_max_clusters"] == 2
