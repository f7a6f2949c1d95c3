"""K7: the fused DSVI ELBO data term of the deep GP, forward and hand-derived
backward, by hand for Hopper.

Replaces ``nonstationary_precip_tpu/ops/pallas_elbo.py::fused_data_term``
(:468): the forward ``_pallas_fwd`` (:282, ``pallas_call`` at :290, body
``_elbo_fwd_kernel`` :133) and the backward ``_pallas_bwd`` (:331,
``pallas_call`` at :339, body ``_elbo_bwd_kernel`` :565).  For each member
t of a stack (one deep GP of 2 hidden SVGP layers of width 2 and a scalar
head, per split) it computes

    data_term_t = mean_S mean_B E[log N(y | f_head, σ²)]

downstream of K4: layer 1's marginals at x (once per row, shared by the S
samples), h₁ = m₁ + √v₁·ε₁, layer 2's marginals at h₁, h₂ = m₂ + √v₂·ε₂,
the head's marginals at h₂ and the closed-form expected log-likelihood.
Each group's marginals come from K_xz (s²·RBF, from the norms and the
cross product, clamped at 0) and out = K_xz·W, W = L⁻ᵀ[m | tril S | I]
from K4: mean = out[0], var = s² − Σ out[M+1:]² + Σ out[1:M+1]², clamped
at 1e-10.  The backward returns the cotangents of W, z, ℓ, s², the mean
weights, σ² and y; W's flows on into K4's backward.  ε and x take none.

The parameters are one dict in the layout of the TPU kernel's packed
operands, a leading member axis T on each: the five output groups stacked
in the order [layer 1 dim 0, dim 1, layer 2 dim 0, dim 1, head],
  z (T, 5, M, 2), ell (T, 5, 2), s2 (T, 5), w (T, 5, M, 2M + 1),
and the mean weights mw1 (T, 2, 2) and mw2 (T, 2, 2) as [input, output],
mb1 (T, 2), mb2 (T, 2), mbh (T, 1).  x (T, B, 2), y (T, B), ε₁ and ε₂
(T, S, 2, B), σ² (T,).  The stacks are the ones K4 already takes and gives
(``models/svgp.precompute_inputs``), so neither pass copies W.

What bounds it on an H100.  At the deep GP's shape (T = 10 splits, B = 315,
S = 3, M = 250, P = 501) the forward is 2·T·(2 + 3S)·B·M·P ≈ 8.7·10⁹
operations (the eleven K_xz·W products per x row) and the backward ~3×
that (out again, outbar·Wᵀ, and W̄ = K_xzᵀ·outbar); W (25 MB) is read once
and W̄ written once, so both passes are bound by operations: ≥ 0.13 ms and
≥ 0.39 ms at 67 TFLOP/s.

What the design does about it (``csrc/elbo_fused.cu``).  Both passes run
in phases over whole members, one layer a launch, so that each product is
one large, evenly spread GEMM, and they share the marginals' two kernels:
K_xz of a layer's groups at every row, then out = K_xz·W over every member
and group of the layer (64 × 128 tiles), with each row's Σ(A·S)² and ΣA²
per column tile as its epilogue, added in tile order.  So the forward's
per-row means and variances are the backward's to the bit
(``forward_moments`` and ``backward_moments`` give both).  The forward: the
marginals of layer 1 at the x rows, then a row kernel (the mean, the
variance and h₁ = m₁ + √v₁·ε₁ of every sample); the same at the sample rows
for layer 2 (h₂) and for the head, whose row kernel adds each 64-row tile's
expected log-likelihood terms; then the tiles in order into the data term:
ten launches.  ``out`` never reaches scratch in the forward; K_xz does
(~3.5 MB a member).  The backward: K_xz and out of every group at every
row, then the chain backwards (the head's row cotangents; its pullback
kbar = outbar·Wᵀ in 64-row × 128-inducing-point tiles, with g = kbar·K_xz,
the input cotangent and the column sums of g in the epilogue; layer 2's;
its pullback; layer 1's, summed over each x row's samples; its pullback),
then W̄ = K_xzᵀ·outbar in 128 × 128 tiles, then the small cotangents.  The
products are register-tiled FFMA GEMMs (8 × 4 or 8 × 8 a thread) whose
k-slabs come through a 3-stage ``cp.async`` ring.  K_xz and out/outbar live
in scratch (~10 MB a member).  Every cross-row sum (the data term, W̄, z̄,
ℓ̄, s̄², the mean weights, σ̄², ȳ) is a partial with its own slot, added in
a fixed order by a later launch: no atomics, so the result is the same
bits on every run.  Not carried over from the TPU: the 128-lane padding of
P and M, the mask vectors, the (16, 128) packed small output.  Plain f32:
IEEE division, ``expf``, ``sqrtf``, ``logf``, no tensor cores; every
product is written out in the kernel.

The clip semantics are the JAX package's: the forward clamps each variance
at 1e-10; the backward takes √ of max(var, 1e-10) and zeroes the variance's
cotangent where the unclipped variance is ≤ 1e-10.

Dispatch: on a CPU tensor ``fused_data_term`` runs the plain version
(``reference_fwd``, ``reference_bwd``: the JAX package's ``_reference_fwd``
and hand-derived ``_reference_bwd``, batched over members); on a CUDA
tensor the kernels, or it raises.  ``LAUNCHES`` counts calls of the
wrappers: one per forward pass and one per backward pass, whatever number
of CUDA kernels each launches back to back (ten each), and one per call of
``backward_moments``, which no path makes.
"""

from __future__ import annotations

import ctypes
import math

import torch

from nonstationary_precip_tpu_torch.ops.cuda_build import CSRC, build_library

#: The parameter dict's keys, in the order the autograd Function takes them.
PARAM_KEYS = ("z", "ell", "s2", "w", "mw1", "mb1", "mw2", "mb2", "mbh")

#: The gate of the TPU kernel (``pallas_elbo.py:440-464``): the largest
#: inducing count and batch it takes.
MAX_M = 256
MAX_B = 1024
#: The most members one call takes (5 groups each on the grid's z extent).
MAX_T = 65535 // 5

#: Variance floor of the marginals.
VAR_FLOOR = 1e-10

#: Wrapper calls so far in this process, one per forward and one per
#: backward pass; a run reads them to show that its main path went through
#: the kernels.
LAUNCHES = {"elbo_data_term_fwd": 0, "elbo_data_term_bwd": 0, "elbo_bwd_moments": 0}

SOURCE = CSRC / "elbo_fused.cu"

_lib = None

_LAYER1, _LAYER2, _HEAD = slice(0, 2), slice(2, 4), slice(4, 5)


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------


def ineligible(x: torch.Tensor, z1_shape, z2_shape, zh_shape, *, any_float: bool = False):
    """Why the fused term does not take this call, or None where it does: the
    TPU kernel's gate without its environment and backend conditions.  x
    (..., B, D) and the three layers' z shapes (..., O, M, D): layer 1 and 2
    of width 2, a scalar head, D = 2 throughout, one M ≤ 256, B ≤ 1024, and
    float32 (any float dtype where ``any_float``)."""
    m = z1_shape[-2]
    if tuple(z1_shape[-3:]) != (2, m, 2) or tuple(z2_shape[-3:]) != (2, m, 2) or tuple(zh_shape[-3:]) != (1, m, 2):
        return (f"the fused data term takes z of (2, M, 2), (2, M, 2), (1, M, 2) with one M; got "
                f"{tuple(z1_shape[-3:])}, {tuple(z2_shape[-3:])}, {tuple(zh_shape[-3:])}")
    if x.shape[-1] != 2:
        return f"the fused data term takes D = 2 inputs, got D = {x.shape[-1]}"
    if m > MAX_M or x.shape[-2] > MAX_B:
        return f"the fused data term takes M <= {MAX_M} and B <= {MAX_B}, got M = {m}, B = {x.shape[-2]}"
    if not (x.dtype.is_floating_point if any_float else x.dtype == torch.float32):
        return f"the fused data term takes {'a float dtype' if any_float else 'float32'}, got {x.dtype}"
    return None


def eligible(x: torch.Tensor, z1_shape, z2_shape, zh_shape) -> bool:
    """Whether the fused term takes this call (``ineligible`` is None)."""
    return ineligible(x, z1_shape, z2_shape, zh_shape) is None


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def _cross(h, z, ell, s2):
    """K_xz per group: h (T, R, D) against z (T, O, M, D) → (T, O, R, M)."""
    xs = h[:, None] / ell[:, :, None, :]
    zs = z / ell[:, :, None, :]
    x_sq = torch.sum(xs * xs, dim=-1)
    z_sq = torch.sum(zs * zs, dim=-1)
    quad = torch.clamp(x_sq[..., :, None] + z_sq[..., None, :] - 2.0 * (xs @ zs.mT), min=0.0)
    return s2[..., None, None] * torch.exp(-0.5 * quad)


def _marginals(h, z, ell, s2, w):
    """(mean without the prior mean (T, O, R), unclipped var (T, O, R),
    K_xz (T, O, R, M), out = K_xz·W (T, O, R, P)) of one layer's groups."""
    k = _cross(h, z, ell, s2)
    out = k @ w
    m = z.shape[-2]
    a_s = out[..., 1:m + 1]
    a = out[..., m + 1:]
    var = s2[..., None] - torch.sum(a * a, dim=-1) + torch.sum(a_s * a_s, dim=-1)
    return out[..., 0], var, k, out


def _groups(params, sl):
    return params["z"][:, sl], params["ell"][:, sl], params["s2"][:, sl], params["w"][:, sl]


def reference_fwd(x, y, eps1, eps2, params, noise):
    """The data term per member (T,), and the residuals of the backward: the
    JAX package's ``_reference_fwd`` (``pallas_elbo.py:68``), batched over
    the member axis, with each sample's rows side by side (row s·B + b)."""
    t, b, _ = x.shape
    s = eps1.shape[1]
    m1, v1, _, _ = _marginals(x, *_groups(params, _LAYER1))
    m1 = m1 + (x @ params["mw1"] + params["mb1"][:, None, :]).mT  # (T, 2, B)
    v1 = torch.clamp(v1, min=VAR_FLOOR)
    h1 = (m1[:, None] + torch.sqrt(v1)[:, None] * eps1).mT.reshape(t, s * b, 2)  # (T, S·B, 2)
    m2, v2, _, _ = _marginals(h1, *_groups(params, _LAYER2))
    m2 = m2 + (h1 @ params["mw2"] + params["mb2"][:, None, :]).mT
    e2 = eps2.transpose(1, 2).reshape(t, 2, s * b)
    h2 = (m2 + torch.sqrt(torch.clamp(v2, min=VAR_FLOOR)) * e2).mT  # (T, S·B, 2)
    mh, vh, _, _ = _marginals(h2, *_groups(params, _HEAD))
    mh = (mh[:, 0] + params["mbh"]).reshape(t, s, b)
    vh = torch.clamp(vh[:, 0], min=VAR_FLOOR).reshape(t, s, b)
    n3 = noise[:, None, None]
    ell = -0.5 * (torch.log(2.0 * math.pi * n3) + ((y[:, None] - mh) ** 2 + vh) / n3)
    return torch.mean(torch.mean(ell, dim=-1), dim=-1), (v1, h1, h2, mh, vh)


def _marginals_vjp(h, z, ell, s2, w, meanbar, varbar):
    """Pullback of one layer's marginals to (h̄ (T, R, D), z̄, ℓ̄, s̄², W̄),
    recomputing K_xz and out: ``pallas_elbo.py::_layer_marginals_vjp`` and
    ``_rbf_cross_vjp`` (:693-745).  meanbar, varbar (T, O, R)."""
    _, var, k, out = _marginals(h, z, ell, s2, w)
    varbar = torch.where(var > VAR_FLOOR, varbar, torch.zeros_like(varbar))
    m = z.shape[-2]
    outbar = torch.cat([meanbar[..., None], 2.0 * varbar[..., None] * out[..., 1:m + 1],
                        -2.0 * varbar[..., None] * out[..., m + 1:]], dim=-1)
    wbar = k.mT @ outbar
    g = (outbar @ w.mT) * k  # (T, O, R, M)
    g_rows, g_cols = torch.sum(g, dim=-1), torch.sum(g, dim=-2)
    hh = h[:, None]  # (T, 1, R, D)
    inv_l2 = (1.0 / (ell * ell))[:, :, None, :]
    gz = g @ z  # (T, O, R, D)
    hbar = torch.sum(-(g_rows[..., None] * hh - gz) * inv_l2, dim=1)
    zbar = -(g_cols[..., None] * z - g.mT @ hh) * inv_l2
    sq = (torch.sum(g_rows[..., None] * hh * hh, dim=-2) + torch.sum(g_cols[..., None] * z * z, dim=-2)
          - 2.0 * torch.sum(gz * hh, dim=-2))
    ellbar = sq / ell**3
    s2bar = torch.sum(g, dim=(-2, -1)) / s2 + torch.sum(varbar, dim=-1)
    return hbar, zbar, ellbar, s2bar, wbar


def reference_bwd(x, y, eps1, eps2, params, noise, res, gbar):
    """The hand-derived pullback of ``reference_fwd``, each cotangent scaled
    by gbar (T,): the JAX package's ``_reference_bwd``
    (``pallas_elbo.py:748``), batched over members.  Returns (the
    cotangents as a dict of ``PARAM_KEYS``, σ̄² (T,), ȳ (T, B))."""
    v1, h1, h2, mh, vh = res
    t, b, _ = x.shape
    s = eps1.shape[1]
    c3 = (gbar / (s * b))[:, None, None]
    n3 = noise[:, None, None]
    diff = mh - y[:, None]
    mhbar = c3 * (-diff / n3)  # (T, S, B)
    vhbar = c3 * (-0.5 / n3) * torch.ones_like(vh)
    noisebar = torch.sum(c3 * (-0.5 / n3 + 0.5 * ((y[:, None] - mh) ** 2 + vh) / (n3 * n3)), dim=(1, 2))
    ybar = torch.sum(c3 * (-(y[:, None] - mh) / n3), dim=1)

    h2bar, zb_h, eb_h, sb_h, wb_h = _marginals_vjp(h2, *_groups(params, _HEAD), mhbar.reshape(t, 1, s * b),
                                                   vhbar.reshape(t, 1, s * b))
    _, v2, _, _ = _marginals(h1, *_groups(params, _LAYER2))
    m2bar = h2bar.mT  # (T, 2, S·B)
    e2 = eps2.transpose(1, 2).reshape(t, 2, s * b)
    v2bar = m2bar * e2 * 0.5 / torch.sqrt(torch.clamp(v2, min=VAR_FLOOR))
    h1bar, zb2, eb2, sb2, wb2 = _marginals_vjp(h1, *_groups(params, _LAYER2), m2bar, v2bar)
    h1bar = h1bar + m2bar.mT @ params["mw2"].mT

    h1bar = h1bar.reshape(t, s, b, 2).mT  # (T, S, 2, B)
    m1bar = torch.sum(h1bar, dim=1)
    v1bar = torch.sum(h1bar * eps1 * 0.5 / torch.sqrt(v1)[:, None], dim=1)
    _, zb1, eb1, sb1, wb1 = _marginals_vjp(x, *_groups(params, _LAYER1), m1bar, v1bar)
    bars = {
        "z": torch.cat([zb1, zb2, zb_h], dim=1),
        "ell": torch.cat([eb1, eb2, eb_h], dim=1),
        "s2": torch.cat([sb1, sb2, sb_h], dim=1),
        "w": torch.cat([wb1, wb2, wb_h], dim=1),
        "mw1": x.mT @ m1bar.mT,
        "mb1": torch.sum(m1bar, dim=-1),
        "mw2": h1.mT @ m2bar.mT,
        "mb2": torch.sum(m2bar, dim=-1),
        "mbh": torch.sum(mhbar, dim=(1, 2))[:, None],
    }
    return bars, noisebar, ybar


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


def build(force: bool = False) -> str:
    """Compile ``csrc/elbo_fused.cu`` (``ops/cuda_build.py``), load it, and
    return nvcc's output (the ``-Xptxas -v`` register, shared-memory and
    spill report).  Reused unless ``force``; a failed compile raises."""
    global _lib
    lib, log = build_library(SOURCE, force)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.elbo_fwd.argtypes = [p] * 14 + [p] * 7 + [i] * 4 + [p]
    lib.elbo_bwd.argtypes = [p] * 14 + [p, p, p] + [p] * 6 + [i] * 4 + [p]
    lib.elbo_bwd_moments.argtypes = [p] * 14 + [p] * 6 + [i] * 4 + [p]
    lib.elbo_partial_len.argtypes = lib.elbo_fwd_tiles.argtypes = [i, i]
    for fn in (lib.elbo_small_len, lib.elbo_out_ld, lib.elbo_k_ld):
        fn.argtypes = [i]
    lib.elbo_wbar_smem.argtypes = []
    for fn in (lib.elbo_fwd, lib.elbo_bwd, lib.elbo_bwd_moments, lib.elbo_partial_len, lib.elbo_fwd_tiles,
               lib.elbo_small_len, lib.elbo_out_ld, lib.elbo_k_ld, lib.elbo_wbar_smem):
        fn.restype = i
    _lib = lib
    return log


def dynamic_smem() -> dict:
    """Dynamic shared memory a CTA takes, of the kernels that take any
    (built first if need be); the others' is static, in nvcc's report."""
    if _lib is None:
        build()
    return {"elbo_wbar_kernel": _lib.elbo_wbar_smem()}


def _check_inputs(x, y, eps1, eps2, params, noise, extra=()):
    """The kernel's dtype, contiguity, shapes and device, or raise (in that
    order, so that the refusals are testable without a card).  Returns
    (T, B, S, M)."""
    named = {"x": x, "y": y, "eps1": eps1, "eps2": eps2, "noise": noise, **params, **dict(extra)}
    for name, a in named.items():
        if a.dtype != torch.float32:
            raise TypeError(f"elbo_data_term kernel takes float32, got {a.dtype} for {name}")
        if not a.is_contiguous():
            raise ValueError(f"elbo_data_term kernel takes contiguous tensors ({name} is not)")
    if x.ndim != 3 or eps1.ndim != 4 or params["z"].ndim != 4:
        raise ValueError(f"elbo_data_term kernel takes x (T, B, 2), ε (T, S, 2, B) and z (T, 5, M, 2), got "
                         f"{tuple(x.shape)}, {tuple(eps1.shape)} and {tuple(params['z'].shape)}")
    t, b, _ = x.shape
    s, m = eps1.shape[1], params["z"].shape[2]
    want = {"x": (t, b, 2), "y": (t, b), "eps1": (t, s, 2, b), "eps2": (t, s, 2, b), "noise": (t,),
            "z": (t, 5, m, 2), "ell": (t, 5, 2), "s2": (t, 5), "w": (t, 5, m, 2 * m + 1), "mw1": (t, 2, 2),
            "mb1": (t, 2), "mw2": (t, 2, 2), "mb2": (t, 2), "mbh": (t, 1)}
    for name, a in named.items():
        if name in want and tuple(a.shape) != want[name]:
            raise ValueError(f"elbo_data_term kernel: {name} is {tuple(a.shape)}, want {want[name]}")
    if not (1 <= m <= MAX_M and 1 <= b <= MAX_B and 1 <= t <= MAX_T and s >= 1):
        raise ValueError(f"elbo_data_term kernel takes 1 <= M <= {MAX_M}, 1 <= B <= {MAX_B}, 1 <= T <= {MAX_T}, "
                         f"S >= 1; got T={t}, B={b}, S={s}, M={m}")
    for name, a in named.items():
        if a.device.type != "cuda" or a.device != x.device:
            raise ValueError(f"elbo_data_term kernel takes CUDA tensors on one device ({name} is on {a.device})")
    return t, b, s, m


def _pointers(x, y, eps1, eps2, params, noise):
    return [a.data_ptr() for a in (x, y, eps1, eps2, *(params[k] for k in PARAM_KEYS), noise)]


def _scratch(t, b, s, m, opts, out: bool):
    """Both passes' scratch: K_xz (T, 2B + 3SB, round4(M)), out's rows
    (T, 2B + 3SB, round4(2M + 1)) where ``out``, and the small partials."""
    rows = 2 * b + 3 * s * b  # scratch rows per member: B per layer-1 group, S·B per other group
    kscr = torch.empty((t, rows, _lib.elbo_k_ld(m)), **opts)  # rows 16-byte aligned
    oscr = torch.empty((t, rows, _lib.elbo_out_ld(m)), **opts) if out else None  # out, then outbar
    return kscr, oscr, torch.empty((t, _lib.elbo_partial_len(b, s)), **opts)


def forward_moments(x, y, eps1, eps2, params, noise):
    """The forward kernels' wrapper with what their row kernels keep: (data
    term (T,), h₁ (T, S, B, 2), h₂ (T, S, B, 2), moments (T, 2B + 3SB, 2)),
    the last each scratch row's mean (without the prior mean) and
    unclipped variance, rows B per layer-1 group and S·B (q = s·B + b) per
    other group, in group order.  One call on the current stream; raises on
    anything the kernels do not take; no autograd."""
    t, b, s, m = _check_inputs(x, y, eps1, eps2, params, noise)
    if _lib is None:
        build()
    opts = dict(dtype=x.dtype, device=x.device)
    kscr, _, partial = _scratch(t, b, s, m, opts, out=False)
    lpart = torch.empty((t, _lib.elbo_fwd_tiles(b, s)), **opts)
    mom = torch.empty((t, kscr.shape[1], 2), **opts)
    dt = torch.empty(t, **opts)
    h1 = torch.empty((t, s, b, 2), **opts)
    h2 = torch.empty_like(h1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib.elbo_fwd(*_pointers(x, y, eps1, eps2, params, noise), kscr.data_ptr(), partial.data_ptr(),
                            mom.data_ptr(), lpart.data_ptr(), dt.data_ptr(), h1.data_ptr(), h2.data_ptr(),
                            t, b, s, m, stream)
    if err != 0:
        raise RuntimeError(f"elbo_data_term forward kernel launch failed: CUDA error {err}")
    LAUNCHES["elbo_data_term_fwd"] += 1
    return dt, h1, h2, mom


def elbo_fwd_cuda(x, y, eps1, eps2, params, noise):
    """The forward kernels' wrapper: (data term (T,), h₁ (T, S, B, 2),
    h₂ (T, S, B, 2)) from one call on the current stream; h₁ and h₂ are the
    sampled layer outputs the backward reads.  Raises on anything the
    kernels do not take; no autograd."""
    return forward_moments(x, y, eps1, eps2, params, noise)[:3]


def _check_h(t, b, s, h1, h2, gbar=None):
    if tuple(h1.shape) != (t, s, b, 2) or tuple(h2.shape) != (t, s, b, 2) or (
            gbar is not None and tuple(gbar.shape) != (t,)):
        raise ValueError(f"elbo_data_term backward: h1 {tuple(h1.shape)}, h2 {tuple(h2.shape)} and gbar "
                         f"{None if gbar is None else tuple(gbar.shape)} do not match T={t}, S={s}, B={b}")


def backward_moments(x, y, eps1, eps2, params, noise, h1, h2):
    """The backward's own recomputation of every scratch row's (mean,
    unclipped variance), as :func:`forward_moments` gives the forward's:
    the backward's first two launches at the forward's h₁ and h₂, then the
    means from out's column 0 and the variances from its partials.  For a
    check; no path calls it."""
    t, b, s, m = _check_inputs(x, y, eps1, eps2, params, noise, (("h1", h1), ("h2", h2)))
    _check_h(t, b, s, h1, h2)
    if _lib is None:
        build()
    opts = dict(dtype=x.dtype, device=x.device)
    kscr, oscr, partial = _scratch(t, b, s, m, opts, out=True)
    mom = torch.empty((t, kscr.shape[1], 2), **opts)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib.elbo_bwd_moments(*_pointers(x, y, eps1, eps2, params, noise), h1.data_ptr(), h2.data_ptr(),
                                    kscr.data_ptr(), oscr.data_ptr(), partial.data_ptr(), mom.data_ptr(),
                                    t, b, s, m, stream)
    if err != 0:
        raise RuntimeError(f"elbo_data_term backward moments launch failed: CUDA error {err}")
    LAUNCHES["elbo_bwd_moments"] += 1
    return mom


def elbo_bwd_cuda(x, y, eps1, eps2, params, noise, h1, h2, gbar):
    """The backward kernels' wrapper: (cotangents as a dict of
    ``PARAM_KEYS``, σ̄² (T,), ȳ (T, B)), each scaled by gbar (T,), from one
    call on the current stream, given the forward's h₁ and h₂.  Raises on
    anything the kernel does not take; no autograd."""
    t, b, s, m = _check_inputs(x, y, eps1, eps2, params, noise, (("h1", h1), ("h2", h2), ("gbar", gbar)))
    _check_h(t, b, s, h1, h2, gbar)
    if _lib is None:
        build()
    p = 2 * m + 1
    kp = _lib.elbo_small_len(m)
    opts = dict(dtype=x.dtype, device=x.device)
    kscr, oscr, partial = _scratch(t, b, s, m, opts, out=True)
    wbar = torch.empty((t, 5, m, p), **opts)
    small = torch.empty((t, kp), **opts)
    ybar = torch.empty((t, b), **opts)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib.elbo_bwd(*_pointers(x, y, eps1, eps2, params, noise), h1.data_ptr(), h2.data_ptr(),
                            gbar.data_ptr(), kscr.data_ptr(), oscr.data_ptr(), partial.data_ptr(), wbar.data_ptr(),
                            small.data_ptr(), ybar.data_ptr(), t, b, s, m, stream)
    if err != 0:
        raise RuntimeError(f"elbo_data_term backward kernel launch failed: CUDA error {err}")
    LAUNCHES["elbo_data_term_bwd"] += 1
    # small: z̄ (5, M, 2), then ℓ̄ (5, 2), s̄² (5), m̄w1 (2, 2), m̄b1 (2),
    # m̄w2 (2, 2), m̄b2 (2), m̄bh (1), σ̄² (1): csrc/elbo_fused.cu's layout
    sizes = (10 * m, 10, 5, 4, 2, 4, 2, 1, 1)
    zb, eb, sb, mw1, mb1, mw2, mb2, mbh, nb = torch.split(small, sizes, dim=1)
    bars = {"z": zb.reshape(t, 5, m, 2), "ell": eb.reshape(t, 5, 2), "s2": sb, "w": wbar,
            "mw1": mw1.reshape(t, 2, 2), "mb1": mb1, "mw2": mw2.reshape(t, 2, 2), "mb2": mb2, "mbh": mbh}
    return bars, nb[:, 0], ybar


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


def _device_type(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"elbo_data_term: no path for device {x.device}")
    return x.device.type


class _FusedDataTerm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, eps1, eps2, noise, *values):
        params = dict(zip(PARAM_KEYS, values))
        if _device_type(x) == "cuda":
            dt, h1, h2 = elbo_fwd_cuda(x, y, eps1, eps2, params, noise)
            res = (h1, h2)
        else:
            dt, res = reference_fwd(x, y, eps1, eps2, params, noise)
        ctx.save_for_backward(x, y, eps1, eps2, noise, *values, *res)
        return dt

    @staticmethod
    def backward(ctx, gbar):
        x, y, eps1, eps2, noise, *rest = ctx.saved_tensors
        params = dict(zip(PARAM_KEYS, rest[:len(PARAM_KEYS)]))
        res = rest[len(PARAM_KEYS):]
        if _device_type(x) == "cuda":
            bars, noisebar, ybar = elbo_bwd_cuda(x, y, eps1, eps2, params, noise, *res, gbar.contiguous())
        else:
            bars, noisebar, ybar = reference_bwd(x, y, eps1, eps2, params, noise, res, gbar)
        return (None, ybar, None, None, noisebar, *(bars[k] for k in PARAM_KEYS))


def fused_data_term(x, y, eps1, eps2, params, noise):
    """The DSVI ELBO data term per member (T,), with the hand-derived
    backward: the kernels on the card, the plain version on the CPU.
    Shapes and the parameter layout are in the module docstring."""
    return _FusedDataTerm.apply(x, y, eps1, eps2, noise, *(params[k] for k in PARAM_KEYS))
