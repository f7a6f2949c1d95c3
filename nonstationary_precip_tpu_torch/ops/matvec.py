"""K2, K3 and K6: the Gibbs Gram·V, the fused backward panel sweep of the
matrix-free MLL, and the SE-ARD (RBF) Gram·V, by hand for Hopper.

Replaces, in ``nonstationary_precip_tpu/ops/pallas_matvec.py``:
  * K2 ``make_gibbs_matvec`` (:240, ``pallas_call`` at :207; body
    ``_gibbs_kernel``), reached through ``packed_gibbs_matvec_builder`` and
    ``scaled_packed_gibbs_matvec_builder`` (:602-644);
  * K3 ``packed_gibbs_panel_grads`` (:350, ``pallas_call`` at :384) and
    ``packed_gibbs_panel_grads_rows`` (:401 → :435; body
    ``_gibbs_panel_bwd_kernel``), reached through ``packed_gibbs_panel_vjp``
    and ``packed_gibbs_panel_vjp_rows`` (:453-599);
  * K6 ``make_rbf_matvec`` (:527, ``pallas_call`` at :207 through
    ``_matvec_call``; body ``_rbf_kernel`` :493, payload ``_pack_scaled``
    :518), reached through ``stationary_matvec_builder`` (:647-674), the
    mBCG matvec of the matrix-free ``ExactGP``.
All three kernels are ``csrc/gibbs_matvec.cu``: CUDA C++ for sm_90a, built
with nvcc at first use (``ops/cuda_build.py``) and bound through ctypes.

What bounds them on an H100.  All three are compute-bound.  They read O(N·(2D+R))
bytes and do O(N²) work: at N = 16384, D = 2, R = 9 a K2 call reads 1.4 MB
(0.4 µs at 3.35 TB/s) but builds 2.7·10⁸ Gram elements.  K2's d = 2
element costs 15 f32 operations (an FMA as 2) and 2 on the special-function
units (SFU, 16 a clock an SM, a sixteenth of the FP32 lanes' rate), K6's 5
and 1, then the 2R of the contraction; K3's 17 and 2 for P = W·K given W,
the cotangent W = f1ᵢ·f2ⱼ 2(1 + 2R), P's row sum 1 and 7 a dim for the
pullback sums.  ``chip_smoke.py`` reports the FP32 bound (operations
counted as below, over 67 TFLOP/s) and the SFU bound (their SFU operations
an element over 16 a clock × 132 SMs at nvidia-smi's maximum SM clock)
beside the measured time; their bound is the larger.

What the design does about it.  K never reaches memory: each element is
built in registers and contracted at once.  K2, K6 and K3 are one walk,
``gibbs_rows_kernel``, with the element a template policy: one thread owns
K2_ROWS_PER_THREAD = 2 rows for K2, K6_ROWS_PER_THREAD = 4 for K6 and
K3_ROWS_PER_THREAD = 2 for K3 (blocks of 256 threads), with their payloads
and accumulators each in registers, so each column payload and V row read
from shared memory feeds that many elements; at the paths' d = 2 and R ≤ 9
K2's registers are capped at 64 so that four blocks share an SM, K6's are
left free, and K6's columns are split for 4 blocks an SM, not 8
(``tools/bench_k2.py`` times both kernels at 2, 4 and 8 rows a thread,
with and without the cap, at 4, 8 and 16 blocks an SM: on an H100 K2 took
4 % longer at 4 rows, K6 10 % less); K3's, at 1 + 2R ≤ 17 factors, are
capped at 80 so that three share an SM, its columns split for 8 an SM
(``tools/bench_k3.py``: 0.541 ms, against 0.535–0.655 at 1, 2 or 4 rows,
free or capped, at 4, 8 or 16 an SM); column passes are double-buffered
through ``cp.async``, so staging
overlaps the arithmetic, and at d = 2 the element's column factors are made
once a pass.
K2's d = 2 element is the JAX kernel's own rewrite (``pallas_matvec.py:118-141``):
one rsqrt(ss₀·ss₁) whose square is the reciprocal, the numerator
√(∏ 2ℓ_ik ℓ_jk) split into a row factor and a column factor, each made once
(the row's in registers, the column's once a pass), and, beyond JAX, the
squared lengthscales prescaled by ln 2 so that exp becomes one ``ex2``:
rsqrt and exp2 are the SFU's approximations (``rsqrt.approx.ftz``,
``ex2.approx.ftz``, ~2⁻²² relative each; ``chip_smoke.py`` holds K2 to
float64).  Every other d keeps the per-dim element of ``gibbs_elem.cuh``
(IEEE division, ``sqrtf``, ``expf``), as the JAX package does.
K6's payload is z = x/ℓ, prescaled once per build by the wrapper (the TPU
kernel's ``_pack_scaled``), and its element exp(−½ Σ_k (z_ik − z_jk)²)
forms the quadratic from the differences, where the TPU kernel (and the
plain version here) uses ‖a‖² + ‖b‖² − 2a·b clamped at 0.  At d = 2 the
walk scales the rows' z (in registers) and each pass's columns by
c = √(log₂e / 2), so the element is 2^−((cz_i0 − cz_j0)² + (cz_i1 − cz_j1)²):
two differences, a square and an FMA, and one ``ex2.approx.ftz``; other d
keep the per-dim differences and ``expf``.  The caller adds s² and σ²V, as
the JAX builder does.
K3 is the walk's third policy (``PanelElem``): a thread holds its rows'
cotangent factors f1ᵢ (fw = 1 + 2R) in registers where K2 holds V's
accumulators, each pass stages the columns' factors f2ⱼ where K2 stages V's
rows (read as float4 broadcasts), and each row accumulates the 1 + 2D
pullback sums (Σ P, Σ P·d_k/ss_k, Σ P·(2d_k²/ss_k − 1)/ss_k, P = (f1ᵢ·f2ⱼ)·K)
where K2 accumulates R products; a pass is K3_COLS = 64 columns, so the
factors of R ≤ 32 probes fit the walk's 48 KB.  At d = 2 its element is
K2's, with the reciprocals 1/ss_k read off rs² = 1/(s₀s₁) (no division:
s₁·rs² = 1/(ss₀·ln 2)), the sums carrying the ln 2 that the fixed-order
second pass puts back with the closed forms; other d, the per-dim element.
Accumulators are templated on R's bucket, so mBCG's R = 9 keeps exactly 9
(K3: the 1 + 2R = 17 factors of the paths' 8 probes, exactly).
The column range is split over blocks until the card holds ~8 blocks per
SM (K6: ~4; K3: K3_BLOCKS_PER_SM), and a second pass adds the slices in a
fixed order: no float atomics, so a result is the same bits on every run.  Not carried over from the TPU:
the (N, 128) lane packing and padded rows (the kernels mask the ragged
edge).

The contraction modes (``precision``, the TPU kernel's ``_contract``,
``pallas_matvec.py:90-112``).  'highest' is exact f32 (the walk above, FMAs
in f32).  'vpu' is the TPU kernel's exact-f32 per-column contraction
(``_gibbs_kernel_vpu``, :200, ``pallas_call`` at :225), the same estimand
as 'highest' up to summation order, so it is the same walk: no kernel of its
own, and JAX's refusal above ``VPU_R_MAX`` = 32 right-hand sides kept.
'default' (one bf16 pass) and 'high3' (three) keep the TPU's own estimands,
not TF32: each Gram element is rounded to bf16, hi = bf16(k) and
lo = bf16(k − hi), V likewise, and 'default' contracts hi·hi, 'high3'
hi·hi + hi·lo + lo·hi, with f32 accumulation.  On the card that is a second
walk, ``gibbs_mma_kernel`` (K2's elements, and K6's), on the tensor cores:
``mma.sync.m16n8k16`` with bf16 operands and f32 accumulators, the
elements built by the same policies straight into each thread's A
fragments, V's parts split once a call by the wrapper and packed in column
pairs (``_bf16_pairs``), the B fragments' layout.  The plain versions round
the Gram panel and V through ``torch.bfloat16`` as JAX's ``_contract`` does
and multiply in f32.  What bounds the mode kernels: the element's FP32 and
SFU work (the contraction's 2R FMAs leave the FP32 count; the rounding
adds ``_split_ops``), and the mma work, 2R operations an element a pass, at
the tensor cores' bf16 rate (``mode_ops``, ``mma_ops``).

Dispatch: a CPU tensor takes the plain version (``gibbs_gram_matvec_plain``,
``packed_gibbs_panel_grads_plain``, ``rbf_gram_matvec_plain``, each mode's
through ``precision``); a CUDA tensor launches the kernel (the mode's) or
raises, for D > 8, a dtype other than float32, a non-contiguous input or a
failed build alike.  ``LAUNCHES`` counts kernel launches and nothing else,
the mode kernels under their own names.
Forward-only, as on the TPU: the matvec sits inside ``lazy_cg_mll``'s
autograd Function, and K3 is itself a backward (K6's MLL backward is the
panel pullback through the kernel module, ``lazy_cg.make_jnp_panel_vjp``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nonstationary_precip_tpu_torch.kernels.base import Scale
from nonstationary_precip_tpu_torch.kernels.gibbs import gibbs_gram_reference
from nonstationary_precip_tpu_torch.kernels.stationary import RBF, _sq_dist
from nonstationary_precip_tpu_torch.ops.cuda_build import CSRC, build_library
from nonstationary_precip_tpu_torch.utils.transforms import positive

SOURCE = CSRC / "gibbs_matvec.cu"

MAX_D = 8  # input dims the kernels take
MAX_R = 128  # K2, K6: right-hand sides one launch takes; wider V is column-chunked
MAX_FACTORS = 65  # K3: 1 + 2R cotangent factors, so R ≤ 32 (csrc kMaxF)
K3_ROWS_PER_THREAD = 2  # K3: rows a thread owns (csrc kK3RowsPerThread)
ROWS = 256 * K3_ROWS_PER_THREAD  # K3: rows per block (csrc kK3Rows)
K3_COLS = 64  # K3: columns per shared-memory pass (csrc kK3Cols)
K3_BLOCKS_PER_SM = 8  # K3's column splits (tools/bench_k3.py)
K2_ROWS_PER_THREAD = 2  # K2: rows a thread owns (csrc kK2RowsPerThread)
K2_ROWS = 256 * K2_ROWS_PER_THREAD  # K2: rows per block (csrc kK2Rows)
K6_ROWS_PER_THREAD = 4  # K6: rows a thread owns (csrc kK6RowsPerThread)
K6_ROWS = 256 * K6_ROWS_PER_THREAD  # K6: rows per block (csrc kK6Rows)
COLS = 128  # K2, K6: columns per shared-memory pass (csrc kCols); every split is whole COLS
GROUP = 32  # K2, K6: right-hand sides one block contracts (csrc kGroup)
MMA_MT = 2  # the tensor-core walk: 16-row tiles a warp owns (csrc kMmaMT)
MMA_ROWS = 8 * MMA_MT * 16  # its rows a block of 8 warps owns (csrc kMmaRows)
MMA_PASS = 64  # its columns a shared-memory pass (csrc kMmaPass)
MMA_GROUP = 32  # its right-hand sides a block contracts (csrc kMmaGroup)
MMA_BLOCKS_PER_SM = 4  # its column splits
VPU_R_MAX = 32  # 'vpu': right-hand sides a call takes (pallas_matvec.py:62)
PRECISIONS = ("highest", "default", "high3", "vpu")  # K2's modes; K6 has all but 'vpu'
BLOCKS_PER_SM = 8  # column splits are added until the grid has this many (K2, K3)
K6_BLOCKS_PER_SM = 4  # K6's (tools/bench_k2.py: 4 rows a thread with free registers, 4 an SM)
PLAIN_BLOCK = 2048  # row-panel height of the plain versions

#: Kernel launches so far in this process, one per K2, K3 or K6 call of the
#: library (each call is the kernel plus its fixed-order reduction pass).
LAUNCHES = {"gibbs_matvec": 0, "gibbs_panel_grads": 0, "rbf_matvec": 0, "gibbs_matvec_default": 0,
            "gibbs_matvec_high3": 0, "rbf_matvec_default": 0, "rbf_matvec_high3": 0}

_lib = None


def build(force: bool = False) -> str:
    """Compile ``csrc/gibbs_matvec.cu``, load it, and return nvcc's output
    (registers, shared memory and spills per kernel).  Reused unless
    ``force``; a failed compile raises."""
    global _lib
    lib, log = build_library(SOURCE, force)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gibbs_matvec.argtypes = [p, p, i, p, p, i, i, p, i, i, p, i, p, i, i, p]
    lib.gibbs_matvec.restype = i
    lib.gibbs_panel_grads.argtypes = [p, p, p, i, p, p, p, i, i, i, p, p, p, p, i, i, p]
    lib.gibbs_panel_grads.restype = i
    lib.rbf_matvec.argtypes = [p, i, p, i, i, p, i, i, p, i, p, i, i, p]
    lib.rbf_matvec.restype = i
    lib.gibbs_matvec_mma.argtypes = [p, p, i, p, p, i, i, p, p, i, i, i, p, i, p, i, i, i, p]
    lib.gibbs_matvec_mma.restype = i
    lib.rbf_matvec_mma.argtypes = [p, i, p, i, i, p, p, i, i, i, p, i, p, i, i, i, p]
    lib.rbf_matvec_mma.restype = i
    _lib = lib
    return log


def column_splits(n_rows: int, n_cols: int, groups: int, sms: int, rows: int = ROWS,
                  per_sm: int | None = None) -> tuple[int, int]:
    """(splits, columns per split) for a grid of ⌈n_rows/rows⌉ row blocks ×
    ``groups`` (``rows``: ROWS for K3, K2_ROWS for K2, K6_ROWS for K6):
    slices of a whole number of COLS-wide passes each, as many as bring the
    grid to about ``per_sm`` (default BLOCKS_PER_SM) blocks per SM (the
    passes are shared out evenly, so the grid may fall short by the
    rounding)."""
    chunks = -(-n_cols // COLS)
    blocks = -(-n_rows // rows) * groups
    want = min(chunks, max(1, -(-(BLOCKS_PER_SM if per_sm is None else per_sm) * sms // blocks)))
    per = -(-chunks // want)
    return -(-chunks // per), per * COLS


@functools.cache
def _num_sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_cuda(name: str, *ts: torch.Tensor):
    dev = ts[0].device
    for t in ts:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name} kernel takes CUDA tensors on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous tensors")


def _check_payload(name: str, x: torch.Tensor, ell: torch.Tensor):
    if x.ndim != 2 or x.shape != ell.shape:
        raise ValueError(f"{name}: x and ell must be (N, D) of one shape, got "
                         f"{tuple(x.shape)} and {tuple(ell.shape)}")
    if not 1 <= x.shape[1] <= MAX_D:
        raise ValueError(f"{name}: D ≤ {MAX_D}, got D = {x.shape[1]}")


def _launched(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# K2: Gibbs Gram·V
# ---------------------------------------------------------------------------


def gibbs_gram_matvec_cuda(x1, ell1, x2, ell2, v):
    """K2's wrapper: K(x1, x2) @ v from ⌈R/MAX_R⌉ launches on the current
    stream.  x1, ell1 (N1, D ≤ 8), x2, ell2 (N2, D), v (N2, R), all float32,
    contiguous, on one CUDA device.  Raises on anything else."""
    _check_payload("gibbs_matvec", x1, ell1)
    _check_payload("gibbs_matvec", x2, ell2)
    if v.ndim != 2 or v.shape[0] != x2.shape[0] or x1.shape[1] != x2.shape[1]:
        raise ValueError(f"gibbs_matvec: shapes {tuple(x1.shape)}, {tuple(x2.shape)}, v {tuple(v.shape)}")
    _check_cuda("gibbs_matvec", x1, ell1, x2, ell2, v)
    if _lib is None:
        build()
    (n1, d), n2, r = x1.shape, x2.shape[0], v.shape[1]
    out = torch.empty((n1, r), dtype=v.dtype, device=v.device)
    sms, stream = _num_sms(v.device), _stream(v.device)
    for c0 in range(0, r, MAX_R):
        rc = min(MAX_R, r - c0)
        splits, per = column_splits(n1, n2, -(-rc // GROUP), sms, K2_ROWS)
        part = torch.empty(splits * n1 * rc, dtype=v.dtype, device=v.device)
        err = _lib.gibbs_matvec(
            x1.data_ptr(), ell1.data_ptr(), n1, x2.data_ptr(), ell2.data_ptr(), n2, d,
            v.data_ptr() + 4 * c0, r, rc, out.data_ptr() + 4 * c0, r, part.data_ptr(),
            splits, per, stream)
        _launched(err, "gibbs_matvec")
    return out


def _bf16(t):
    """``t`` rounded to bfloat16 (to nearest, ties to even) and widened back."""
    return t.to(torch.bfloat16).to(t.dtype)


def contract_plain(tile, v, precision: str = "highest"):
    """tile (M, N) · v (N, R) under a contraction mode, as the TPU kernel's
    ``_contract`` computes it (``pallas_matvec.py:90-112``): 'highest' and
    'vpu' exact; 'default' the bf16-rounded tile against the bf16-rounded v;
    'high3' hi·hi + hi·lo + lo·hi of the bf16 hi = bf16(a) and
    lo = bf16(a − hi) parts, each product in the working dtype."""
    if precision in ("highest", "vpu"):
        return tile @ v
    th, vh = _bf16(tile), _bf16(v)
    if precision == "default":
        return th @ vh
    if precision == "high3":
        tl, vl = _bf16(tile - th), _bf16(v - vh)
        return th @ vh + th @ vl + tl @ vh
    raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def gibbs_gram_matvec_plain(x1, ell1, x2, ell2, v, block: int = PLAIN_BLOCK, precision: str = "highest"):
    """The plain PyTorch version of K2 and its modes: row panels of
    ``gibbs_gram_reference`` contracted with v by :func:`contract_plain`."""
    return torch.cat([contract_plain(gibbs_gram_reference(x1[i:i + block], ell1[i:i + block], x2, ell2), v,
                                     precision) for i in range(0, x1.shape[0], block)])


def _bf16_pairs(v, high3: bool):
    """V's bf16 hi part (and, for 'high3', lo part) packed in column pairs,
    the tensor-core walk's B operand: int32 word [p, r] holds bf16(v[2p, r])
    in its low half and bf16(v[2p + 1, r]) in its high half, v's rows padded
    to even with 0 and its columns to a multiple of 8.  Returns (hi, lo, ldp)
    with lo = hi when unused."""
    n, r = v.shape
    ldp = -(-r // 8) * 8
    vp = torch.zeros((n + n % 2, ldp), dtype=torch.float32, device=v.device)
    vp[:n, :r] = v
    vh = vp.to(torch.bfloat16)

    def pack(b):
        return b.view(torch.int16).reshape(-1, 2, ldp).transpose(1, 2).contiguous().view(torch.int32)[..., 0]

    hi = pack(vh)
    lo = pack((vp - vh.float()).to(torch.bfloat16)) if high3 else hi
    return hi.contiguous(), lo.contiguous(), ldp


def _mma_launches(lib_fn, name, x_args, n1, n2, d, v, out, precision):
    """The mode kernel's ⌈R/MAX_R⌉ launches on the current stream: each
    column chunk of V split and packed, its column splits, its scratch."""
    r = v.shape[1]
    high3 = precision == "high3"
    sms, stream = _num_sms(v.device), _stream(v.device)
    for c0 in range(0, r, MAX_R):
        rc = min(MAX_R, r - c0)
        hi, lo, ldp = _bf16_pairs(v[:, c0:c0 + rc], high3)
        splits, per = column_splits(n1, n2, -(-rc // MMA_GROUP), sms, MMA_ROWS, MMA_BLOCKS_PER_SM)
        part = torch.empty(splits * n1 * rc, dtype=v.dtype, device=v.device)
        err = lib_fn(*x_args, hi.data_ptr(), lo.data_ptr(), ldp, hi.shape[0], rc, out.data_ptr() + 4 * c0, r,
                     part.data_ptr(), splits, per, int(high3), stream)
        _launched(err, f"{name}_{precision}")
    return out


def _check_mode(precision: str):
    if precision not in ("default", "high3"):
        raise ValueError(f"the tensor-core contraction takes 'default' or 'high3', got {precision!r}")


def gibbs_gram_matvec_mma_cuda(x1, ell1, x2, ell2, v, precision: str):
    """K2's 'default' or 'high3' wrapper: the tensor-core walk, ⌈R/MAX_R⌉
    launches on the current stream, on the operands of
    :func:`gibbs_gram_matvec_cuda`.  Raises on anything else."""
    _check_mode(precision)
    _check_payload("gibbs_matvec", x1, ell1)
    _check_payload("gibbs_matvec", x2, ell2)
    if v.ndim != 2 or v.shape[0] != x2.shape[0] or x1.shape[1] != x2.shape[1]:
        raise ValueError(f"gibbs_matvec: shapes {tuple(x1.shape)}, {tuple(x2.shape)}, v {tuple(v.shape)}")
    _check_cuda("gibbs_matvec", x1, ell1, x2, ell2, v)
    if _lib is None:
        build()
    (n1, d), n2 = x1.shape, x2.shape[0]
    out = torch.empty((n1, v.shape[1]), dtype=v.dtype, device=v.device)
    args = (x1.data_ptr(), ell1.data_ptr(), n1, x2.data_ptr(), ell2.data_ptr(), n2, d)
    return _mma_launches(_lib.gibbs_matvec_mma, "gibbs_matvec", args, n1, n2, d, v, out, precision)


def _check_precision(precision: str, modes=PRECISIONS):
    if precision not in modes:
        raise ValueError(f"precision must be one of {'/'.join(modes)}, got {precision!r}")


def make_gibbs_matvec(x1, ell1, x2, ell2, precision: str = "highest"):
    """``matvec(v) = K(x1, x2) @ v`` for the diagonal Gibbs kernel, K never
    in memory.  The payloads are made contiguous once, outside the caller's
    iteration loop.  ``precision`` is the contraction mode: 'highest' (exact
    f32, the default), 'vpu' (the same walk; R ≤ ``VPU_R_MAX``, as JAX
    refuses more), 'default' (one bf16 pass: measured divergent inside
    preconditioned mBCG by the JAX package) or 'high3' (three bf16 passes,
    ~1e-5 relative)."""
    _check_precision(precision)
    _check_payload("gibbs_matvec", x1, ell1)
    _check_payload("gibbs_matvec", x2, ell2)
    x1, ell1, x2, ell2 = (t.contiguous() for t in (x1, ell1, x2, ell2))

    def matvec(v):
        if precision == "vpu" and v.shape[-1] > VPU_R_MAX:
            raise ValueError(f"gibbs matvec vpu: R ≤ {VPU_R_MAX}, got {v.shape[-1]}")
        if v.device.type == "cpu":
            return gibbs_gram_matvec_plain(x1, ell1, x2, ell2, v, precision=precision)
        if precision in ("default", "high3"):
            return gibbs_gram_matvec_mma_cuda(x1, ell1, x2, ell2, v, precision)
        return gibbs_gram_matvec_cuda(x1, ell1, x2, ell2, v)

    return matvec


def gibbs_gram_matvec(x1, ell1, x2, ell2, v, precision: str = "highest"):
    """One-shot K(x1, x2) @ v; inside an iteration loop use
    :func:`make_gibbs_matvec`."""
    return make_gibbs_matvec(x1, ell1, x2, ell2, precision)(v)


@functools.lru_cache(maxsize=8)
def packed_gibbs_matvec_builder(d: int, precision: str = "highest"):
    """Builder for the packed payload x_aug = [x, log ℓ]: returns
    ``builder(kernel, x_aug, sigma2) -> matvec`` with
    matvec(v) = K_gibbs v + σ²v (``kernel`` unused)."""

    def builder(kernel, x_aug, sigma2):
        ell = torch.exp(x_aug[:, d:])
        mv = make_gibbs_matvec(x_aug[:, :d], ell, x_aug[:, :d], ell, precision)
        return lambda v: mv(v) + sigma2 * v

    return builder


@functools.lru_cache(maxsize=8)
def scaled_packed_gibbs_matvec_builder(d: int, precision: str = "highest"):
    """Like :func:`packed_gibbs_matvec_builder`, with ``kernel`` the raw
    outputscale: v ↦ s²·K_gibbs v + σ²v, s² = softplus(raw).  The forward
    counterpart of ``kernels.gibbs.packed_gibbs_cross(d)``."""

    def builder(raw_s2, x_aug, sigma2):
        ell = torch.exp(x_aug[:, d:])
        mv = make_gibbs_matvec(x_aug[:, :d], ell, x_aug[:, :d], ell, precision)
        s2 = positive(raw_s2)
        return lambda v: s2 * mv(v) + sigma2 * v

    return builder


# ---------------------------------------------------------------------------
# K6: SE-ARD (RBF) Gram·V
# ---------------------------------------------------------------------------


def rbf_gram_matvec_cuda(z1, z2, v):
    """K6's wrapper: exp(−½‖z1ᵢ − z2ⱼ‖²) @ v from ⌈R/MAX_R⌉ launches on the
    current stream, z = x/ℓ prescaled.  z1 (N1, D ≤ 8), z2 (N2, D), v
    (N2, R), all float32, contiguous, on one CUDA device.  Raises on
    anything else."""
    if z1.ndim != 2 or z2.ndim != 2 or z1.shape[1] != z2.shape[1]:
        raise ValueError(f"rbf_matvec: z1, z2 must be (N, D) of one D, got {tuple(z1.shape)}, {tuple(z2.shape)}")
    if not 1 <= z1.shape[1] <= MAX_D:
        raise ValueError(f"rbf_matvec: D ≤ {MAX_D}, got D = {z1.shape[1]}")
    if v.ndim != 2 or v.shape[0] != z2.shape[0]:
        raise ValueError(f"rbf_matvec: v {tuple(v.shape)} against z2 {tuple(z2.shape)}")
    _check_cuda("rbf_matvec", z1, z2, v)
    if _lib is None:
        build()
    (n1, d), n2, r = z1.shape, z2.shape[0], v.shape[1]
    out = torch.empty((n1, r), dtype=v.dtype, device=v.device)
    sms, stream = _num_sms(v.device), _stream(v.device)
    for c0 in range(0, r, MAX_R):
        rc = min(MAX_R, r - c0)
        splits, per = column_splits(n1, n2, -(-rc // GROUP), sms, K6_ROWS, K6_BLOCKS_PER_SM)
        part = torch.empty(splits * n1 * rc, dtype=v.dtype, device=v.device)
        err = _lib.rbf_matvec(z1.data_ptr(), n1, z2.data_ptr(), n2, d, v.data_ptr() + 4 * c0, r, rc,
                              out.data_ptr() + 4 * c0, r, part.data_ptr(), splits, per, stream)
        _launched(err, "rbf_matvec")
    return out


def rbf_gram_matvec_plain(z1, z2, v, block: int = PLAIN_BLOCK, precision: str = "highest"):
    """The plain PyTorch version of K6 and its modes on the prescaled
    payloads: row panels of exp(−½ d²), d² from the identity clamped at 0
    (the JAX kernel's form, and the RBF kernel's), contracted with v by
    :func:`contract_plain`."""
    return torch.cat([contract_plain(torch.exp(-0.5 * _sq_dist(z1[i:i + block], z2)), v, precision)
                      for i in range(0, z1.shape[0], block)])


def rbf_gram_matvec_mma_cuda(z1, z2, v, precision: str):
    """K6's 'default' or 'high3' wrapper: the tensor-core walk on the
    operands of :func:`rbf_gram_matvec_cuda`.  Raises on anything else."""
    _check_mode(precision)
    if z1.ndim != 2 or z2.ndim != 2 or z1.shape[1] != z2.shape[1]:
        raise ValueError(f"rbf_matvec: z1, z2 must be (N, D) of one D, got {tuple(z1.shape)}, {tuple(z2.shape)}")
    if not 1 <= z1.shape[1] <= MAX_D:
        raise ValueError(f"rbf_matvec: D ≤ {MAX_D}, got D = {z1.shape[1]}")
    if v.ndim != 2 or v.shape[0] != z2.shape[0]:
        raise ValueError(f"rbf_matvec: v {tuple(v.shape)} against z2 {tuple(z2.shape)}")
    _check_cuda("rbf_matvec", z1, z2, v)
    if _lib is None:
        build()
    (n1, d), n2 = z1.shape, z2.shape[0]
    out = torch.empty((n1, v.shape[1]), dtype=v.dtype, device=v.device)
    args = (z1.data_ptr(), n1, z2.data_ptr(), n2, d)
    return _mma_launches(_lib.rbf_matvec_mma, "rbf_matvec", args, n1, n2, d, v, out, precision)


def make_rbf_matvec(x1, x2, ell, precision: str = "highest"):
    """``matvec(v) = exp(−½‖(x1 − x2)/ℓ‖²) @ v``, K never in memory; x/ℓ is
    prescaled once, outside the caller's iteration loop.  ell (D,) ARD
    lengthscales, D ≤ 8.  ``precision``: 'highest' (exact f32, the default),
    'default' or 'high3', as in :func:`make_gibbs_matvec` (the JAX kernel has
    no 'vpu' here)."""
    _check_precision(precision, PRECISIONS[:3])
    if x1.shape[-1] > MAX_D:
        raise ValueError(f"rbf matvec: D ≤ {MAX_D}, got D = {x1.shape[-1]}")
    z1, z2 = (x1 / ell).contiguous(), (x2 / ell).contiguous()

    def matvec(v):
        if v.device.type == "cpu":
            return rbf_gram_matvec_plain(z1, z2, v, precision=precision)
        if precision != "highest":
            return rbf_gram_matvec_mma_cuda(z1, z2, v, precision)
        return rbf_gram_matvec_cuda(z1, z2, v)

    return matvec


def rbf_gram_matvec(x1, x2, ell, v, precision: str = "highest"):
    """One-shot SE-ARD Gram·v; inside an iteration loop use
    :func:`make_rbf_matvec`."""
    return make_rbf_matvec(x1, x2, ell, precision)(v)


def stationary_matvec_builder(kernel, x, sigma2):
    """mBCG matvec builder of the matrix-free ``ExactGP``, for RBF or
    Scale(RBF) kernels: ``matvec(v) = s²·K_rbf(x, x) v + σ²v`` through K6,
    the RBF's ``active_dims`` applied.  Other kernels raise TypeError.
    Forward only: the MLL's backward rebuilds panels through the kernel."""
    scale, base = None, kernel
    if isinstance(kernel, Scale):
        scale, base = kernel.outputscale, kernel.base
    if not isinstance(base, RBF):
        raise TypeError(f"stationary_matvec_builder supports RBF / Scale(RBF); got {type(base).__name__} — "
                        "use cross_fn panels instead")
    xs = base._slice(x)
    mv = make_rbf_matvec(xs, xs, base.lengthscale)

    def matvec(v):
        kv = mv(v)
        if scale is not None:
            kv = scale * kv
        return kv + sigma2 * v

    return matvec


# ---------------------------------------------------------------------------
# K3: the backward panel sweep
# ---------------------------------------------------------------------------


def cotangent_factors(alpha, solves, rights):
    """(f1, f2), each (N, 1 + 2R), with f1ᵢ·f2ⱼ = Ŵᵢⱼ, the symmetrised
    cotangent ½αᵢαⱼ − (¼/R)(SᵢZⱼ + ZᵢSⱼ) (``pallas_matvec.py:368-381``)."""
    c = 0.25 / solves.shape[-1]
    f1 = torch.cat([0.5 * alpha[:, None], -c * solves, -c * rights], dim=1)
    f2 = torch.cat([alpha[:, None], rights, solves], dim=1)
    return f1.contiguous(), f2.contiguous()


def _panel_grads_cuda(x_rows, ell_rows, f1_rows, x, ell, f2, split_rows=None):
    """K3's wrapper: one call of the sweep (the walk and its fixed-order
    sum, 2 CUDA launches) for rows (x_rows, ell_rows, f1_rows) against all
    columns (x, ell, f2).  The column splits are those of a sweep over
    ``split_rows`` rows (default: these): a row block given the whole
    sweep's N sums each row in the whole sweep's order, so its bits."""
    _check_payload("gibbs_panel_grads", x_rows, ell_rows)
    _check_payload("gibbs_panel_grads", x, ell)
    (nr, d), n, fw = x_rows.shape, x.shape[0], f2.shape[1]
    if x.shape[1] != d or f1_rows.shape != (nr, fw) or f2.shape[0] != n:
        raise ValueError("gibbs_panel_grads: row and column shapes disagree")
    if fw > MAX_FACTORS:
        raise ValueError(f"gibbs_panel_grads kernel takes R ≤ {(MAX_FACTORS - 1) // 2} probes, got {(fw - 1) // 2}")
    _check_cuda("gibbs_panel_grads", x_rows, ell_rows, f1_rows, x, ell, f2)
    if _lib is None:
        build()
    dev = x.device
    gx = torch.empty((nr, d), dtype=x.dtype, device=dev)
    gl = torch.empty((nr, d), dtype=x.dtype, device=dev)
    sp = torch.empty((nr,), dtype=x.dtype, device=dev)
    splits, per = column_splits(split_rows or nr, n, 1, _num_sms(dev), ROWS, K3_BLOCKS_PER_SM)
    part = torch.empty(splits * nr * (1 + 2 * d), dtype=x.dtype, device=dev)
    err = _lib.gibbs_panel_grads(
        x_rows.data_ptr(), ell_rows.data_ptr(), f1_rows.data_ptr(), nr,
        x.data_ptr(), ell.data_ptr(), f2.data_ptr(), n, d, fw,
        gx.data_ptr(), gl.data_ptr(), sp.data_ptr(), part.data_ptr(), splits, per, _stream(dev))
    _launched(err, "gibbs_panel_grads")
    return gx, gl, sp


def _panel_grads_plain(x_rows, ell_rows, f1_rows, x, ell, f2, block: int = PLAIN_BLOCK):
    """The plain PyTorch version of K3's closed form, over row panels."""
    outs = []
    for i in range(0, x_rows.shape[0], block):
        xr, lr = x_rows[i:i + block, None, :], ell_rows[i:i + block, None, :]
        ss = lr**2 + ell[None] ** 2
        diff = xr - x[None]
        k = torch.prod(torch.sqrt(2.0 * (lr * ell[None]) / ss), dim=-1) * torch.exp(-torch.sum(diff**2 / ss, dim=-1))
        p = (f1_rows[i:i + block] @ f2.T) * k
        sp = p.sum(dim=1)
        gx = -2.0 * torch.sum(p[..., None] * (diff / ss), dim=1)
        t = torch.sum(p[..., None] * ((2.0 * diff**2 / ss - 1.0) / ss), dim=1)
        gl = sp[:, None] / (2.0 * lr[:, 0]) + lr[:, 0] * t
        outs.append((gx, gl, sp))
    return tuple(torch.cat(o) for o in zip(*outs))


def _panel_grads(x_rows, ell_rows, f1_rows, x, ell, f2, split_rows=None):
    if x.device.type == "cpu":
        return _panel_grads_plain(x_rows, ell_rows, f1_rows, x, ell, f2)
    return _panel_grads_cuda(x_rows, ell_rows, f1_rows, x, ell, f2, split_rows)


def packed_gibbs_panel_grads_plain(x, ell, alpha, solves, rights):
    """The plain version of :func:`packed_gibbs_panel_grads`."""
    f1, f2 = cotangent_factors(alpha, solves, rights)
    return _panel_grads_plain(x, ell, f1, x, ell, f2)


def packed_gibbs_panel_grads(x, ell, alpha, solves, rights):
    """One sweep of the BBMM backward over the unscaled Gibbs Gram: the
    row-side pullbacks of Σ Ŵ ⊙ K(x, x), Ŵ = ½ααᵀ − (¼/R)(SZᵀ + ZSᵀ),
    S = solves, Z = rights.  Returns (gx (N, D), gell (N, D), sp (N,)),
    sp the row sums of Ŵ ⊙ K.  Raw ℓ, unscaled; the caller's total gradient
    is twice the row side, by symmetry."""
    f1, f2 = cotangent_factors(alpha, solves, rights)
    return _panel_grads(x.contiguous(), ell.contiguous(), f1, x.contiguous(), ell.contiguous(), f2)


def packed_gibbs_panel_grads_rows(x_rows, ell_rows, alpha_rows, solves_rows, rights_rows,
                                  x, ell, alpha, solves, rights):
    """:func:`packed_gibbs_panel_grads` restricted to ``x_rows`` on the row
    side (all of x on the column side): the same kernel with a row count and
    the rows' own pointers, and the whole sweep's column splits, so each
    row comes out bit for bit as in the whole sweep.  Returns (gx (nr, D),
    gell (nr, D), sp (nr,))."""
    f1_rows, _ = cotangent_factors(alpha_rows, solves_rows, rights_rows)
    _, f2 = cotangent_factors(alpha, solves, rights)
    return _panel_grads(x_rows.contiguous(), ell_rows.contiguous(), f1_rows,
                        x.contiguous(), ell.contiguous(), f2, x.shape[0])


def packed_gibbs_panel_grads_rows_plain(x_rows, ell_rows, alpha_rows, solves_rows, rights_rows,
                                        x, ell, alpha, solves, rights):
    """The plain version of :func:`packed_gibbs_panel_grads_rows`."""
    f1_rows, _ = cotangent_factors(alpha_rows, solves_rows, rights_rows)
    _, f2 = cotangent_factors(alpha, solves, rights)
    return _panel_grads_plain(x_rows, ell_rows, f1_rows, x, ell, f2)


@functools.lru_cache(maxsize=8)
def packed_gibbs_panel_vjp_rows(d: int):
    """Row-block form of :func:`packed_gibbs_panel_vjp` (K3's row entry):

        rows(kernel, aug, sigma2, alpha, solves, rights, g, i0, nr)
            -> (gaug_rows_raw (nr, 2d), sp_rows (nr,))

    the rows' unscaled aug cotangent and their row sums of Ŵ ⊙ K.  The
    JAX package's returns each block's Σ sp; the port returns the rows, so
    that one sum over all of them gives the whole sweep's bits (each row
    already does: K3's row entry takes the whole sweep's column splits)."""

    def rows(kernel, aug, sigma2, alpha, solves, rights, g, i0, nr):
        sl = slice(i0, i0 + nr)
        x, ell = aug[:, :d], torch.exp(aug[:, d:])
        gx, gl, sp = packed_gibbs_panel_grads_rows(
            x[sl], ell[sl], alpha[sl], solves[sl], rights[sl], x, ell, alpha, solves, rights)
        return 2.0 * g * torch.cat([gx, gl * ell[sl]], dim=1), sp

    return rows


@functools.lru_cache(maxsize=8)
def packed_gibbs_panel_vjp(d: int, row_blocks: int = 1):
    """The fused backward of ``lazy_cg_mll`` for the packed Gibbs payload
    (``kernels.gibbs.packed_gibbs_cross(d)``'s operator, scaled when
    ``kernel`` is a raw outputscale, unscaled when it is None):

        panel_vjp(kernel, aug, sigma2, alpha, solves, rights, g)
            -> (kernel_grad, aug_grad, sigma2_grad)

    Valid only for the symmetric K(aug, aug) pullback: total = 2× the row
    side (``pallas_matvec.py:469-483``).  K3's sweep runs as ``row_blocks``
    calls of :func:`packed_gibbs_panel_vjp_rows`, one a block of N /
    ``row_blocks`` rows (the JAX package's ``bwd_row_chunks``, which keeps
    each of its device programs under its TPU's execution wall; one card
    has no such wall, so the port keeps it for parity: the blocks give the
    whole sweep's bits)."""
    rows = packed_gibbs_panel_vjp_rows(d)

    def panel_vjp(kernel, aug, sigma2, alpha, solves, rights, g):
        n = aug.shape[0]
        if n % row_blocks:
            raise ValueError(f"x length {n} is not divisible by the bwd row chunks {row_blocks}")
        nr = n // row_blocks
        blocks = [rows(kernel, aug, sigma2, alpha, solves, rights, g, i * nr, nr) for i in range(row_blocks)]
        gaug, sp = (torch.cat(b) for b in zip(*blocks))
        # σ²'s pullback is the trace identity g·tr(Ŵ)
        s2g = g * (0.5 * torch.dot(alpha, alpha) - (0.5 / solves.shape[-1]) * torch.sum(solves * rights))
        if kernel is None:
            return None, gaug, s2g
        # s² = softplus(raw): d s²/d raw = sigmoid(raw)
        return g * torch.sum(sp) * torch.sigmoid(kernel), positive(kernel) * gaug, s2g

    return panel_vjp


# ---------------------------------------------------------------------------
# operation counts, for the bound chip_smoke.py reports
# ---------------------------------------------------------------------------


def _tile_ops(d: int) -> int:
    """f32 operations per Gram element of the kernels' per-dim tile (K3,
    and K2 at d ≠ 2): per dim two squares and their sum (3), the product
    and its doubling (2), 1/ss (1), the ratio (1), its sqrtf (1), the
    prefactor product (1), the difference (1), its square scaled by 1/ss
    (2) and the quad sum (1) = 13; then the negation, expf and the final
    product (3)."""
    return 13 * d + 3


def _k2_elem_ops(d: int) -> int:
    """FP32-lane operations per Gram element of K2's element: at d = 2
    (``gibbs_elem.cuh``'s ``d2_elem``) the two sums s_k (2), their product (1), the two
    differences (2), d₀², d₁², d₀²·s₁ (3) and the FMA (2), rs² and its
    product (2), then the prefactor n_i·n_j, ·rs and ·2⁻ʸ (3) = 15; its
    rsqrt and ex2 run on the SFU and are counted by
    :func:`matvec_sfu_ops` alone.  Else the per-dim tile."""
    return 15 if d == 2 else _tile_ops(d)


def matvec_ops(n1: int, n2: int, d: int, r: int) -> int:
    """Operations of K2 over an n1 × n2 Gram with r right-hand sides: the
    element plus one FMA (2 ops) per right-hand side."""
    return n1 * n2 * (_k2_elem_ops(d) + 2 * r)


def matvec_sfu_ops(n1: int, n2: int, d: int) -> int:
    """Special-function-unit operations of K2 over an n1 × n2 Gram: at
    d = 2 one rsqrt and one ex2 an element; else per dim a division and a
    square root, and one exp."""
    return n1 * n2 * (2 if d == 2 else 2 * d + 1)


def _rbf_elem_ops(d: int) -> int:
    """FP32-lane operations per Gram element of K6's element: at d = 2 the
    two differences (2), d₀² (1) and the FMA (2) = 5, its ex2 on the SFU;
    else per dim the difference and its square-add (3), then the −½ product
    and ``expf`` (2)."""
    return 5 if d == 2 else 3 * d + 2


def rbf_matvec_ops(n1: int, n2: int, d: int, r: int) -> int:
    """Operations of K6 over an n1 × n2 Gram with r right-hand sides: the
    element plus one FMA (2 ops) per right-hand side."""
    return n1 * n2 * (_rbf_elem_ops(d) + 2 * r)


def _split_ops(precision: str) -> int:
    """FP32-lane operations per Gram element of a tensor-core mode's A
    operand: 'default' the bf16 rounding (1); 'high3' the rounding, its
    widening back, the remainder and its rounding (4)."""
    return {"default": 1, "high3": 4}[precision]


def mode_passes(precision: str) -> int:
    """mma products an element and right-hand side: 1 ('default'), 3 ('high3')."""
    return {"default": 1, "high3": 3}[precision]


def mode_ops(n1: int, n2: int, d: int, precision: str, elem_ops=None) -> int:
    """FP32-lane operations of K2's (``elem_ops`` K6's ``_rbf_elem_ops``)
    tensor-core mode over an n1 × n2 Gram: the element and its rounding; the
    contraction runs on the tensor cores (:func:`mma_ops`)."""
    return n1 * n2 * ((elem_ops or _k2_elem_ops)(d) + _split_ops(precision))


def mma_ops(n1: int, n2: int, r: int, precision: str) -> int:
    """Tensor-core operations of a mode's contraction: 2r an element a pass
    (a product and its sum), over the bf16 rate."""
    return 2 * n1 * n2 * r * mode_passes(precision)


def rbf_matvec_sfu_ops(n1: int, n2: int) -> int:
    """Special-function-unit operations of K6 over an n1 × n2 Gram: one
    exponential an element (``ex2.approx`` at d = 2; ``expf``'s ex2
    elsewhere)."""
    return n1 * n2


def _panel_elem_ops(d: int) -> int:
    """FP32-lane operations per element of K3 for P = W·K given W: at d = 2
    (``PanelElem::pull2``) the two sums s_k (2), their product (1), rs² (1),
    the two differences (2), h_k = s_(1−k)·rs² (2), d_k² (2), m_k = d_k²·h_k
    (2), their sum (1), then n_i·n_j, ·W, ·rs and ·2⁻ʸ (4) = 17; its rsqrt
    and ex2 run on the SFU and are counted by :func:`panel_grads_sfu_ops`
    alone.  Else the per-dim tile and P's product (1)."""
    return 17 if d == 2 else _tile_ops(d) + 1


def panel_grads_ops(nr: int, n: int, d: int, r: int) -> int:
    """Operations of K3 over nr rows × n columns with r probes: P = W·K,
    the cotangent W (1 + 2r FMAs), P's row sum (1), and per dim the two
    pullback sums: at d = 2 g_k = P·h_k, its FMA with d_k, 2 ln 2·m_k − 1
    (an FMA) and its FMA with g_k (7); else d·inv, its FMA, inv·(2d²·inv −
    1) and its FMA (9)."""
    return nr * n * (_panel_elem_ops(d) + 2 * (1 + 2 * r) + 1 + (7 if d == 2 else 9) * d)


def panel_grads_ops_per_dim(nr: int, n: int, d: int, r: int) -> int:
    """The count of K3's operations when every element is built from the
    per-dim tile (the walk's form at d ≠ 2), reported beside
    :func:`panel_grads_ops` at d = 2: the tile, the cotangent, P and its row
    sum (2) and 9 a dim; 83 an element at d = 2, r = 8."""
    return nr * n * (_tile_ops(d) + 2 * (1 + 2 * r) + 2 + 9 * d)


def panel_grads_sfu_ops(nr: int, n: int, d: int) -> int:
    """Special-function-unit operations of K3 over nr × n elements: at
    d = 2 one rsqrt and one ex2 an element; else per dim a division and a
    square root, and one exp."""
    return nr * n * (2 if d == 2 else 2 * d + 1)
