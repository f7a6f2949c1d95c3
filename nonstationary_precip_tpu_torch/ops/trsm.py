"""K11: the blocked triangular solve X = L⁻¹B, by hand for Hopper.

Replaces ``nonstationary_precip_tpu/ops/pallas_trsm.py::blocked_trsm``
(:106, ``pallas_call`` at :88, body ``_trsm_kernel``; diagonal inverses from
``pallas_chol._tri_inv_block`` :116), which the JAX package's
``ops/linalg.py::tri_solve`` dispatches for a lower, non-transposed solve
with a 2-D L and a 2-D right-hand side inside its gate.  The kernel is
``csrc/trsm.cu``: CUDA C++ for sm_90a, built with nvcc at first use
(``ops/cuda_build.py``) and bound through ctypes.

What bounds it on an H100.  N²K operations, N²K/2 multiply-adds
(N = 1280, K = 256: 4.2·10⁸, 6 µs at 67 TFLOP/s of f32 outside the tensor
cores) against N² + 2NK floats moved (9.2 MB, 3 µs at 3.35 TB/s):
operations, on paper.  But the 128-row blocks are a dependent chain, and so
is the substitution inside each diagonal block: the TPU kernel walks both in
turn, and a port that gives each CTA a column tile to walk keeps 16 CTAs of
132 SMs busy at K = 256.

What the design does about it.  It keeps the TPU kernel's algorithm,
X_i = L_ii⁻¹(B_i − Σ_{j<i} L_ij X_j), right-looking and spread over rows
and columns: one launch per block row i (N/128 launches a call), with a CTA
for each 32-wide column tile c and each block row j ≥ i (80 CTAs in the
first launch at N = 1280, K = 256).  Each CTA solves L_ii X_i[:, c] =
W_i[:, c] in shared memory, one 32-row block at a time: one warp, a lane a
column, substitutes the block in registers, multiplying by the pivots'
reciprocals, and then all 256 threads subtract the block's 32-deep product
from the rows below it.  The CTA with j = i writes X_i's tile; those with
j > i apply W_j[:, c] −= L_ji·X_i[:, c] (4 × 4 f32 FFMA micro-tiles over
16-byte shared-memory reads).  Every CTA forms X_i's tile by the same code,
so the update uses the bits written to X.  W is a working copy of B,
separate from X.  L's tiles and W's come in by ``cp.async`` (L_ji's copy
under the substitution), and each launch after the first is a programmatic
dependent of the one before, so its CTAs copy L_ii while that one
finishes.  Each product is a chain of FFMAs in ascending k (32 deep in the
tile, 128 deep across block rows) subtracted once, so the rounding grows
with 128 + N/128, and there are no atomics and no tensor cores: every run
gives the same bits.  The TPU kernel multiplies by L_ii⁻¹; that product
would be all FFMAs, but it is not backward stable: on the noisy Gibbs Gram
at init (N = 1024) its residual |LX − B| reaches 1.38 × γ_{N+1}|L||X|, the
substitution's 0.018 (``tests/test_torch_trsm_rl.py``).  N is
identity-padded to a multiple of 128 and K zero-padded to a multiple of 32
(``_forward``'s padding), and the result cut back.  A zero or non-finite
pivot makes X non-finite from its row on, as the TPU kernel's division
does.

The backward is not a kernel: the JAX ``_bwd``'s closed form (:111-121) in
torch, B̄ = L⁻ᵀX̄ and L̄ = −tril(B̄Xᵀ).

Dispatch: ``ops/linalg.tri_solve`` sends a lower, non-transposed solve of
2-D operands that ``eligible`` accepts here; ``blocked_trsm`` runs the plain
version for CPU tensors and the kernel for CUDA ones (which raises on
anything it does not take).  ``LAUNCHES`` counts calls of the wrapper
(N/128 CUDA launches each).
"""

from __future__ import annotations

import ctypes

import torch

from nonstationary_precip_tpu_torch.ops.chol_stream import padded, rl_attributes
from nonstationary_precip_tpu_torch.ops.cuda_build import CSRC, build_library

BLOCK = 128  # block rows (the TPU kernel's BLOCK; csrc kB)
COLS = 32  # columns of X one CTA owns (csrc kCT)
#: The kernel, as ``trsm_attributes`` reports it.
KERNELS = ("trsm_row_kernel",)
#: The JAX dispatch window (``pallas_trsm.py::eligible``).
MIN_N = 768
MAX_N = 1280
MAX_TOTAL_ELEMS = 3_500_000  # N² + 2NK

#: Calls of the kernel's wrapper so far in this process; a run reads it to
#: show that its main path went through the kernel.
LAUNCHES = 0

SOURCE = CSRC / "trsm.cu"

_lib = None


def build(force: bool = False) -> str:
    """Compile ``csrc/trsm.cu``, load it, and return nvcc's output.  Reused
    unless ``force``; a failed compile raises."""
    global _lib
    lib, log = build_library(SOURCE, force)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.trsm.argtypes = [p, p, p, i, i, p]
    lib.trsm.restype = i
    lib.trsm_attributes.argtypes = [p]
    lib.trsm_attributes.restype = i
    _lib = lib
    return log


def kernel_attributes() -> dict:
    """{"trsm_row_kernel": {regs, local_bytes, static_smem, dynamic_smem}}
    as the CUDA runtime reports them (built first if need be)."""
    if _lib is None:
        build()
    return rl_attributes(_lib.trsm_attributes, KERNELS)


def eligible(l: torch.Tensor, b: torch.Tensor) -> bool:
    """The JAX package's gate without its environment and backend switches:
    a 2-D float32 L and a 2-D B, 768 ≤ N ≤ 1280 and N² + 2NK ≤ 3.5M."""
    if l.dtype != torch.float32 or l.ndim != 2 or b.ndim != 2:
        return False
    n = l.shape[-1]
    return MIN_N <= n <= MAX_N and n * n + 2 * n * b.shape[-1] <= MAX_TOTAL_ELEMS


def trsm_cuda(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's wrapper: L⁻¹B for a lower-triangular L (N, N) (its lower
    triangle is read) and B (N, K), float32 CUDA tensors on one device, from
    one C call on the current stream.  Raises on anything else; no
    autograd."""
    global LAUNCHES
    if l.ndim != 2 or l.shape[0] != l.shape[1] or b.ndim != 2 or b.shape[0] != l.shape[0]:
        raise ValueError(f"trsm kernel: shapes {tuple(l.shape)}, {tuple(b.shape)}")
    if l.device.type != "cuda" or b.device != l.device:
        raise ValueError("trsm kernel takes CUDA tensors on one device")
    if l.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("trsm kernel takes float32")
    if _lib is None:
        build()
    n, k = b.shape
    lp = padded(l.contiguous(), BLOCK)
    if lp.data_ptr() % 16:  # the kernel copies 16-byte pieces
        lp = lp.clone()
    n_pad = lp.shape[-1]
    k_pad = -(-k // COLS) * COLS
    w = torch.zeros((n_pad, k_pad), dtype=b.dtype, device=b.device)  # the working copy of B
    w[:n, :k] = b
    x = torch.empty_like(w)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = _lib.trsm(lp.data_ptr(), w.data_ptr(), x.data_ptr(), n_pad, k_pad, stream)
    if err != 0:
        raise RuntimeError(f"trsm kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return x[:n, :k]


def trsm_plain(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``torch.linalg.solve_triangular``."""
    return torch.linalg.solve_triangular(l, b, upper=False)


class _BlockedTrsm(torch.autograd.Function):
    """X = L⁻¹B forward; the closed-form pullback from the saved X."""

    @staticmethod
    def forward(ctx, l, b):
        if l.device.type == "cpu":
            x = trsm_plain(l, b)
        elif l.device.type == "cuda":
            x = trsm_cuda(l, b)
        else:
            raise ValueError(f"trsm: no path for device {l.device}")
        ctx.save_for_backward(l, x)
        return x

    @staticmethod
    def backward(ctx, g):
        l, x = ctx.saved_tensors
        bbar = torch.linalg.solve_triangular(l.mT, g, upper=True)
        return -torch.tril(bbar @ x.mT), bbar


def blocked_trsm(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L⁻¹B through the kernel on the card (the plain version on the CPU),
    differentiable."""
    return _BlockedTrsm.apply(l, b)
