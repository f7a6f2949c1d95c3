"""K11: the blocked triangular solve X = L⁻¹B, by hand for Hopper.

Replaces ``nonstationary_precip_tpu/ops/pallas_trsm.py::blocked_trsm``
(:106, ``pallas_call`` at :88, body ``_trsm_kernel``), which the JAX
package's ``ops/linalg.py::tri_solve`` dispatches for a lower,
non-transposed solve with a 2-D L and a 2-D right-hand side inside its gate.
The kernel is ``csrc/trsm.cu``: CUDA C++ for sm_90a, built with nvcc at
first use (``ops/cuda_build.py``) and bound through ctypes.

What bounds it on an H100.  N²K operations, N²K/2 multiply-adds
(N = 1280, K = 256: 4.2·10⁸, 6 µs at 67 TFLOP/s of f32 outside the tensor
cores) against N² + 2NK floats moved (9.2 MB, 3 µs at 3.35 TB/s):
operations, on paper.
The substitution is sequential in the block rows, though, so the card's
parallelism is the K columns.

What the design does about it.  Columns of B are independent, so one
256-thread block owns a 16-column tile of X and walks the 128-row blocks in
order, with no synchronisation between blocks: rhs = B_i − L[i, :i]·X[:i],
then X_i = L_ii⁻¹·rhs.  The L_ii⁻¹ come first, from a kernel that inverts
every diagonal block at once (one block each, the inverse in shared memory,
as the TPU kernel's ``_tri_inv_block`` forms it by forward substitution of
the identity).  Both products stage 32-deep k-slabs in shared memory and
sum over k in ascending order in f32 FMAs.  N is identity-padded to a
multiple of 128 and K zero-padded to a multiple of 16 (``_forward``'s
padding), and the result cut back.

The backward is not a kernel: the JAX ``_bwd``'s closed form (:111-121) in
torch, B̄ = L⁻ᵀX̄ and L̄ = −tril(B̄Xᵀ).

Dispatch: ``ops/linalg.tri_solve`` sends a lower, non-transposed solve of
2-D operands that ``eligible`` accepts here; ``blocked_trsm`` runs the plain
version for CPU tensors and the kernel for CUDA ones (which raises on
anything it does not take).  ``LAUNCHES`` counts calls of the wrapper (two
CUDA launches each).
"""

from __future__ import annotations

import ctypes

import torch

from nonstationary_precip_tpu_torch.ops.chol_stream import padded
from nonstationary_precip_tpu_torch.ops.cuda_build import CSRC, build_library

BLOCK = 128  # block rows (the TPU kernel's BLOCK; csrc kB)
COLS = 16  # columns of X one CUDA block owns (csrc kCT)
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
    lib.trsm.argtypes = [p, p, p, p, i, i, p]
    lib.trsm.restype = i
    _lib = lib
    return log


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
    n_pad = lp.shape[-1]
    k_pad = -(-k // COLS) * COLS
    bp = torch.zeros((n_pad, k_pad), dtype=b.dtype, device=b.device)
    bp[:n, :k] = b
    x = torch.empty_like(bp)
    inv = torch.empty((n_pad, BLOCK), dtype=b.dtype, device=b.device)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = _lib.trsm(lp.data_ptr(), bp.data_ptr(), x.data_ptr(), inv.data_ptr(), n_pad, k_pad, stream)
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
