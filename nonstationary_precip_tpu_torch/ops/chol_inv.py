"""K1: batched (L, L⁻¹) with per-member escalating jitter, by hand for Hopper.

Replaces ``nonstationary_precip_tpu/ops/pallas_chol.py::chol_inv_batched_safe``
(:1054) and ``chol_inv_batched_v2`` (:997), whose Pallas body is
``_chol_inv_b_kernel`` → ``_chol_inv_nlevel_b`` (:862-929).  The kernel is
``csrc/chol_inv_batched.cu``: CUDA C++ for sm_90a, built with nvcc at first
use into ``build/torch_kernels/`` and bound through ctypes.

What bounds it on an H100.  At the slice's shape, T = 10 matrices of
N = 316, one call is ~0.2 GFLOP, and each matrix is a chain of N dependent
column steps.  It is latency-bound, far below any roofline: ten matrices
can occupy at most ten of the card's 132 SMs, and each SM runs N steps of
(pivot → scale → rank-1 update) separated by block barriers.

What the design does about it.  One 1024-thread block per matrix keeps the
whole factorisation and the inversion on one SM with no host round trip:
  * L⁻¹ comes out of the same sweep as L — row k of L⁻¹ is final at step k,
    and the elimination of L⁻¹ shares the rank-1 update loop with the Schur
    complement — so there is one chain of N steps, not two;
  * the working set is one packed lower triangle, held in shared memory
    when it fits (≤ 227 KB: N ≤ ~339, 200 KB at N = 316) and otherwise in
    an L2-resident global scratch slab, so the steps never touch HBM;
  * each lane keeps its slice of the pivot vector in registers across the
    rows it updates, so a shared-memory element update is one load and one
    store;
  * the jitter retry runs inside the block (a failing pivot restarts that
    block from A + j·I), so a healthy member runs exactly once with j = 0
    and no host synchronisation is needed.
The TPU kernel's 128-wide block algebra, its broadcast-and-reduce diagonal
recurrence and its Newton refinements were shaped by Mosaic and the MXU and
are not carried over.  Plain f32 FMAs throughout; no tensor cores, no TF32.
Splitting a matrix over several SMs, wgmma and TMA are left to later work.

The backward needs no kernel: it is the JAX package's matmul-only
``_civ2_bwd`` (:1011-1022), transcribed below with ``torch.matmul``.

Dispatch: a CPU tensor takes ``chol_inv_batched_safe_plain``; a CUDA f32
tensor launches the kernel; anything else raises.  ``LAUNCHES`` counts
kernel launches (and nothing else).
"""

from __future__ import annotations

import ctypes

import torch

from nonstationary_precip_tpu_torch.ops.cuda_build import CSRC, build_library
from nonstationary_precip_tpu_torch.ops.linalg import cholesky_failed, escalating_jitter
from nonstationary_precip_tpu_torch.utils.config import EPSILON

#: Largest N the kernel takes (the TPU gate's MAX_N_CHOLINV_B).
MAX_N = 384

#: Kernel launches so far in this process; a run reads it to show that its
#: main path went through the kernel.
LAUNCHES = 0

SOURCE = CSRC / "chol_inv_batched.cu"
# static shared memory and the per-block reserve beside the dynamic slab
_SMEM_RESERVE = 1024

_lib = None
_max_smem: dict[int, int] = {}


def build(force: bool = False) -> str:
    """Compile ``csrc/chol_inv_batched.cu`` (``ops/cuda_build.py``), load
    it, and return nvcc's output (the ``-Xptxas -v`` register and
    shared-memory report).  A library already built from the same source is
    reused unless ``force``.  A failed compile raises."""
    global _lib
    lib, log = build_library(SOURCE, force)
    lib.chol_inv_batched.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.chol_inv_batched.restype = ctypes.c_int
    lib.chol_inv_max_smem.argtypes = [ctypes.c_int]
    lib.chol_inv_max_smem.restype = ctypes.c_int
    _lib = lib
    return log


def smem_bytes(n: int) -> int:
    """Dynamic shared memory of the in-shared-memory variant: the pivot
    vector plus the packed lower triangle."""
    return 4 * (n + n * (n + 1) // 2)


def uses_smem(n: int, device: torch.device) -> bool:
    """Whether the kernel keeps its working triangle in shared memory at
    this N on this card (else in a global scratch slab)."""
    if _lib is None:
        build()
    dev = device.index if device.index is not None else torch.cuda.current_device()
    if dev not in _max_smem:
        _max_smem[dev] = _lib.chol_inv_max_smem(dev)
    return smem_bytes(n) + _SMEM_RESERVE <= _max_smem[dev]


def chol_inv_batched_cuda(mats: torch.Tensor, jitter: float = EPSILON, max_tries: int = 6):
    """The kernel's wrapper: (L, L⁻¹, jitter per member) of a contiguous
    (T, N ≤ MAX_N, N) float32 CUDA stack, from one launch on the current
    stream.  Raises on anything the kernel does not take; no autograd."""
    global LAUNCHES
    if mats.dtype != torch.float32:
        raise TypeError(f"chol_inv kernel takes float32, got {mats.dtype}")
    if mats.ndim != 3 or mats.shape[-1] != mats.shape[-2]:
        raise ValueError(f"chol_inv kernel takes a (T, N, N) stack, got {tuple(mats.shape)}")
    t, n, _ = mats.shape
    if not 1 <= n <= MAX_N or t < 1:
        raise ValueError(f"chol_inv kernel takes 1 <= N <= {MAX_N} and T >= 1, got T={t}, N={n}")
    if not mats.is_contiguous():
        raise ValueError("chol_inv kernel takes a contiguous stack")
    use_smem = uses_smem(n, mats.device)
    l = torch.empty_like(mats)
    li = torch.empty_like(mats)
    jit = torch.empty(t, dtype=mats.dtype, device=mats.device)
    scratch = torch.empty(0 if use_smem else t * n * (n + 1) // 2, dtype=mats.dtype,
                          device=mats.device)
    with torch.cuda.device(mats.device):
        stream = torch.cuda.current_stream(mats.device).cuda_stream
        err = _lib.chol_inv_batched(
            mats.data_ptr(), l.data_ptr(), li.data_ptr(), jit.data_ptr(),
            scratch.data_ptr() if scratch.numel() else None,
            t, n, float(jitter), int(max_tries), int(use_smem), stream)
    if err != 0:
        raise RuntimeError(f"chol_inv kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return l, li, jit


def _plain_attempt(mats):
    chol, info = torch.linalg.cholesky_ex(mats)
    eye = torch.eye(mats.shape[-1], dtype=mats.dtype, device=mats.device).expand_as(mats)
    linv = torch.linalg.solve_triangular(chol, eye, upper=False)
    return (chol, linv), cholesky_failed(chol, info)


def chol_inv_batched_safe_plain(mats: torch.Tensor, jitter: float = EPSILON, max_tries: int = 6):
    """The plain PyTorch version of the kernel: batched ``cholesky_ex`` +
    ``solve_triangular`` against the identity, with the same per-member
    jitter ladder.  Returns (L, L⁻¹, jitter per member)."""
    (l, li), jit = escalating_jitter(mats, _plain_attempt, jitter, max_tries)
    return l, li, jit


def _forward(mats, jitter, max_tries):
    if mats.device.type == "cpu":
        return chol_inv_batched_safe_plain(mats, jitter, max_tries)
    if mats.device.type != "cuda":
        raise ValueError(f"chol_inv: no path for device {mats.device}")
    return chol_inv_batched_cuda(mats, jitter, max_tries)


def civ2_bwd(l, li, lbar, libar):
    """Pullback of (L, L⁻¹) = chol_inv(K) to K̄, matmuls only (the JAX
    package's ``_civ2_bwd``).  A ``None`` cotangent counts as zeros."""
    lbar = torch.zeros_like(l) if lbar is None else lbar
    libar = torch.zeros_like(li) if libar is None else libar
    lit = li.mT
    lbar = torch.tril(lbar) - torch.tril(lit @ libar @ lit)
    p = l.mT @ lbar
    phi = torch.tril(p) - 0.5 * torch.diag_embed(torch.diagonal(p, dim1=-2, dim2=-1))
    kbar_t = lit @ phi @ li
    return 0.5 * (kbar_t + kbar_t.mT)


class _CholInvBatched(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mats, jitter, max_tries):
        l, li, jit = _forward(mats, jitter, max_tries)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(jit)
        ctx.save_for_backward(l, li)
        return l, li, jit

    @staticmethod
    def backward(ctx, lbar, libar, _):
        l, li = ctx.saved_tensors
        return civ2_bwd(l, li, lbar, libar), None, None


def chol_inv_batched_safe(mats: torch.Tensor, jitter: float = EPSILON, max_tries: int = 6,
                          *, return_jitter: bool = False):
    """(L, L⁻¹) of a (T, N, N) SPD stack, with the JAX package's per-member
    escalating-jitter retry: a member whose factor is not finite is refactored
    from A + j·I, j = ``jitter`` then ×10, at most ``max_tries`` times.
    ``return_jitter`` appends the (T,) jitter each member ended with."""
    l, li, jit = _CholInvBatched.apply(mats, jitter, max_tries)
    return (l, li, jit) if return_jitter else (l, li)


def chol_inv_batched_v2(mats: torch.Tensor):
    """(L, L⁻¹) with the retry off: the same kernel, one try."""
    l, li, _ = _CholInvBatched.apply(mats, EPSILON, 0)
    return l, li
