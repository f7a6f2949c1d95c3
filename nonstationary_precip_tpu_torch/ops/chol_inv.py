"""K1: batched (L, L⁻¹) with per-member escalating jitter, by hand for Hopper.

Replaces ``nonstationary_precip_tpu/ops/pallas_chol.py::chol_inv_batched_safe``
(:1054) and ``chol_inv_batched_v2`` (:997), whose Pallas body is
``_chol_inv_b_kernel`` → ``_chol_inv_nlevel_b`` (:862-929).  The kernel is
``csrc/chol_inv_cluster.cu``: CUDA C++ for sm_90a, built with nvcc at first
use into ``build/torch_kernels/`` and bound through ctypes.

What bounds it on an H100.  At the slice's shape, T = 10 matrices of
N = 316, one call is ~0.2 GFLOP, 3 µs at the f32 peak: it is latency-bound.
Each member is a chain of dependent steps, and ten members cannot fill the
card on their own.

What the design does about it.  One launch a call; one thread-block
cluster of ``cluster_size()`` CTAs a member, on as many SMs, so each
member's work spreads over several SMs and N = 384's 78 tiles of 32 × 32
(312 KB) stay in the cluster's shared memory:
  * the member, padded inside the kernel to a multiple of 32 with an
    identity block, is factored right-looking in 32-wide block columns,
    each tile held by one CTA of the cluster;
  * a block step is a one-warp leaf in registers (L_kk and L_kk⁻¹ in one
    pass), the panel and row k of L⁻¹ by forward substitution, one warp a
    tile, and a rank-32 FFMA update of every tile below row k in 4 × 4
    register micro-tiles, each CTA on the tiles it owns, its operands
    copied in through distributed shared memory; cluster barriers between;
  * L⁻¹ comes out of the same sweep: below the diagonal, a tile holds L's
    Schur complement until its block column is factored and the partial
    substitution of the identity afterwards, so nb = ⌈N / 32⌉ steps give
    both, where the column kernel this one replaced took N;
  * the jitter retry runs inside the cluster (a failing pivot, the same in
    every CTA, or a non-finite panel entry, OR-ed over the cluster, restarts
    it from A + j·I), so a healthy member runs exactly once with j = 0 and
    no host synchronisation is needed.
The TPU kernel's 128-wide block algebra, its broadcast-and-reduce diagonal
recurrence and its Newton refinements were shaped by Mosaic and the MXU and
are not carried over.  Plain f32 FMAs throughout; no tensor cores, no TF32.

The backward needs no kernel: it is the JAX package's matmul-only
``_civ2_bwd`` (:1011-1022), transcribed below with ``torch.matmul``.

Dispatch: a CPU tensor takes ``chol_inv_batched_safe_plain``; a CUDA f32
tensor launches the kernel; anything else raises.  ``LAUNCHES`` counts
kernel launches (and nothing else).

K10b, the retry-free grid-batched (L, L⁻¹), sits beside K1 here.  It
replaces ``pallas_chol.py::chol_inv_batched`` (:348; forward
``_chol_inv_forward`` :284, ``pallas_call`` at :303, body
``_chol_inv_kernel`` :275), which the JAX package runs on no path (its
gate ``cholinv_eligible``, :326, is opt-in): its entry here is
``chol_inv_batched``, joined to no dispatch.  A member that is not PD
comes out non-finite, the others unaffected; there is no jitter.  That is
K1's kernel with its retry off, so K10b launches ``csrc/chol_inv_cluster.cu``
with ``max_tries = 0``: one jitter-free try, a member whose try fails left
NaN by the cluster header's ``factor()``, each member its own cluster and
so untouched by the others.  ``chol_inv_batched_v2`` (K1 without its
retry) launches the same kernel with the same arguments, so the two give
the same bits.  The C entry takes N up to K10b's window top, 512, where a
CTA of a cluster of 8 holds 17 tile slots, the operand buffer and L_kk
(157 KB; at a cluster of 4, 235 KB would not fit the 227 KB); K1's wrapper
keeps the JAX gate's 384.  The member is padded inside the kernel, by the
Source's identity past N, to a multiple of 32: no host copy, no scratch.
At the deep GP's K_zz stack, 50 × 250², it is ~0.5 GFLOP of dependent
block steps: like K1, latency-bound.  Its backward is ``civ2_bwd``: the
JAX ``_ci_bwd`` (:370) differs from ``_civ2_bwd`` only in taking L̄ whole
where ``_civ2_bwd`` takes tril(L̄), and L̄'s strict upper triangle never
reaches tril(LᵀL̄), so the two are the same function.  ``GRID_LAUNCHES``
counts its launches, apart from K1's ``LAUNCHES``.
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

SOURCE = CSRC / "chol_inv_cluster.cu"

_lib = None


def build(force: bool = False) -> str:
    """Compile ``csrc/chol_inv_cluster.cu`` (``ops/cuda_build.py``), load
    it, and return nvcc's output (the ``-Xptxas -v`` register and
    shared-memory report).  A library already built from the same source is
    reused unless ``force``.  A failed compile raises."""
    global _lib
    lib, log = build_library(SOURCE, force)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.chol_inv_cluster.argtypes = [p] * 4 + [i, i, ctypes.c_float, i, p]
    lib.chol_inv_cluster.restype = i
    for name in ("chol_inv_cluster_smem", "chol_inv_max_smem", "chol_inv_max_clusters"):
        getattr(lib, name).argtypes = [i]
        getattr(lib, name).restype = i
    lib.chol_inv_cluster_size.argtypes = []
    lib.chol_inv_cluster_size.restype = i
    _lib = lib
    return log


def _library():
    if _lib is None:
        build()
    return _lib


def cluster_size() -> int:
    """CTAs a member: the cluster size the kernel is built with."""
    return _library().chol_inv_cluster_size()


def smem_bytes(n: int) -> int:
    """Dynamic shared memory each CTA of a member's cluster takes at this N."""
    return _library().chol_inv_cluster_smem(n)


def max_smem(device: int = 0) -> int:
    """Largest dynamic shared memory one block may opt in to on the card."""
    return _library().chol_inv_max_smem(device)


def max_active_clusters(n: int) -> int:
    """Members the card runs at once at this N (``cudaOccupancyMaxActiveClusters``
    on the current card); negative is a CUDA error."""
    return _library().chol_inv_max_clusters(n)


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
    if mats.device.type != "cuda":
        raise ValueError(f"chol_inv kernel takes a CUDA tensor, got {mats.device}")
    out = _launch(mats, float(jitter if jitter > 0 else EPSILON), int(max_tries))
    LAUNCHES += 1
    return out


def _launch(mats: torch.Tensor, jitter: float, max_tries: int):
    """One launch of the cluster kernel on the current stream over a
    checked, contiguous (T, N, N) float32 CUDA stack: (L, L⁻¹, jitter per
    member)."""
    lib = _library()
    l = torch.empty_like(mats)
    li = torch.empty_like(mats)
    jit = torch.empty(mats.shape[0], dtype=mats.dtype, device=mats.device)
    with torch.cuda.device(mats.device):
        stream = torch.cuda.current_stream(mats.device).cuda_stream
        err = lib.chol_inv_cluster(mats.data_ptr(), l.data_ptr(), li.data_ptr(), jit.data_ptr(), mats.shape[0],
                                   mats.shape[-1], jitter, max_tries, stream)
    if err != 0:
        raise RuntimeError(f"chol_inv kernel launch failed: CUDA error {err}")
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
    """(L, L⁻¹) with the retry off: the same kernel, one try.  K10b
    (``chol_inv_grid_cuda``) launches it with the same arguments."""
    l, li, _ = _CholInvBatched.apply(mats, EPSILON, 0)
    return l, li


# ---------------------------------------------------------------------------
# K10b: grid-batched (L, L⁻¹), no retry
# ---------------------------------------------------------------------------

#: The JAX package's window for the grid-batched kernel (``BLOCK`` ≤ N ≤
#: ``MAX_N_CHOLINV``); the C entry takes 1 ≤ N ≤ GRID_MAX_N.
GRID_MIN_N, GRID_MAX_N = 128, 512

#: K10b launches so far in this process (no path of the package runs it).
GRID_LAUNCHES = 0


def chol_inv_grid_cuda(mats: torch.Tensor):
    """K10b's wrapper: (L, L⁻¹) of a (B, N ≤ GRID_MAX_N, N) float32 CUDA
    stack from one launch of K1's kernel with its retry off, on the current
    stream.  Raises on anything the kernel does not take; no autograd."""
    global GRID_LAUNCHES
    if mats.device.type != "cuda":
        raise ValueError(f"chol_inv_grid kernel takes a CUDA tensor, got {mats.device}")
    if mats.dtype != torch.float32:
        raise TypeError(f"chol_inv_grid kernel takes float32, got {mats.dtype}")
    if mats.ndim != 3 or mats.shape[-1] != mats.shape[-2]:
        raise ValueError(f"chol_inv_grid kernel takes a (B, N, N) stack, got {tuple(mats.shape)}")
    b, n, _ = mats.shape
    if not 1 <= n <= GRID_MAX_N or b < 1:
        raise ValueError(f"chol_inv_grid kernel takes 1 <= N <= {GRID_MAX_N} and B >= 1, got B={b}, N={n}")
    l, li, _ = _launch(mats.contiguous(), EPSILON, 0)  # one try: its jitter is 0
    GRID_LAUNCHES += 1
    return l, li


def chol_inv_batched_plain(mats: torch.Tensor):
    """The plain PyTorch version of K10b: batched ``cholesky_ex`` and
    ``solve_triangular`` against the identity, no retry; a member whose
    factorisation fails is NaN."""
    chol, info = torch.linalg.cholesky_ex(mats)
    chol = torch.where(cholesky_failed(chol, info)[..., None, None], torch.full_like(chol, float("nan")), chol)
    eye = torch.eye(mats.shape[-1], dtype=mats.dtype, device=mats.device).expand_as(mats)
    return chol, torch.linalg.solve_triangular(chol, eye, upper=False)


class _CholInvGrid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mats):
        if mats.device.type == "cpu":
            l, li = chol_inv_batched_plain(mats)
        elif mats.device.type == "cuda":
            l, li = chol_inv_grid_cuda(mats)
        else:
            raise ValueError(f"chol_inv_batched: no path for device {mats.device}")
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(l, li)
        return l, li

    @staticmethod
    def backward(ctx, lbar, libar):
        l, li = ctx.saved_tensors
        return civ2_bwd(l, li, lbar, libar)


def chol_inv_batched(mats: torch.Tensor):
    """(L, L⁻¹) of a (B, N, N) SPD stack with no jitter retry (the JAX
    package's ``chol_inv_batched``): K10b on a CUDA tensor, its plain
    version on a CPU one.  A member that is not PD comes out non-finite and
    leaves the others unaffected.  The backward is matmul-only
    (``civ2_bwd``), from the primal L⁻¹."""
    return _CholInvGrid.apply(mats)
