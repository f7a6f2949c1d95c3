"""K5 and K10c: the streaming Cholesky of one large SPD matrix, by hand for
Hopper.

Names: the port's ``streaming_cholesky`` is the JAX package's
``streaming_cholesky2`` (K5, the dispatched kernel), and
``streaming_cholesky_v1`` is the JAX package's ``streaming_cholesky``
(K10c, the v1 kernel that K5 superseded on the TPU).  K10c is described at
the end of this docstring.

Replaces ``nonstationary_precip_tpu/ops/pallas_chol.py::streaming_cholesky2``
(:818, ``pallas_call`` at :791 in ``_forward_streaming2``; body
``_stream2_kernel``, diagonal tiles from ``_chol_inv_rec``), which the JAX
package's ``ops/linalg.py::cholesky`` dispatches for every 2-D float32
matrix with 6144 ≤ N ≤ 8192.  The kernel is ``csrc/chol_stream.cu`` over
``csrc/chol_rl.cuh``: CUDA C++ for sm_90a, built with nvcc at first use
(``ops/cuda_build.py``) and bound through ctypes.

What bounds it on an H100.  The factorisation is N³/3 operations
(1.8·10¹¹ at N = 8192, 2.7 ms at the card's 67 TFLOP/s of f32 outside the
tensor cores) over 2·N² floats of input and output (0.5 GB, 0.16 ms at
3.35 TB/s): operations bound it, nearly all of them in the trailing
updates.  Next comes the dependent chain of N/128 diagonal tiles, each on
one SM while the kernels after it wait.

What the design does about it.  The TPU kernel is left-looking because the
TPU runs one grid step at a time and streams operands through VMEM; on the
H100 the work has to spread over 132 SMs.  So K5 is the right-looking
factorisation of ``csrc/chol_rl.cuh`` (which K10a shares), in place on the
factor, at 128-wide tiles; the matrix is identity-padded to a multiple of
``PANEL`` = 256 and the factor cut back at the end.  Per block column j,
one C call issues these kernels, 4·N/128 − 4 launches a call (252 at
N = 8192):
  * the diagonal tile in one CTA: the 128 × 128 tile as a square in shared
    memory beside its inverse (132 KB), factored and inverted by
    ``_chol_inv_rec``'s recursive 2 × 2 blocking down to 32-wide leaves,
    each leaf one warp in registers, the products between them over all
    eight warps: about twenty block barriers where a column sweep takes 256;
  * the panel L[jp+128:, j] = W[jp+128:, j]·L_jj⁻ᵀ by blocked forward
    substitution against L_jj, one CTA per 64 rows (a product with L_jj⁻¹
    is not backward stable: on the noisy Gibbs Gram at init it broke the
    bound γ_{N+1}|L||Lᵀ| that ``chip_smoke.py`` holds the factor to);
  * the trailing update W[jp+128:, jp+128:] −= P·Pᵀ on the lower 128 × 128
    tiles only (2016 CTAs at the first column of N = 8192), 256 threads
    each an 8 × 8 register micro-tile of f32 FFMAs over 16-deep k-slabs
    brought into a 3-stage shared-memory ring by ``cp.async``;
  * look-ahead: block column j + 1's update, its diagonal tile and its
    panel run on a second stream of the highest priority while the rest of
    column j's update runs on the caller's stream; events join the two
    inside the C call, so the diagonal tiles and panels hide behind the
    updates.
No cuBLAS, no ``torch.matmul``, no tensor cores, no TF32, no atomics: each
entry's 128 products are summed in ascending order and the block columns'
updates applied in column order, so every run gives the same bits.  A
failed diagonal tile comes out NaN, and so does everything to its right and
below, so ``safe_cholesky``'s retry sees a non-finite factor, as it sees the
TPU kernel's.  3×TF32 updates are left to later work.

The backward is not a kernel: ``safe_cholesky``'s closed-form pullback in
``torch`` (the JAX ``_s2bwd`` is plain XLA too).

Dispatch: ``ops/linalg.cholesky`` sends a matrix that ``stream_eligible``
accepts here; a CPU tensor takes ``streaming_cholesky_plain``, a
left-looking blocked algorithm in torch ops; a CUDA tensor launches the
kernel or raises.  ``LAUNCHES`` counts calls of the kernel's wrapper (each
call is 4·N/128 − 4 CUDA launches).

K10c replaces ``pallas_chol.py::streaming_cholesky`` (:601; forward
``_forward_streaming`` :561, ``pallas_call`` at :577, body ``_stream_kernel``
:438; backward ``_sbwd`` :611, the closed-form pullback).  No path of the JAX
package runs it; its entry here is ``streaming_cholesky_v1``, joined to no
dispatch, for one matrix with N ≤ 8192 padded to a multiple of 256.  It
computes K5's function, so it has K5's bound (N³/3 operations, then the
chain of diagonal tiles) and K5's design: ``csrc/chol_stream_v1.cu`` runs
``csrc/chol_rl.cuh``'s look-ahead factorisation in place on the padded
factor (4·N/128 − 4 launches a call): without look-ahead the same
factorisation took 22 % longer at N = 8192 and as long at 4096
(``tools/bench_chol_rl.py`` on an H100).  Its own library, entry, window, padding and
plain version stay.  ``V1_LAUNCHES`` counts calls of its wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from nonstationary_precip_tpu_torch.ops.cuda_build import CSRC, build_library

#: Padding width (the TPU kernel's ``SPANEL``; K5 and K10c pad to it).
PANEL = 256
#: K5's and K10c's kernels (``csrc/chol_rl.cuh`` with look-ahead), in the
#: order of its ``attributes()``.
KERNELS = ("diag_kernel", "panel_kernel", "syrk_kernel<column>", "syrk_kernel<triangle>")
#: The JAX dispatch window (``pallas_chol.py``: ``MIN_N_STREAM2``,
#: ``MAX_N_STREAM``).
MIN_N = 6144
MAX_N = 8192

#: Calls of the kernel's wrapper so far in this process; a run reads it to
#: show that its main path went through the kernel.
LAUNCHES = 0

SOURCE = CSRC / "chol_stream.cu"

_lib = None


def build(force: bool = False) -> str:
    """Compile ``csrc/chol_stream.cu``, load it, and return nvcc's output
    (registers, shared memory and spills per kernel).  Reused unless
    ``force``; a failed compile raises."""
    global _lib
    lib, log = build_library(SOURCE, force)
    p = ctypes.c_void_p
    lib.chol_stream.argtypes = [p, ctypes.c_int, p]
    lib.chol_stream.restype = ctypes.c_int
    lib.chol_stream_attributes.argtypes = [p]
    lib.chol_stream_attributes.restype = ctypes.c_int
    _lib = lib
    return log


def rl_attributes(query, kernels) -> dict:
    """{kernel: {regs, local_bytes, static_smem, dynamic_smem}} of a
    library's ``csrc/chol_rl.cuh`` kernels, named in the order of its
    ``*_attributes`` entry ``query``, as the CUDA runtime reports them."""
    out = (ctypes.c_int * (4 * len(kernels)))()
    err = query(out)
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
    keys = ("regs", "local_bytes", "static_smem", "dynamic_smem")
    return {k: dict(zip(keys, out[4 * i:4 * i + 4])) for i, k in enumerate(kernels)}


def kernel_attributes() -> dict:
    """``rl_attributes`` of K5's build (built first if need be)."""
    if _lib is None:
        build()
    return rl_attributes(_lib.chol_stream_attributes, KERNELS)


def stream_eligible(mat: torch.Tensor) -> bool:
    """The JAX package's ``stream2_eligible`` without its backend switch:
    one 2-D float32 matrix with MIN_N ≤ N ≤ MAX_N."""
    return (mat.ndim == 2 and mat.shape[0] == mat.shape[1] and mat.dtype == torch.float32
            and MIN_N <= mat.shape[-1] <= MAX_N)


def padded(mat: torch.Tensor, panel: int = PANEL) -> torch.Tensor:
    """``mat`` with an identity block appended to a multiple of ``panel``
    (``_forward_streaming2``'s padding); ``mat`` itself when none is needed."""
    n = mat.shape[-1]
    n_pad = -(-n // panel) * panel
    if n_pad == n:
        return mat
    out = torch.zeros((n_pad, n_pad), dtype=mat.dtype, device=mat.device)
    out[:n, :n] = mat
    out[n:, n:] = torch.eye(n_pad - n, dtype=mat.dtype, device=mat.device)
    return out


def streaming_cholesky_cuda(mat: torch.Tensor) -> torch.Tensor:
    """The kernel's wrapper: the lower factor of a 2-D float32 CUDA matrix
    (its lower triangle is read), from one C call on the current stream.
    Raises on anything the kernel does not take; no autograd."""
    global LAUNCHES
    if mat.ndim != 2 or mat.shape[0] != mat.shape[1]:
        raise ValueError(f"chol_stream kernel takes one square matrix, got {tuple(mat.shape)}")
    if mat.device.type != "cuda":
        raise ValueError(f"chol_stream kernel takes a CUDA tensor, got {mat.device}")
    if mat.dtype != torch.float32:
        raise TypeError(f"chol_stream kernel takes float32, got {mat.dtype}")
    if _lib is None:
        build()
    n = mat.shape[-1]
    l = torch.tril(padded(mat.contiguous()))  # the working matrix, factored in place
    n_pad = l.shape[-1]
    with torch.cuda.device(l.device):
        stream = torch.cuda.current_stream(l.device).cuda_stream
        err = _lib.chol_stream(l.data_ptr(), n_pad, stream)
    if err != 0:
        raise RuntimeError(f"chol_stream kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return l[:n, :n] if n_pad != n else l


def streaming_cholesky_plain(mat: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the same left-looking
    blocked algorithm, with ``torch.matmul`` for the update and the panel
    and ``cholesky_ex`` plus a triangular inverse for each diagonal tile.
    A tile whose factorisation fails is NaN, and the NaN spreads as in the
    kernel."""
    n = mat.shape[-1]
    p = PANEL
    a = padded(mat)
    n_pad = a.shape[-1]
    l = torch.zeros_like(a)
    eye = torch.eye(p, dtype=a.dtype, device=a.device)
    for jp in range(0, n_pad, p):
        c = a[jp:, jp:jp + p] - l[jp:, :jp] @ l[jp:jp + p, :jp].T
        ljj, info = torch.linalg.cholesky_ex(c[:p])
        bad = (info > 0) | ~torch.isfinite(ljj).all()
        ljj = torch.where(bad, torch.full_like(ljj, float("nan")), ljj)
        linv = torch.linalg.solve_triangular(ljj, eye, upper=False)
        l[jp:jp + p, jp:jp + p] = ljj
        l[jp + p:, jp:jp + p] = c[p:] @ linv.T
    return l[:n, :n]


def streaming_cholesky(mat: torch.Tensor) -> torch.Tensor:
    """Lower factor of one SPD matrix: the plain version for a CPU tensor,
    the kernel for a CUDA tensor (which raises on anything it does not
    take).  Forward only."""
    if mat.device.type == "cpu":
        return streaming_cholesky_plain(mat)
    if mat.device.type != "cuda":
        raise ValueError(f"chol_stream: no path for device {mat.device}")
    return streaming_cholesky_cuda(mat)


def cholesky_ops(n: int) -> float:
    """Operations of one factorisation of order n, N³/3 (the count the
    bound in ``chip_smoke.py`` uses)."""
    return n**3 / 3


# ---------------------------------------------------------------------------
# K10c: the v1 streaming Cholesky, right-looking
# ---------------------------------------------------------------------------

#: Calls of K10c's wrapper so far in this process (no path of the package
#: runs it).
V1_LAUNCHES = 0

V1_SOURCE = CSRC / "chol_stream_v1.cu"

_v1_lib = None


def build_v1(force: bool = False) -> str:
    """Compile ``csrc/chol_stream_v1.cu``, load it, and return nvcc's output.
    Reused unless ``force``; a failed compile raises."""
    global _v1_lib
    lib, log = build_library(V1_SOURCE, force)
    p = ctypes.c_void_p
    lib.chol_stream_v1.argtypes = [p, ctypes.c_int, p]
    lib.chol_stream_v1.restype = ctypes.c_int
    lib.chol_stream_v1_attributes.argtypes = [p]
    lib.chol_stream_v1_attributes.restype = ctypes.c_int
    _v1_lib = lib
    return log


def kernel_attributes_v1() -> dict:
    """``rl_attributes`` of K10c's build (built first if need be)."""
    if _v1_lib is None:
        build_v1()
    return rl_attributes(_v1_lib.chol_stream_v1_attributes, KERNELS)


def streaming_cholesky_v1_cuda(mat: torch.Tensor) -> torch.Tensor:
    """K10c's wrapper: the lower factor of a 2-D float32 CUDA matrix with
    N ≤ MAX_N (its lower triangle is read), from one C call on the current
    stream.  Raises on anything the kernel does not take; no autograd."""
    global V1_LAUNCHES
    if mat.ndim != 2 or mat.shape[0] != mat.shape[1]:
        raise ValueError(f"chol_stream_v1 kernel takes one square matrix, got {tuple(mat.shape)}")
    if mat.device.type != "cuda":
        raise ValueError(f"chol_stream_v1 kernel takes a CUDA tensor, got {mat.device}")
    if mat.dtype != torch.float32:
        raise TypeError(f"chol_stream_v1 kernel takes float32, got {mat.dtype}")
    n = mat.shape[-1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"chol_stream_v1 kernel takes 1 <= N <= {MAX_N}, got {n}")
    if _v1_lib is None:
        build_v1()
    l = torch.tril(padded(mat.contiguous()))  # the working matrix, factored in place
    n_pad = l.shape[-1]
    with torch.cuda.device(l.device):
        stream = torch.cuda.current_stream(l.device).cuda_stream
        err = _v1_lib.chol_stream_v1(l.data_ptr(), n_pad, stream)
    if err != 0:
        raise RuntimeError(f"chol_stream_v1 kernel launch failed: CUDA error {err}")
    V1_LAUNCHES += 1
    return l[:n, :n] if n_pad != n else l


def streaming_cholesky_v1_plain(mat: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K10c: a right-looking algorithm at
    256-wide panels, ``cholesky_ex`` plus a triangular inverse for each
    diagonal tile and ``torch.matmul`` for the panel and the trailing
    update.  A tile whose factorisation fails is NaN, and the NaN spreads as
    in the kernel."""
    n = mat.shape[-1]
    p = PANEL
    w = torch.tril(padded(mat))
    n_pad = w.shape[-1]
    l = torch.zeros_like(w)
    eye = torch.eye(p, dtype=w.dtype, device=w.device)
    for jp in range(0, n_pad, p):
        ljj, info = torch.linalg.cholesky_ex(w[jp:jp + p, jp:jp + p])
        bad = (info > 0) | ~torch.isfinite(ljj).all()
        ljj = torch.where(bad, torch.full_like(ljj, float("nan")), ljj)
        l[jp:jp + p, jp:jp + p] = ljj
        panel = w[jp + p:, jp:jp + p] @ torch.linalg.solve_triangular(ljj, eye, upper=False).T
        l[jp + p:, jp:jp + p] = panel
        w[jp + p:, jp + p:] -= panel @ panel.T
    return l[:n, :n]


class _StreamingCholeskyV1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mat):
        if mat.device.type == "cpu":
            chol = streaming_cholesky_v1_plain(mat)
        elif mat.device.type == "cuda":
            chol = streaming_cholesky_v1_cuda(mat)
        else:
            raise ValueError(f"streaming_cholesky_v1: no path for device {mat.device}")
        ctx.save_for_backward(chol)
        return chol

    @staticmethod
    def backward(ctx, g):
        from nonstationary_precip_tpu_torch.ops.linalg import cholesky_pullback

        (chol,) = ctx.saved_tensors
        return cholesky_pullback(chol, g)


def streaming_cholesky_v1(mat: torch.Tensor) -> torch.Tensor:
    """Lower factor of one SPD matrix by the v1 streaming algorithm (the JAX
    package's ``streaming_cholesky``): K10c on a CUDA tensor, its plain
    version on a CPU one.  The backward is the closed-form Cholesky
    pullback from the saved factor (the JAX ``_sbwd``)."""
    return _StreamingCholeskyV1.apply(mat)
