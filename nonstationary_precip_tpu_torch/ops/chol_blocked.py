"""K10a: the blocked Cholesky of one SPD matrix with 768 ≤ N ≤ 1280, by
hand for Hopper.

Replaces ``nonstationary_precip_tpu/ops/pallas_chol.py::blocked_cholesky``
(:251, ``pallas_call`` at :218, body ``_chol_kernel``), which the JAX
package's ``ops/linalg.py::cholesky`` dispatches for a 2-D float32 matrix in
that window.  The kernel is ``csrc/chol_blocked.cu``: CUDA C++ for sm_90a,
built with nvcc at first use (``ops/cuda_build.py``) and bound through
ctypes.

What bounds it on an H100.  N³/3 operations (7.0·10⁸ at N = 1280, 10 µs
at 67 TFLOP/s of f32 outside the tensor cores) over 2·N² floats moved (13 MB,
4 µs at 3.35 TB/s): operations, on paper.  In practice a dependent chain:
N/128 diagonal tiles, each on one SM, between kernels that cannot start
before them, and 3·N/128 − 2 launches.

What the design does about it.  The TPU kernel keeps the matrix in VMEM and
factors it right-looking at 128-wide blocks; 1280² f32 is 6.5 MB, too much
for an SM's shared memory but not for L2.  So K10a is the right-looking
factorisation of ``csrc/chol_rl.cuh``, which K5 shares, in place on the
factor at the TPU kernel's 128-wide blocks: for each block column the
diagonal tile in one CTA (recursive 2 × 2 blocking in shared memory down to
32-wide leaves, one warp each, L21 by forward substitution between them,
about a dozen block barriers a tile), the
panel by blocked forward substitution against L_jj, and the trailing update
on the lower 128 × 128 tiles (f32 FFMA micro-tiles over a ``cp.async``
ring, one CTA an SM; fixed-order sums, no atomics), in turn on the caller's
stream.  K5's look-ahead does not pay here: at these sizes a column's
trailing update is one wave, no longer than the diagonal tile it would
hide.  The matrix is identity-padded to a multiple of 128 (``_forward``'s
padding, exact since chol(diag(A, I)) = diag(chol(A), I)) and the factor
cut back; the upper triangle is zero.  A failed diagonal tile
is NaN and the NaN spreads, so ``safe_cholesky``'s retry sees a non-finite
factor, as on the TPU.

The backward is not a kernel: ``ops/linalg.safe_cholesky``'s closed-form
pullback, the formula of the JAX ``_chol_pullback`` (:232).

Dispatch: ``ops/linalg.cholesky_ex`` sends a matrix that ``eligible``
accepts here; ``blocked_cholesky`` runs the plain version for a CPU tensor
and the kernel for a CUDA one (which raises on anything it does not take).
``LAUNCHES`` counts calls of the kernel's wrapper (each is 3·N/128 − 2 CUDA
launches).
"""

from __future__ import annotations

import ctypes

import torch

from nonstationary_precip_tpu_torch.ops.chol_stream import padded, rl_attributes
from nonstationary_precip_tpu_torch.ops.cuda_build import CSRC, build_library

#: Padding width (the TPU kernel's ``BLOCK``; also the kernel's tile width,
#: ``csrc/chol_rl.cuh`` kT).
BLOCK = 128
#: K10a's kernels (``csrc/chol_rl.cuh``, no look-ahead), in the order of its
#: ``attributes()``.
KERNELS = ("diag_kernel", "panel_kernel", "syrk_kernel<triangle>")
#: The JAX dispatch window (``pallas_chol.py::eligible``; ``MAX_N``).
MIN_N = 768
MAX_N = 1280

#: Calls of the kernel's wrapper so far in this process; a run reads it to
#: show that its main path went through the kernel.
LAUNCHES = 0

SOURCE = CSRC / "chol_blocked.cu"

_lib = None


def build(force: bool = False) -> str:
    """Compile ``csrc/chol_blocked.cu``, load it, and return nvcc's output.
    Reused unless ``force``; a failed compile raises."""
    global _lib
    lib, log = build_library(SOURCE, force)
    p = ctypes.c_void_p
    lib.chol_blocked.argtypes = [p, ctypes.c_int, p]
    lib.chol_blocked.restype = ctypes.c_int
    lib.chol_blocked_attributes.argtypes = [p]
    lib.chol_blocked_attributes.restype = ctypes.c_int
    _lib = lib
    return log


def kernel_attributes() -> dict:
    """``chol_stream.rl_attributes`` of K10a's build (built first if need
    be)."""
    if _lib is None:
        build()
    return rl_attributes(_lib.chol_blocked_attributes, KERNELS)


def eligible(mat: torch.Tensor) -> bool:
    """The JAX package's gate without its environment and backend switches:
    one 2-D float32 matrix with MIN_N ≤ N ≤ MAX_N."""
    return (mat.ndim == 2 and mat.shape[0] == mat.shape[1] and mat.dtype == torch.float32
            and MIN_N <= mat.shape[-1] <= MAX_N)


def blocked_cholesky_cuda(mat: torch.Tensor) -> torch.Tensor:
    """The kernel's wrapper: the lower factor of a 2-D float32 CUDA matrix
    (its lower triangle is read), from one C call on the current stream.
    Raises on anything the kernel does not take; no autograd."""
    global LAUNCHES
    if mat.ndim != 2 or mat.shape[0] != mat.shape[1]:
        raise ValueError(f"chol_blocked kernel takes one square matrix, got {tuple(mat.shape)}")
    if mat.device.type != "cuda":
        raise ValueError(f"chol_blocked kernel takes a CUDA tensor, got {mat.device}")
    if mat.dtype != torch.float32:
        raise TypeError(f"chol_blocked kernel takes float32, got {mat.dtype}")
    if _lib is None:
        build()
    n = mat.shape[-1]
    l = torch.tril(padded(mat.contiguous(), BLOCK))  # the working matrix, factored in place
    n_pad = l.shape[-1]
    with torch.cuda.device(l.device):
        stream = torch.cuda.current_stream(l.device).cuda_stream
        err = _lib.chol_blocked(l.data_ptr(), n_pad, stream)
    if err != 0:
        raise RuntimeError(f"chol_blocked kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return l[:n, :n] if n_pad != n else l


def blocked_cholesky_plain(mat: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``torch.linalg.cholesky_ex``, the whole
    factor NaN when it fails (the kernel's is NaN from the failing block
    on; both are non-finite, which is what ``safe_cholesky`` tests)."""
    l, info = torch.linalg.cholesky_ex(mat)
    bad = (info > 0) | ~torch.isfinite(l).all()
    return torch.where(bad, torch.full_like(l, float("nan")), l)


def blocked_cholesky(mat: torch.Tensor) -> torch.Tensor:
    """Lower factor of one SPD matrix: the plain version for a CPU tensor,
    the kernel for a CUDA tensor (which raises on anything it does not
    take).  Forward only."""
    if mat.device.type == "cpu":
        return blocked_cholesky_plain(mat)
    if mat.device.type != "cuda":
        raise ValueError(f"chol_blocked: no path for device {mat.device}")
    return blocked_cholesky_cuda(mat)
