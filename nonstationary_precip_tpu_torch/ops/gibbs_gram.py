"""K9: the diagonal-Gibbs cross-Gram, by hand for Hopper.

Replaces ``nonstationary_precip_tpu/ops/pallas_gram.py::gibbs_gram_pallas``
(:136, ``pallas_call`` at :113, body ``_kernel``), which the JAX package's
``kernels/gibbs.py::gibbs_gram`` dispatches inside its gate.  The kernel is
``csrc/gibbs_gram.cu``: CUDA C++ for sm_90a, built with nvcc at first use
(``ops/cuda_build.py``) and bound through ctypes.

What bounds it on an H100.  The output: 4·N₁·N₂ bytes written (6.6 MB at
N = 1280, 2 µs at 3.35 TB/s), against 15 f32 operations an element at
d = 2 (0.37 µs at 1280²) and two on the special-function unit.

What the design does about it.  A 256-thread block owns a tile of 16·R
rows by 64 columns (R = 8 rows a thread: 128 × 64, 200 blocks at 1280²);
each thread a register tile of R rows, 16 apart, by 4 consecutive columns,
so a warp writes two rows of 256 contiguous bytes at once.  At d = 2 the element is ``csrc/gibbs_elem.cuh``'s
``d2_elem``, the one K2 computes (the JAX matvec kernel's rewrite: one
rsqrt of ss₀·ss₁, the numerator split into a row and a column factor, the
squared lengthscales prescaled by ln 2 so that exp is one ex2): the tile's
row factors and column factors are made once each in shared memory and read
into registers, and an element is then 15 f32 operations, one
``rsqrt.approx`` and one ``ex2.approx``.  Other d (on no path) take
``gibbs_elem``, the per-dim element K2 and K3 compute there.  No special
case on the diagonal, as on the TPU.  Each thread stores its tile a row at
a time as ``float4`` where the output's rows stay 16-byte aligned
(N₂ % 4 == 0), ``float2`` where they stay 8-byte aligned (the slice's
394-wide Grams), else a float at a time; the C entry picks the width.  The
tile's R and the ``float2`` path are measured (``tools/bench_k9.py``).

The backward is not a kernel: autograd through ``gibbs_gram_reference``
recomputed from the saved inputs, as the JAX ``_bwd`` does.

A stack of pairs (..., N, D) with one leading shape, a member per leading
index, is one launch: the members go on the grid's third axis, with strides
N₁·D, N₂·D and N₁·N₂.  This is what Pallas's vmap batching does to the TPU
kernel, which the JAX package runs under ``jax.vmap`` for every
split-stacked Gibbs Gram (the slice's step and evaluation, the sparse
model's roots); the port writes that vmap out as a leading axis.

Dispatch: ``kernels/gibbs.gibbs_gram`` sends a pair or a stack that
``eligible`` accepts here; ``gibbs_gram_pallas`` launches the kernel for a
CUDA tensor (which raises on anything it does not take) and runs the plain
version for a CPU one.  ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from nonstationary_precip_tpu_torch.kernels.gibbs import gibbs_gram_reference
from nonstationary_precip_tpu_torch.ops.cuda_build import CSRC, build_library
from nonstationary_precip_tpu_torch.ops.matvec import _k2_elem_ops

MAX_D = 8  # input dims the kernel takes (pallas_gram.py's _MAX_D)
MIN_ELEMS = 128 * 128  # the gate's least N₁·N₂
MAX_MEMBERS = 65535  # members a launch takes (the grid's third axis)

#: Launches of the kernel so far in this process; a run reads it to show
#: that its main path went through the kernel.
LAUNCHES = 0

SOURCE = CSRC / "gibbs_gram.cu"

_lib = None


def build(force: bool = False) -> str:
    """Compile ``csrc/gibbs_gram.cu``, load it, and return nvcc's output.
    Reused unless ``force``; a failed compile raises."""
    global _lib
    lib, log = build_library(SOURCE, force)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gibbs_gram.argtypes = [p, p, i, p, p, i, i, i, p, p]
    lib.gibbs_gram.restype = i
    _lib = lib
    return log


def members(x1: torch.Tensor) -> int:
    """The number of pairs in a stack (..., N, D): the product of its
    leading dims, 1 for a 2-D pair."""
    return math.prod(x1.shape[:-2])


def eligible(x1: torch.Tensor, x2: torch.Tensor) -> bool:
    """The JAX package's gate (``pallas_gram.py:41-66``) without its
    environment switch, the backend test read as "on the card", applied to
    each member as JAX's vmap applies it: float32, (..., N, D) with the same
    leading shape on both sides, D ≤ 8, N₁·N₂ ≥ 128² a member, and at most
    ``MAX_MEMBERS`` members."""
    return (x1.device.type == "cuda" and x1.dtype == torch.float32 and x2.dtype == torch.float32
            and x1.ndim >= 2 and x2.ndim == x1.ndim and x1.shape[:-2] == x2.shape[:-2]
            and x1.shape[-1] <= MAX_D and x1.shape[-2] * x2.shape[-2] >= MIN_ELEMS
            and members(x1) <= MAX_MEMBERS)


def gibbs_gram_cuda(x1, ell1, x2, ell2) -> torch.Tensor:
    """The kernel's wrapper: K(x1, ℓ1; x2, ℓ2), (..., N1, N2), from one
    launch on the current stream.  x1, ell1 (..., N1, D ≤ 8) and x2, ell2
    (..., N2, D), float32 CUDA tensors on one device with one leading shape
    of at most ``MAX_MEMBERS`` members; raises on anything else.  No
    autograd."""
    global LAUNCHES
    ts = (x1, ell1, x2, ell2)
    if any(t.device.type != "cuda" or t.device != x1.device for t in ts):
        raise ValueError("gibbs_gram kernel takes CUDA tensors on one device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("gibbs_gram kernel takes float32")
    if (x1.ndim < 2 or x1.shape != ell1.shape or x2.shape != ell2.shape or x2.ndim != x1.ndim
            or x1.shape[:-2] != x2.shape[:-2] or x1.shape[-1] != x2.shape[-1]):
        raise ValueError(f"gibbs_gram kernel: shapes {[tuple(t.shape) for t in ts]}")
    if not 1 <= x1.shape[-1] <= MAX_D:
        raise ValueError(f"gibbs_gram kernel takes D ≤ {MAX_D}, got {x1.shape[-1]}")
    nt = members(x1)
    if not 1 <= nt <= MAX_MEMBERS:
        raise ValueError(f"gibbs_gram kernel takes 1..{MAX_MEMBERS} members, got {nt}")
    if _lib is None:
        build()
    x1, ell1, x2, ell2 = (t.contiguous() for t in ts)
    n1, d, n2 = x1.shape[-2], x1.shape[-1], x2.shape[-2]
    out = torch.empty((*x1.shape[:-2], n1, n2), dtype=torch.float32, device=x1.device)
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        err = _lib.gibbs_gram(x1.data_ptr(), ell1.data_ptr(), n1, x2.data_ptr(), ell2.data_ptr(), n2, d, nt,
                              out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gibbs_gram kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


class _GibbsGram(torch.autograd.Function):
    """The kernel forward; the backward is autograd through the plain Gram
    recomputed from the inputs (the JAX ``_bwd``)."""

    @staticmethod
    def forward(ctx, x1, ell1, x2, ell2):
        ctx.save_for_backward(x1, ell1, x2, ell2)
        if x1.device.type == "cpu":
            return gibbs_gram_reference(x1, ell1, x2, ell2)
        if x1.device.type != "cuda":
            raise ValueError(f"gibbs_gram: no path for device {x1.device}")
        return gibbs_gram_cuda(x1, ell1, x2, ell2)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
            wanted = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(gibbs_gram_reference(*ins), wanted, g) if wanted else ())
        return tuple(next(grads) if t.requires_grad else None for t in ins)


def gibbs_gram_pallas(x1, ell1, x2, ell2) -> torch.Tensor:
    """K(x1, ℓ1; x2, ℓ2) through the kernel on the card (the plain version
    on the CPU), differentiable."""
    return _GibbsGram.apply(x1, ell1, x2, ell2)


def gram_ops(n1: int, n2: int, d: int) -> int:
    """FP32-lane operations of the Gram: K2's element count an element
    (``matvec._k2_elem_ops``: at d = 2 ``d2_elem``'s 15, an FMA as 2, its
    rsqrt and ex2 on the special-function unit; else the per-dim element)."""
    return n1 * n2 * _k2_elem_ops(d)


def gram_bytes(n1: int, n2: int, d: int) -> int:
    """Bytes the Gram must move: the four (N, D) payloads read once and the
    N₁ × N₂ output written once (the bound in ``chip_smoke.py``)."""
    return 4 * (2 * d * (n1 + n2) + n1 * n2)
