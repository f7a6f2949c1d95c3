"""K4: the fused whitened-SVGP K_zz precompute, by hand for Hopper.

Replaces ``nonstationary_precip_tpu/ops/pallas_svgp.py::svgp_precompute_fused``
(:367, ``pallas_call`` at :311, body ``_svgp_kernel`` :183-282).  For every
member t of a stack (every output dim of every DGP layer, of every split):

    K_t = s²_t · exp(−½ ‖(z_i − z_j)/ℓ_t‖²) + εI   (diagonal exactly s²_t + ε)
    (L_t, L_t⁻¹) = chol(K_t), with K4's own jitter retry
    W_t = L_t⁻ᵀ · P_t                                 (P = [m | tril(S) | I])

The kernel is ``csrc/svgp_precompute.cu``: CUDA C++ for sm_90a, built with
nvcc at first use into ``build/torch_kernels/`` and bound through ctypes.

What bounds it on an H100.  At the DSVI path's shape (T = 10 splits × 5
outputs = 50 members, M = 250, P = 2M + 1 = 501) one call is ~2.1·10⁹
operations (M³/3 each for the factor and the inverse, M²·P for the
triangular W, per member) and moves ~75 MB (P read; L, L⁻¹ and W written),
so the card could do it in ~0.03 ms.  It cannot: each member's
factorisation is a chain of dependent steps.

What the design does about it.  One launch a call, one thread-block
cluster a member (``cluster_size()`` CTAs), on the block-step machinery
that K1 uses (``csrc/chol_inv_cluster.cuh``):
  * every CTA builds the Gram tiles it owns in place in shared memory from
    z/ℓ and s² (K_zz never reaches device memory), and the member is
    factored right-looking in 32-wide block columns: nb = ⌈M/32⌉ = 8 block
    steps at M = 250, each a one-warp leaf, substitutions and a rank-32
    update spread over the cluster, where the column sweep this replaced
    (one 1024-thread block a member) took M dependent steps on one SM.  L⁻¹ rides along in the same chain;
  * W = L⁻ᵀP is the cluster's tail: after the last step the cluster's
    shared memory holds every tile of L⁻¹, so each CTA takes chunks of P's
    columns and forms its slice of W from register micro-tiles, with P's
    row blocks double-buffered through ``cp.async`` and L⁻¹'s tiles copied
    from the cluster's other CTAs.  L⁻¹ is not read back from device
    memory, and the second launch of the two-kernel design is gone;
  * the retry runs inside the cluster, so a healthy member runs once.
The cluster size and the CTAs an SM are measured (``tools/bench_k4.py``).
The TPU kernel's 256-padding, its 128-lane z layout, its batched
broadcast-and-reduce recurrence and its Newton refinements were Mosaic's
and are not carried over.  Plain f32: IEEE division and ``expf`` in the
Gram, K1's ``rsqrtf`` leaf, the substitutions by the IEEE reciprocal of
the diagonal (K1 divides; ``tools/bench_k4.py`` times K4 with IEEE
``sqrtf`` and division in the leaf, and with division in the
substitutions), no tensor cores, a fixed summation order and no atomics.

K4's jitter ladder, not K1's.  A member whose L or L⁻¹ is not finite is
refactored from K + 1e-4·I, then from K + (1e-4 + 1e-2)·I, at most 3
tries (the TPU kernel's :268-282); the diagonal accumulates in the working
dtype, ((s² + ε) + 1e-4) + 1e-2.  Healthy members keep their exact first
factor.  A member that fails all three comes back NaN.  The TPU kernel
tests "L and W finite"; with a finite P, L⁻¹ finite gives W finite, and
W's identity block is L⁻ᵀ itself, so the two tests agree on the packed
[m | tril(S) | I] the model passes.

The backward needs no kernel: it is the JAX package's ``_bwd`` (:384-426),
GEMMs against the exported L⁻¹ and then the gram VJP, transcribed with
``torch.matmul`` inside an ``autograd.Function``; autograd takes the gram
VJP through the plain gram.

Dispatch: a CPU tensor takes ``svgp_precompute_plain``; a CUDA f32 stack
launches the kernel; anything else raises.  ``LAUNCHES`` counts kernel
calls (and nothing else).
"""

from __future__ import annotations

import ctypes

import torch

from nonstationary_precip_tpu_torch.ops.cuda_build import CSRC, build_library
from nonstationary_precip_tpu_torch.ops.linalg import cholesky_failed
from nonstationary_precip_tpu_torch.utils.config import EPSILON

#: Largest inducing count and feature dimension the kernel takes.
MAX_M = 256
MAX_D = 8

#: The extra diagonal each retry adds on top of the last (3 tries in all).
LADDER = (1e-4, 1e-2)

#: Kernel calls so far in this process; a run reads it to show that its
#: main path went through the kernel.
LAUNCHES = 0

SOURCE = CSRC / "svgp_precompute.cu"

_lib = None


def build(force: bool = False) -> str:
    """Compile ``csrc/svgp_precompute.cu`` (``ops/cuda_build.py``), load it,
    and return nvcc's output (the ``-Xptxas -v`` register, shared-memory and
    spill report).  A library already built from the same source is reused
    unless ``force``.  A failed compile raises."""
    global _lib
    lib, log = build_library(SOURCE, force)
    lib.svgp_precompute.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                                 ctypes.c_void_p]
    lib.svgp_precompute.restype = ctypes.c_int
    for name, args in (("svgp_cluster_size", []), ("svgp_smem_bytes", [ctypes.c_int] * 2),
                       ("svgp_max_smem", [ctypes.c_int]), ("svgp_max_clusters", [ctypes.c_int] * 2)):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = ctypes.c_int
    _lib = lib
    return log


def _library():
    if _lib is None:
        build()
    return _lib


def cluster_size() -> int:
    """CTAs a member: the cluster size the kernel is built with."""
    return _library().svgp_cluster_size()


def smem_bytes(m: int, d: int) -> int:
    """Dynamic shared memory each CTA of a member's cluster takes at (M, D)."""
    return _library().svgp_smem_bytes(m, d)


def max_smem(device: int = 0) -> int:
    """Largest dynamic shared memory one block may opt in to on the card."""
    return _library().svgp_max_smem(device)


def max_active_clusters(m: int, d: int) -> int:
    """Members the card runs at once at (M, D) (``cudaOccupancyMaxActiveClusters``
    on the current card); negative is a CUDA error."""
    return _library().svgp_max_clusters(m, d)


def svgp_precompute_cuda(z: torch.Tensor, ell: torch.Tensor, s2: torch.Tensor, packed: torch.Tensor):
    """The kernel's wrapper: (L, W, L⁻¹, jitter per member) of contiguous
    float32 CUDA tensors z (T, M ≤ 256, D ≤ 8), ℓ (T, D), s² (T,) and P
    (T, M, P), from one call on the current stream.  Raises on anything the
    kernel does not take; no autograd."""
    global LAUNCHES
    args = (z, ell, s2, packed)
    if any(a.dtype != torch.float32 for a in args):
        raise TypeError(f"svgp_precompute kernel takes float32, got {[a.dtype for a in args]}")
    if z.ndim != 3 or packed.ndim != 3:
        raise ValueError(f"svgp_precompute kernel takes z (T, M, D) and P (T, M, P), got "
                         f"{tuple(z.shape)} and {tuple(packed.shape)}")
    t, m, d = z.shape
    p = packed.shape[-1]
    if tuple(ell.shape) != (t, d) or tuple(s2.shape) != (t,) or tuple(packed.shape[:2]) != (t, m):
        raise ValueError(f"svgp_precompute kernel: shapes z {tuple(z.shape)}, ell {tuple(ell.shape)}, "
                         f"s2 {tuple(s2.shape)}, P {tuple(packed.shape)} do not agree")
    if not (1 <= m <= MAX_M and 1 <= d <= MAX_D and 1 <= t <= 65535 and p >= 1):
        raise ValueError(f"svgp_precompute kernel takes 1 <= M <= {MAX_M}, 1 <= D <= {MAX_D}, "
                         f"1 <= T <= 65535, got T={t}, M={m}, D={d}, P={p}")
    if any(not a.is_contiguous() for a in args):
        raise ValueError("svgp_precompute kernel takes contiguous tensors")
    if any(a.device != z.device for a in args):
        raise ValueError("svgp_precompute kernel: all inputs must be on one device")
    lib = _library()
    l = torch.empty((t, m, m), dtype=z.dtype, device=z.device)
    li = torch.empty_like(l)
    w = torch.empty((t, m, p), dtype=z.dtype, device=z.device)
    jit = torch.empty(t, dtype=z.dtype, device=z.device)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = lib.svgp_precompute(
            z.data_ptr(), ell.data_ptr(), s2.data_ptr(), packed.data_ptr(),
            l.data_ptr(), w.data_ptr(), li.data_ptr(), jit.data_ptr(), t, m, d, p, EPSILON, stream)
    if err != 0:
        raise RuntimeError(f"svgp_precompute kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return l, w, li, jit


def _gram(z, ell, s2):
    """s²·RBF(z/ℓ) per member, (T, M, M), without the εI: the gram whose VJP
    the JAX package's ``_bwd`` takes (its diagonal is s²·exp(−½·max(q, 0))
    with q ≈ 0, which gives the diagonal's gradient)."""
    zs = z / ell[:, None, :]
    sq = torch.sum(zs * zs, dim=-1)
    quad = torch.clamp(sq[:, :, None] + sq[:, None, :] - 2.0 * (zs @ zs.mT), min=0.0)
    return s2[:, None, None] * torch.exp(-0.5 * quad)


def gram_zz_plain(z, ell, s2):
    """The kernel's K: ``_gram`` with the diagonal set to exactly s² + ε (the
    TPU kernel's :211-212)."""
    k = _gram(z, ell, s2)
    torch.diagonal(k, dim1=-2, dim2=-1).copy_((s2 + EPSILON)[:, None].expand(-1, k.shape[-1]))
    return k


def _attempt(k, packed):
    l, info = torch.linalg.cholesky_ex(k)
    eye = torch.eye(k.shape[-1], dtype=k.dtype, device=k.device).expand_as(k)
    linv = torch.linalg.solve_triangular(l, eye, upper=False)
    w = linv.mT @ packed
    failed = cholesky_failed(l, info) | ~torch.isfinite(linv).all(dim=-1).all(dim=-1)
    return [l, w, linv], failed | ~torch.isfinite(w).all(dim=-1).all(dim=-1)


@torch.no_grad()
def svgp_precompute_plain(z: torch.Tensor, ell: torch.Tensor, s2: torch.Tensor, packed: torch.Tensor):
    """The plain PyTorch version of the kernel: the gram in torch ops, a
    batched ``cholesky_ex`` with K4's per-member ladder, ``solve_triangular``
    against the identity for L⁻¹, and W = L⁻ᵀ·P.  Returns (L, W, L⁻¹,
    jitter per member)."""
    k = gram_zz_plain(z, ell, s2)
    out, failed = _attempt(k, packed)
    jit = torch.zeros(k.shape[0], dtype=k.dtype, device=k.device)
    diag = torch.diagonal(k, dim1=-2, dim2=-1)
    for extra in LADDER:
        if not bool(failed.any()):
            break
        idx = failed.nonzero()[:, 0]
        diag[idx] += extra
        jit[idx] += extra
        sub, sub_failed = _attempt(k[idx], packed[idx])
        for o, s in zip(out, sub):
            o[idx] = s
        failed[idx] = sub_failed
    if bool(failed.any()):
        for o in out:
            o[failed] = float("nan")
    return (*out, jit)


def _forward(z, ell, s2, packed):
    if z.device.type == "cpu":
        return svgp_precompute_plain(z, ell, s2, packed)
    if z.device.type != "cuda":
        raise ValueError(f"svgp_precompute: no path for device {z.device}")
    return svgp_precompute_cuda(z, ell, s2, packed)


def svgp_precompute_bwd(z, ell, s2, l, w, linv, lbar, wbar, linvbar):
    """Pullback of (L, W, L⁻¹) to (z̄, ℓ̄, s̄², P̄): the JAX package's
    ``_bwd``, GEMMs against the exported L⁻¹ and then the gram VJP.  A
    ``None`` cotangent counts as zeros."""
    lbar = torch.zeros_like(l) if lbar is None else lbar
    wbar = torch.zeros_like(w) if wbar is None else wbar
    linv_t = linv.mT
    # W = L⁻ᵀP:  P̄ = L⁻¹W̄;  L̄ += −(L⁻¹ W̄ Wᵀ)ᵀ on L's lower triangle
    pbar = linv @ wbar
    lbar = torch.tril(lbar) - torch.tril((linv @ (wbar @ w.mT)).mT)
    # X = L⁻¹:  L̄ += −Xᵀ X̄ Xᵀ
    if linvbar is not None:
        lbar = lbar - torch.tril(linv_t @ linvbar @ linv_t)
    # the Cholesky pullback from the saved factor
    pmat = l.mT @ lbar
    eye = torch.eye(l.shape[-1], dtype=l.dtype, device=l.device)
    phi = torch.tril(pmat) - 0.5 * pmat * eye
    kbar_t = linv_t @ (linv_t @ phi).mT
    kbar = 0.5 * (kbar_t + kbar_t.mT)
    with torch.enable_grad():
        zz, ee, ss = (a.detach().requires_grad_(True) for a in (z, ell, s2))
        zbar, ellbar, s2bar = torch.autograd.grad(_gram(zz, ee, ss), (zz, ee, ss), kbar)
    return zbar, ellbar, s2bar, pbar


class _SvgpPrecompute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, ell, s2, packed):
        l, w, linv, jit = _forward(z, ell, s2, packed)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(jit)
        ctx.save_for_backward(z, ell, s2, l, w, linv)
        return l, w, linv, jit

    @staticmethod
    def backward(ctx, lbar, wbar, linvbar, _):
        return svgp_precompute_bwd(*ctx.saved_tensors, lbar, wbar, linvbar)


def svgp_precompute_fused(z_all, ell_all, s2_all, packed_all, *, return_jitter: bool = False):
    """(L, W = L⁻ᵀ·packed, L⁻¹) for a (T, M, D) stack of inducing sets with
    lengthscales (T, D), outputscales (T,) and packed right-hand sides
    (T, M, P), in one kernel call on the card.  ``return_jitter`` appends
    the (T,) extra diagonal each member took (0, 1e-4 or 1e-4 + 1e-2)."""
    l, w, linv, jit = _SvgpPrecompute.apply(z_all, ell_all, s2_all, packed_all)
    return (l, w, linv, jit) if return_jitter else (l, w, linv)
