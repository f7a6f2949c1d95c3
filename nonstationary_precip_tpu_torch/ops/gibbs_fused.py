"""K8: the fused Gibbs MAP-loss solve (L, α = L⁻¹y) of s²K_gibbs + σ²I, by
hand for Hopper.

Replaces ``nonstationary_precip_tpu/ops/pallas_fused.py::gibbs_chol_solve_fused``
(:276, ``pallas_call`` at :232, body ``_fused_kernel``), which the JAX
package's ``gibbs_noisy_chol_alpha`` (:332) dispatches from
``GibbsExactGP.loss`` inside its gate.  The kernel is ``csrc/gibbs_fused.cu``:
CUDA C++ for sm_90a, built with nvcc at first use (``ops/cuda_build.py``)
and bound through ctypes.

What bounds it on an H100.  The factorisation's N³/3 operations (3.6·10⁸
at N = 1024, 5 µs at 67 TFLOP/s of f32 outside the tensor cores) and the
Gram's ~10·D per element; the bytes are the (N, D) inputs, y, and L and α
written once (4 MB at N = 1024).  Operations bound it on paper; the
dependent chain of diagonal tiles and single-wave updates sets its time, as
in K10a.

What the design does about it.  One C call, three attempts on the stream.
Each attempt builds the lower 128-blocks of s²K + (σ² + extra)I from
``csrc/gibbs_elem.cuh``'s element (K9's) straight into the output L, the
diagonal written exactly as s² + (σ² + extra) (``pallas_fused.py:126-130``)
and the padded rows the identity, so nothing couples to them; factors L in
place on ``csrc/chol_rl.cuh``'s right-looking tiles, K10a's schedule
(``factor<false>``: per block column the diagonal tile, the panel and the
trailing update, 3·N_pad/128 − 2 launches), with α riding it as the TPU
kernel's α does: each diagonal tile forward-substitutes α_j against L_jj
(a substitution, never a product with L_jj⁻¹, which broke the
backward-error bound in K10a's panel), and each panel subtracts X·α_j from
its own rows of α; then commits the attempt if no diagonal tile failed and
α is finite.  A non-finite entry anywhere in L reaches a later diagonal
tile through the panels and updates, so the tiles' flag stands in for a
sweep over L (``tests/test_torch_gibbs_fused_rl.py``).  The extra jitter
is 0, then 1e-4, then 1e-2, the TPU kernel's ladder
(``pallas_fused.py:184-199``), not ``safe_cholesky``'s: the second and third
attempts always go on the stream and each of their kernels returns at once
when the first has succeeded, so there is no host round trip and the happy
path pays 2·(3·N_pad/128) empty launches (3·N_pad/128 CUDA launches an
attempt: 72 a call at N = 1024, 90 at 1280).  L lives in device memory (on
the TPU it never left VMEM); at 1280² it is 6.5 MB and stays in the 50 MB
L2.

The backward is not a kernel: the JAX ``_bwd`` (:294-326) in torch, three
triangular solves by ``torch.linalg.solve_triangular`` and the Gram's
vector-Jacobian product through ``gibbs_gram_reference`` (the JAX package
computes it outside any Pallas kernel too).

Dispatch: ``gibbs_noisy_chol_alpha`` takes the kernel for a pair that
``eligible`` accepts (on the card only, as the JAX gate is closed on the
CPU) and the composed path, ``gibbs_gram`` → ``safe_cholesky`` →
``tri_solve``, with ``safe_cholesky``'s own ladder, everywhere else.
``LAUNCHES`` counts calls of the kernel's wrapper, one per call however
many CUDA launches it makes.
"""

from __future__ import annotations

import ctypes

import torch

from nonstationary_precip_tpu_torch.kernels.gibbs import gibbs_gram, gibbs_gram_reference
from nonstationary_precip_tpu_torch.ops.chol_blocked import blocked_cholesky_plain
from nonstationary_precip_tpu_torch.ops.chol_stream import rl_attributes
from nonstationary_precip_tpu_torch.ops.cuda_build import CSRC, build_library
from nonstationary_precip_tpu_torch.ops.linalg import safe_cholesky, tri_solve

BLOCK = 128  # factorisation block (csrc/chol_rl.cuh kT)
#: K8's factorisation kernels (``csrc/chol_rl.cuh`` with K8's hooks, no
#: look-ahead), in the order of its ``attributes()``.
KERNELS = ("diag_kernel", "panel_kernel", "syrk_kernel<triangle>")
MAX_D = 8  # pallas_fused.py's _MAX_D
#: The JAX dispatch window (``pallas_fused.py::eligible``).
MIN_N = 768
MAX_N = 1280
#: The extra jitter of each attempt (``pallas_fused.py:184-199``).
EXTRA_JITTER = (0.0, 1e-4, 1e-2)

#: Calls of the kernel's wrapper so far in this process; a run reads it to
#: show that its main path went through the kernel.
LAUNCHES = 0

SOURCE = CSRC / "gibbs_fused.cu"

_lib = None


def build(force: bool = False) -> str:
    """Compile ``csrc/gibbs_fused.cu``, load it, and return nvcc's output.
    Reused unless ``force``; a failed compile raises."""
    global _lib
    lib, log = build_library(SOURCE, force)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gibbs_fused.argtypes = [p, p, i, i, p, p, p, p, p, p, i, p]
    lib.gibbs_fused.restype = i
    lib.gibbs_fused_attributes.argtypes = [p]
    lib.gibbs_fused_attributes.restype = i
    _lib = lib
    return log


def kernel_attributes() -> dict:
    """``chol_stream.rl_attributes`` of K8's factorisation kernels (built
    first if need be)."""
    if _lib is None:
        build()
    return rl_attributes(_lib.gibbs_fused_attributes, KERNELS)


def eligible(x: torch.Tensor, ell: torch.Tensor) -> bool:
    """The JAX package's gate (``pallas_fused.py:54-88``) without its
    environment switch, the backend test read as "on the card": float32 x,
    x and ℓ 2-D, D ≤ 8, 768 ≤ N ≤ 1280."""
    return (x.device.type == "cuda" and x.dtype == torch.float32 and x.ndim == 2 and ell.ndim == 2
            and x.shape[-1] <= MAX_D and MIN_N <= x.shape[0] <= MAX_N)


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device).detach().reshape(1).contiguous()


def gibbs_chol_solve_cuda(x, ell, y, s2, noise):
    """The kernel's wrapper: (L, α, state) for x, ℓ (N, D ≤ 8), y (N,) and
    the scalars s², σ² (tensors or floats), float32 on one CUDA device, from
    one C call on the current stream.  ``state`` is a device int32 pair
    whose first entry is 1 + the attempt that succeeded, 0 if none did
    (read it only when needed: reading syncs).  Raises on anything the
    kernel does not take; no autograd."""
    global LAUNCHES
    if x.ndim != 2 or ell.shape != x.shape or y.shape != (x.shape[0],):
        raise ValueError(f"gibbs_fused kernel: shapes {tuple(x.shape)}, {tuple(ell.shape)}, {tuple(y.shape)}")
    if any(t.device.type != "cuda" or t.device != x.device for t in (x, ell, y)):
        raise ValueError("gibbs_fused kernel takes CUDA tensors on one device")
    if any(t.dtype != torch.float32 for t in (x, ell, y)):
        raise TypeError("gibbs_fused kernel takes float32")
    if not 1 <= x.shape[1] <= MAX_D:
        raise ValueError(f"gibbs_fused kernel takes D ≤ {MAX_D}, got {x.shape[1]}")
    if _lib is None:
        build()
    (n, d), dev = x.shape, x.device
    n_pad = -(-n // BLOCK) * BLOCK
    x, ell, y = (t.detach().contiguous() for t in (x, ell, y))
    s2, noise = _scalar(s2, x), _scalar(noise, x)
    l = torch.zeros((n_pad, n_pad), dtype=torch.float32, device=dev)
    alpha = torch.empty(n_pad, dtype=torch.float32, device=dev)
    state = torch.zeros(2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib.gibbs_fused(x.data_ptr(), ell.data_ptr(), n, d, y.data_ptr(), s2.data_ptr(), noise.data_ptr(),
                               l.data_ptr(), alpha.data_ptr(), state.data_ptr(), n_pad, stream)
    if err != 0:
        raise RuntimeError(f"gibbs_fused kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return l[:n, :n], alpha[:n], state


def gibbs_chol_solve_plain(x, ell, y, s2, noise):
    """The plain PyTorch version, with the kernel's ladder: (L, α, tries)
    from gibbs_gram_reference → +(σ² + extra)I → Cholesky → solve, extra =
    0, 1e-4, 1e-2 in turn until L and α are finite; ``tries`` is 1 + the
    attempt that succeeded, 0 if none did (then L and α are the last
    attempt's, non-finite).  Reads the outcome on the host."""
    k = s2 * gibbs_gram_reference(x, ell, x, ell)
    eye = torch.eye(x.shape[0], dtype=k.dtype, device=k.device)
    for attempt, extra in enumerate(EXTRA_JITTER):
        l = blocked_cholesky_plain(k + (noise + extra) * eye)
        alpha = torch.linalg.solve_triangular(l, y[:, None], upper=False)[:, 0]
        if bool(torch.isfinite(l).all() & torch.isfinite(alpha).all()):
            return l, alpha, attempt + 1
    return l, alpha, 0


class _GibbsCholSolve(torch.autograd.Function):
    """(L, α) forward; the JAX ``_bwd``'s closed-form pullback from the
    saved outputs, with no refactorisation."""

    @staticmethod
    def forward(ctx, x, ell, y, s2, noise):
        if x.device.type == "cpu":
            l, alpha, _ = gibbs_chol_solve_plain(x, ell, y, s2, noise)
        elif x.device.type == "cuda":
            l, alpha, _ = gibbs_chol_solve_cuda(x, ell, y, s2, noise)
        else:
            raise ValueError(f"gibbs_fused: no path for device {x.device}")
        ctx.save_for_backward(x, ell, s2, noise, l, alpha)
        return l, alpha

    @staticmethod
    def backward(ctx, lbar, abar):
        x, ell, s2, noise, l, alpha = ctx.saved_tensors
        lt = l.mT
        # pullback of α = L⁻¹y: ȳ = L⁻ᵀᾱ, L̄ −= tril(ȳαᵀ)
        ybar = torch.linalg.solve_triangular(lt, abar[:, None], upper=True)[:, 0]
        lbar = lbar - torch.tril(torch.outer(ybar, alpha))
        # pullback of L = chol(K): K̄ = sym(L⁻ᵀ Φ(LᵀL̄) L⁻¹), Φ = tril, halved diagonal
        p = lt @ lbar
        phi = torch.tril(p) - 0.5 * torch.diag_embed(torch.diagonal(p))
        w = torch.linalg.solve_triangular(lt, phi, upper=True)
        kbar_t = torch.linalg.solve_triangular(lt, w.mT, upper=True)
        kbar = 0.5 * (kbar_t + kbar_t.mT)
        # K = s²·G(x, ℓ) + σ²I: the Gram's VJP through the plain Gram
        need_x, need_ell, need_y, need_s2, need_noise = ctx.needs_input_grad
        with torch.enable_grad():
            xx = x.detach().requires_grad_(need_x)
            ee = ell.detach().requires_grad_(need_ell)
            gram = gibbs_gram_reference(xx, ee, xx, ee)
            wanted = [t for t in (xx, ee) if t.requires_grad]
            grads = iter(torch.autograd.grad(gram, wanted, s2 * kbar) if wanted else ())
        xbar = next(grads) if need_x else None
        ellbar = next(grads) if need_ell else None
        s2bar = torch.sum(kbar * gram.detach()).reshape(s2.shape) if need_s2 else None
        noisebar = torch.trace(kbar).reshape(noise.shape) if need_noise else None
        return xbar, ellbar, ybar if need_y else None, s2bar, noisebar


def gibbs_chol_solve_fused(x, ell, y, s2, noise):
    """(L, α) with L = chol(s²K_gibbs(x, ℓ) + σ²I) and α = L⁻¹y through the
    kernel on the card (the plain version on the CPU), differentiable.
    s² and σ² are tensors."""
    return _GibbsCholSolve.apply(x, ell, y, s2, noise)


def gibbs_noisy_chol_alpha(x, ell, y, s2, noise):
    """(L, α = L⁻¹y) for s²K_gibbs(x, ℓ) + σ²I, the dispatcher of
    ``GibbsExactGP.loss``: K8 with its own ladder where ``eligible`` admits
    the pair, else the composed ``gibbs_gram`` → ``safe_cholesky`` →
    ``tri_solve`` with ``safe_cholesky``'s (``pallas_fused.py:351-358``)."""
    if eligible(x, ell):
        return gibbs_chol_solve_fused(x, ell, y, s2, noise)
    k = s2 * gibbs_gram(x, ell, x, ell) + noise * torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    chol = safe_cholesky(k)
    return chol, tri_solve(chol, y)


def fused_ops(n: int, d: int) -> float:
    """Operations of one call that succeeds at its first attempt: the Gram's
    lower half, ~10·D each element (the bound in ``chip_smoke.py``), the
    factorisation's N³/3 and the substitution's N²."""
    return 10 * d * n * (n + 1) / 2 + n**3 / 3 + n * n
