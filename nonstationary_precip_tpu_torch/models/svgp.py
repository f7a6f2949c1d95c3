"""Whitened sparse variational GP layer (SVGP).

Counterpart of ``nonstationary_precip_tpu/models/svgp.py``: a whitened
variational strategy with learned inducing locations, a Scale(RBF-ARD)
kernel and a constant or (shared) linear mean.  With u = L_zz⁻¹(f(z) − μ(z))
and q(u) = N(m, SSᵀ), the marginals at x are

    mean(x) = μ(x) + A m,          A = K_xz L_zz⁻ᵀ
    var(x)  = k(x,x) − rowsum(A²) + rowsum((A S)²)

and KL(q(u) ‖ N(0, I)) = ½ (‖m‖² + ‖S‖_F² − M − 2 Σ log |diag S|).

The output dims sit on a leading axis of each parameter (the JAX package's
``vmap`` written out), and any axes in front of that (the split axis of a
stacked model) pass through every method.  An input x may carry further
axes between those and its (N, Din) (the DSVI sample axis).  ``sample``
takes the caller's ε; the full-covariance ``joint``/``sample_joint`` are
not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nonstationary_precip_tpu_torch.ops.svgp_precompute import svgp_precompute_fused
from nonstationary_precip_tpu_torch.utils.config import EPSILON
from nonstationary_precip_tpu_torch.utils.transforms import positive

_MEAN_CONSTANT = "constant"
_MEAN_LINEAR = "linear"


def _insert_axes(t: torch.Tensor, after: int, count: int) -> torch.Tensor:
    """``t`` with ``count`` singleton axes inserted after its first ``after``."""
    if count == 0:
        return t
    return t.reshape(t.shape[:after] + (1,) * count + t.shape[after:])


class SVGPLayer(nn.Module):
    """One whitened SVGP layer with O output dims (O = 1 for the scalar head).

    Shapes, behind any batch axes:
      z          (O, M, Din)   learned inducing locations
      var_mean   (O, M)        whitened variational mean
      var_chol   (O, M, M)     whitened variational root (lower triangle used)
      raw_outputscale (O,)     Scale kernel
      raw_lengthscale (O, Din) RBF-ARD
      mean_b (O,), and mean_w (Din, O) for the linear mean
    """

    def __init__(self, z, var_mean, var_chol, raw_outputscale, raw_lengthscale, mean_b,
                 mean_w: Optional[torch.Tensor] = None, mean_type: str = _MEAN_CONSTANT):
        super().__init__()
        self.z = nn.Parameter(z)
        self.var_mean = nn.Parameter(var_mean)
        self.var_chol = nn.Parameter(var_chol)
        self.raw_outputscale = nn.Parameter(raw_outputscale)
        self.raw_lengthscale = nn.Parameter(raw_lengthscale)
        self.mean_b = nn.Parameter(mean_b)
        self.mean_w = nn.Parameter(mean_w) if mean_w is not None else None
        self.mean_type = mean_type

    @classmethod
    def create(cls, generator: torch.Generator, input_dims: int, output_dims: int, num_inducing: int = 250,
               mean_type: str = _MEAN_CONSTANT, dtype=torch.float32, device=None):
        """The reference's init: z ~ N(0, 1) from ``generator`` (a CPU
        generator), the whitened q(u) at the prior (m = 0, S = I, so KL = 0),
        raw kernel hypers 0 (softplus(0)) and zero mean weights."""
        o, m = output_dims, num_inducing
        z = torch.randn((o, m, input_dims), generator=generator, dtype=dtype).to(device)

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        eye = torch.eye(m, dtype=dtype, device=device).expand(o, m, m).clone()
        mean_w = zeros(input_dims, o) if mean_type == _MEAN_LINEAR else None
        return cls(z, zeros(o, m), eye, zeros(o), zeros(o, input_dims), zeros(o), mean_w, mean_type)

    # -- internals -----------------------------------------------------------

    @property
    def _nb(self) -> int:
        """Number of batch axes in front of the output axis."""
        return self.z.ndim - 3

    def _mean(self, x):
        """Prior mean (..., O, N).  The linear mean is shared across outputs,
        as GPyTorch's LinearMean(input_dims) without batch shape."""
        extra = x.ndim - 2 - self._nb
        if self.mean_type == _MEAN_LINEAR:
            w = _insert_axes(self.mean_w, self._nb, extra)
            b = _insert_axes(self.mean_b, self._nb, extra)
            return (x @ w + b[..., None, :]).mT
        b = _insert_axes(self.mean_b, self._nb, extra)
        return torch.broadcast_to(b[..., None], x.shape[:-2] + (b.shape[-1], x.shape[-2]))

    def gram_zz(self):
        """K_zz + εI per output, (..., O, M, M)."""
        zs = self.z / positive(self.raw_lengthscale)[..., None, :]
        z_sq = torch.sum(zs * zs, dim=-1)
        quad = torch.clamp(z_sq[..., :, None] + z_sq[..., None, :] - 2.0 * (zs @ zs.mT), min=0.0)
        k = positive(self.raw_outputscale)[..., None, None] * torch.exp(-0.5 * quad)
        eye = torch.eye(self.z.shape[-2], dtype=k.dtype, device=k.device)
        return k + EPSILON * eye

    def packed_variational(self):
        """[m | tril(S) | I] per output, (..., O, M, 2M+1).  The lower
        triangle is a mask multiply, so var_chol's upper part gets exactly
        zero gradient."""
        m = self.var_mean.shape[-1]
        eye = torch.eye(m, dtype=self.var_mean.dtype, device=self.var_mean.device)
        tril_mask = torch.tril(torch.ones_like(eye))
        return torch.cat([self.var_mean[..., None], self.var_chol * tril_mask,
                          eye.expand_as(self.var_chol)], dim=-1)

    def precompute(self):
        """Sample-independent factors per output: (chol(K_zz + εI), L⁻ᵀ,
        W = L⁻ᵀ[m | tril(S) | I]); see ``precompute_layers``."""
        return precompute_layers([self])[0]

    def marginals(self, x: torch.Tensor, pre=None):
        """Posterior marginals at x (..., N, Din) → (mean, var), each
        (..., O, N); the variance is clipped at 1e-10."""
        if pre is None:
            pre = self.precompute()
        nb, extra = self._nb, x.ndim - 2 - self._nb
        ell = _insert_axes(positive(self.raw_lengthscale), nb, extra)[..., :, None, :]  # (.., O, 1, Din)
        s2 = _insert_axes(positive(self.raw_outputscale), nb, extra)  # (.., O)
        w = _insert_axes(pre[2], nb, extra)
        m = self.var_mean.shape[-1]
        xs = x[..., None, :, :] / ell
        zs = _insert_axes(self.z, nb, extra) / ell
        x_sq = torch.sum(xs * xs, dim=-1)
        z_sq = torch.sum(zs * zs, dim=-1)
        k_xz = s2[..., None, None] * torch.exp(
            -0.5 * torch.clamp(x_sq[..., :, None] + z_sq[..., None, :] - 2.0 * (xs @ zs.mT), min=0.0))
        out = k_xz @ w  # (.., O, N, 2M+1): [A·m | A·S | A] in one product
        mean = out[..., 0]
        a_s = out[..., 1:m + 1]
        a = out[..., m + 1:]
        var = s2[..., None] - torch.sum(a * a, dim=-1) + torch.sum(a_s * a_s, dim=-1)
        return mean + self._mean(x), torch.clamp(var, min=1e-10)

    def kl(self) -> torch.Tensor:
        """Σ_o KL(q(u_o) ‖ N(0, I)), one per batch entry.  The triangle and
        the diagonal are mask reductions, as in the JAX package."""
        mdim = self.var_mean.shape[-1]
        eye = torch.eye(mdim, dtype=self.var_chol.dtype, device=self.var_chol.device)
        s = self.var_chol * torch.tril(torch.ones_like(eye))
        diag = torch.sum(self.var_chol * eye, dim=-1)  # (.., O, M)
        m = self.var_mean
        per_o = 0.5 * (torch.sum(m * m, dim=-1) + torch.sum(s * s, dim=(-2, -1)) - mdim
                       - 2.0 * torch.sum(torch.log(torch.abs(diag) + 1e-20), dim=-1))
        return torch.sum(per_o, dim=-1)

    def sample(self, x: torch.Tensor, eps: torch.Tensor, pre=None) -> torch.Tensor:
        """One marginal sample per ε at x: mean + √var·ε with ε (..., O, N),
        returned as (..., N, O), the next layer's input (DSVI propagation)."""
        mean, var = self.marginals(x, pre)
        return (mean + torch.sqrt(var) * eps).mT

    def joint(self, x, pre=None):
        raise NotImplementedError("SVGPLayer.joint (full_cov) is not yet ported")

    def sample_joint(self, x, eps, pre=None):
        raise NotImplementedError("SVGPLayer.sample_joint (full_cov) is not yet ported")


def precompute_inputs(layers):
    """K4's inputs for several layers that share M: (z, ℓ, s², P) of all
    layers' outputs side by side, batch axes in front (the split axis)
    folded into one (T, ...) stack, feature dims padded to the widest with
    ghost dims z = 0, ℓ = 1 (they add nothing to the RBF gram)."""
    m = layers[0].var_mean.shape[-1]
    if any(l.var_mean.shape[-1] != m for l in layers):
        raise ValueError("precompute_layers: the layers must share the inducing count M")
    d_max = max(l.z.shape[-1] for l in layers)

    def pad_d(arr, fill):
        pad = d_max - arr.shape[-1]
        return arr if pad == 0 else torch.nn.functional.pad(arr, (0, pad), value=fill)

    z_all = torch.cat([pad_d(l.z, 0.0) for l in layers], dim=-3)
    ell_all = torch.cat([pad_d(positive(l.raw_lengthscale), 1.0) for l in layers], dim=-2)
    s2_all = torch.cat([positive(l.raw_outputscale) for l in layers], dim=-1)
    packed_all = torch.cat([l.packed_variational() for l in layers], dim=-3)
    return (z_all.reshape(-1, m, d_max), ell_all.reshape(-1, d_max), s2_all.reshape(-1),
            packed_all.reshape(-1, m, packed_all.shape[-1]))


def precompute_layers(layers):
    """The precompute of several layers that share M, in one K4 call over the
    concatenated (..., ΣO, M, M) stack, split back per layer into
    (L, L⁻ᵀ, W).  Batch axes in front (the split axis) fold into the stack,
    so a stacked model's whole step takes one call."""
    lead = layers[0].var_mean.shape[:-2]
    l_all, w_all, linv_all = svgp_precompute_fused(*precompute_inputs(layers))
    l_all, w_all, linv_all = (a.reshape(*lead, -1, *a.shape[-2:]) for a in (l_all, w_all, linv_all))
    linv_t_all = linv_all.mT
    out, off = [], 0
    for layer in layers:
        o = layer.var_mean.shape[-2]
        out.append((l_all[..., off:off + o, :, :], linv_t_all[..., off:off + o, :, :],
                    w_all[..., off:off + o, :, :]))
        off += o
    return out
