"""The collectives ``shard_map`` gives JAX, with JAX's transposes.

Each is a ``torch.autograd.Function`` over one axis of a :class:`Mesh`
(its subgroup).  Their backward passes are the transposes JAX's AD uses
for a loss that every rank computes alike (a replicated cotangent):

* ``psum``: every rank's partial feeds the same sum, so each partial's
  cotangent is the sum's, passed through unchanged;
* ``pmean``: likewise, divided by the axis size;
* ``all_gather`` (tiled along rows): the rank's rows of the gathered
  array are its own input, so it gets back its own slice;
* ``pvary`` (JAX's transpose of a replicated input used in rank-varying
  work, ``dp.py:56-61``): identity forward, the gradient summed over the
  ranks once, in one all-reduce for all the tensors it marks.

``torch.distributed.nn.functional.all_reduce`` is not used: its backward
all-reduces the cotangent too, which for a replicated loss multiplies the
gradient by the axis size.

A CUDA tensor in a gloo group raises: gloo would stage it through the
host.  Every collective runs on the mesh's own device, CPU under gloo and
the card under NCCL.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from nonstationary_precip_tpu_torch.parallel.mesh import Mesh


def _axis(mesh: Mesh, axis: Optional[str]):
    axis = axis or mesh.axis[0]
    return mesh.groups[axis], mesh.coords[axis], mesh.shape[axis]


def _check(x: torch.Tensor, group):
    if x.device.type == "cuda" and dist.get_backend(group) != "nccl":
        raise ValueError("collectives: CUDA tensors take an NCCL group (gloo would stage them through the host)")


def axis_index(mesh: Mesh, axis: Optional[str] = None) -> int:
    """This rank's index along ``axis`` (JAX's ``lax.axis_index``)."""
    return _axis(mesh, axis)[1]


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, size):
        _check(x, group)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        ctx.rows, ctx.index = x.shape[0], index
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index * ctx.rows:(ctx.index + 1) * ctx.rows], None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scale):
        _check(x, group)
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        ctx.scale = scale
        return y if scale == 1.0 else y * scale

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.scale == 1.0 else g * ctx.scale), None, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        for x in xs:
            _check(x, group)
        ctx.group = group
        ctx.shapes = [x.shape for x in xs]
        ctx.like = xs[0] if xs else None
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([(torch.zeros(s, dtype=ctx.like.dtype, device=ctx.like.device) if g is None else g)
                          .reshape(-1) for g, s in zip(gs, ctx.shapes)])
        dist.all_reduce(flat, group=ctx.group)
        out, i = [], 0
        for s in ctx.shapes:
            n = s.numel()
            out.append(flat[i:i + n].reshape(s))
            i += n
        return (None, *out)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: Optional[str] = None) -> torch.Tensor:
    """The ranks' x concatenated along rows, in rank order (JAX's tiled
    ``all_gather(x, axis, axis=0, tiled=True)``).  Backward: the rank's own
    slice of the cotangent."""
    group, index, size = _axis(mesh, axis)
    return _AllGather.apply(x, group, index, size)


def psum(x: torch.Tensor, mesh: Mesh, axis: Optional[str] = None) -> torch.Tensor:
    """Σ over the ranks of ``axis`` (JAX's ``lax.psum``).  Backward: the
    cotangent itself."""
    group, _, _ = _axis(mesh, axis)
    return _Psum.apply(x, group, 1.0)


def pmean(x: torch.Tensor, mesh: Mesh, axis: Optional[str] = None) -> torch.Tensor:
    """The mean over the ranks of ``axis`` (JAX's ``lax.pmean``).  Backward:
    the cotangent over the axis size."""
    group, _, size = _axis(mesh, axis)
    return _Psum.apply(x, group, 1.0 / size)


def pvary(xs: Sequence[torch.Tensor], mesh: Mesh, axis: Optional[str] = None) -> tuple:
    """The replicated tensors ``xs`` marked for rank-varying work: identity
    forward; backward, each gradient summed over the ranks of ``axis`` in
    one all-reduce.  A replicated parameter that feeds each rank's share of
    a loss thus gets the whole gradient, once."""
    group, _, _ = _axis(mesh, axis)
    return _Pvary.apply(group, *xs) if xs else ()


class _Call(nn.Module):
    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def call_varying(fn: Callable, model: nn.Module, mesh: Mesh, *args, axis: Optional[str] = None):
    """``fn(model, *args)`` with every trainable parameter of ``model``
    entering through :func:`pvary`: the rank-varying use of a replicated
    model, as JAX's ``shard_map`` with the model in ``P()`` types it.  What
    ``fn`` returns is this rank's share; its gradient w.r.t. the parameters
    comes back summed over the ranks."""
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    marked = pvary([model.get_parameter(n) for n in names], mesh, axis)
    return torch.func.functional_call(_Call(model, fn), {f"model.{n}": v for n, v in zip(names, marked)}, args,
                                      strict=False)


def all_gather_object(obj, mesh: Mesh, axis: Optional[str] = None) -> list:
    """Every rank's picklable ``obj``, in rank order (host side, no autograd)."""
    group, _, size = _axis(mesh, axis)
    out = [None] * size
    dist.all_gather_object(out, obj, group=group)
    return out
