"""Split-batched training: the K benchmark splits as one stacked model.

Counterpart of ``nonstationary_precip_tpu/train/vmapped.py``.  The K
per-split models are stacked into one module whose parameters carry a
leading split axis, and every loss or evaluation works on the whole stack at
once (the JAX package's ``vmap`` written out).  Adam is elementwise, so the
gradient of the summed loss w.r.t. split k's parameters is exactly split
k's gradient: the batched run follows K sequential runs.  ``fit_restarts``
trains K differently initialised models on the same data the same way and
keeps the best.

``mesh=`` (``parallel.make_mesh``) splits the K splits over the ranks of a
process group: rank r trains and evaluates splits [rK/P, (r+1)K/P) as one
stack of its own, and the results are gathered in split order.  Splits
and Adam are independent, so no gradient crosses ranks.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch import nn

from nonstationary_precip_tpu_torch.train.optim import TrainResult, fit


def _set_parameter(module: nn.Module, name: str, value: nn.Parameter):
    owner, _, leaf = name.rpartition(".")
    setattr(module.get_submodule(owner) if owner else module, leaf, value)


def stack_modules(modules: Sequence[nn.Module]) -> nn.Module:
    """One module whose every parameter is the stack of the K modules'
    (leading split axis).  Trainability must be the same in every module:
    one ``requires_grad`` pattern trains all splits."""
    pattern = [(n, p.requires_grad) for n, p in modules[0].named_parameters()]
    for i, m in enumerate(modules[1:], start=1):
        if [(n, p.requires_grad) for n, p in m.named_parameters()] != pattern:
            raise ValueError(
                f"stack_modules: split {i}'s trainable parameters differ from "
                "split 0's — one requires_grad pattern trains all splits"
            )
    out = copy.deepcopy(modules[0])
    with torch.no_grad():
        for name, requires_grad in pattern:
            stacked = torch.stack([m.get_parameter(name) for m in modules])
            _set_parameter(out, name, nn.Parameter(stacked, requires_grad=requires_grad))
    return out


def _map_parameters(module: nn.Module, fn: Callable) -> nn.Module:
    """A copy of ``module`` with every parameter p replaced by fn(p), its
    ``requires_grad`` kept."""
    out = copy.deepcopy(module)
    with torch.no_grad():
        for name, p in module.named_parameters():
            _set_parameter(out, name, nn.Parameter(fn(p.detach()), requires_grad=p.requires_grad))
    return out


def unstack_module(module: nn.Module, k: int) -> list:
    """Inverse of ``stack_modules``: the K per-split modules."""
    return [_map_parameters(module, lambda p, i=i: p[i].clone()) for i in range(k)]


class Stacked:
    """Marks a ``fit_splits``/``eval_splits`` argument as already stacked on
    the leading split axis (e.g. the frozen prior's ``gram_pre`` computed
    for all splits at once)."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


def _stack_tree(items: Sequence[Any]):
    """Stack per-split tensors, or per-split tuples of tensors leaf-wise."""
    if isinstance(items[0], tuple):
        return tuple(_stack_tree(parts) for parts in zip(*items))
    return torch.stack(list(items))


def _stack_args(args_per_split):
    return tuple(seq.value if isinstance(seq, Stacked) else _stack_tree(seq) for seq in args_per_split)


def rank_splits(k: int, mesh, who: str = "") -> slice:
    """The splits [rK/P, (r+1)K/P) this rank of ``mesh`` owns; K % P ≠ 0
    raises."""
    if k % mesh.size:
        raise ValueError(f"{who}{k} splits do not divide over a {mesh.size}-device mesh")
    per = k // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def _slice_tree(tree, sl: slice):
    if isinstance(tree, tuple):
        return tuple(_slice_tree(t, sl) for t in tree)
    return tree[sl]


def _rank_args(args_per_split, sl: slice) -> tuple:
    """Each per-split sequence cut to the rank's splits; a ``Stacked`` one
    cut along its leading split axis."""
    return tuple(Stacked(_slice_tree(a.value, sl)) if isinstance(a, Stacked) else list(a)[sl]
                 for a in args_per_split)


def gather_splits(tree, mesh):
    """Each rank's split-stacked tensors (or tuples of them), concatenated
    in rank order along the split axis; every rank gets the whole."""
    from nonstationary_precip_tpu_torch.parallel.collectives import all_gather

    if isinstance(tree, tuple):
        return tuple(gather_splits(t, mesh) for t in tree)
    return all_gather(tree.detach().contiguous(), mesh)


def gather_module(module: nn.Module, mesh) -> nn.Module:
    """The stacked module whose every parameter is the ranks' stacks
    concatenated in rank order (the K splits from the K/P of each rank)."""
    return _map_parameters(module, lambda p: gather_splits(p, mesh))


def gather_trace(losses: np.ndarray, mesh) -> np.ndarray:
    """The ranks' (T, K/P) loss traces side by side, (T, K) in split order.
    A rank whose run stopped sooner (the NaN guard) is padded with NaN."""
    from nonstationary_precip_tpu_torch.parallel.collectives import all_gather_object

    parts = all_gather_object(np.asarray(losses), mesh)
    t = max(len(p) for p in parts)
    return np.concatenate([np.pad(p.astype(float), ((0, t - len(p)), (0, 0)), constant_values=np.nan)
                           for p in parts], axis=1)


def fit_splits(
    models: Sequence[nn.Module],
    loss_fn: Callable,
    *args_per_split,
    lr: float = 0.01,
    num_steps: int = 1000,
    chunk: int = 0,
    batched_loss: Callable = None,
    mesh=None,
) -> TrainResult:
    """Train K models on K datasets simultaneously.

    ``loss_fn(stacked_model, *stacked_args) -> (K,)`` is the per-split loss
    over the split axis; ``args_per_split`` are sequences of per-split
    tensors (or tuples of tensors), stacked here unless wrapped in
    ``Stacked``.  ``batched_loss`` (same signature) overrides ``loss_fn`` with
    a hand-batched form, e.g. ``models.gibbs_gp.gibbs_map_loss_batched``.
    Returns a TrainResult whose model is the stacked module and whose losses
    are (steps, K).

    ``mesh``: split parallelism over its ranks (K % P == 0).  Every rank
    holds all K models and arguments, trains its K/P as one stack (under
    ``batched_loss`` too, where JAX refuses: here each rank's stack is its
    own call, e.g. one K1 launch a step for the Gibbs slice) and returns
    all K, gathered; ``seconds`` is this rank's."""
    if mesh is not None:
        sl = rank_splits(len(models), mesh)
        res = fit_splits(list(models)[sl], loss_fn, *_rank_args(args_per_split, sl), lr=lr, num_steps=num_steps,
                         chunk=chunk, batched_loss=batched_loss)
        losses = gather_trace(res.losses, mesh)
        return res._replace(model=gather_module(res.model, mesh), losses=losses, steps=len(losses))
    stacked = stack_modules(models)
    stacked_args = _stack_args(args_per_split)
    per_split = batched_loss if batched_loss is not None else loss_fn

    def scalar_loss(m, *sa):
        per = per_split(m, *sa)
        return torch.sum(per), per

    return fit(stacked, scalar_loss, *stacked_args, lr=lr, num_steps=num_steps, has_aux=True, chunk=chunk)


def fit_restarts(models: Sequence[nn.Module], loss_fn: Callable, *args, lr: float = 0.01,
                 num_steps: int = 1000) -> tuple:
    """Multi-restart training (the reference's SGPR advertises
    ``n_restarts`` and never implements it): K differently initialised
    models optimise the same data at once as one stacked model.
    ``loss_fn(stacked_model, *args) -> (K,)`` is each restart's loss, the
    args shared by all (they broadcast against the stack's leading axis).
    Returns (the best restart's module, its final loss, every restart's
    final loss (K,)), the final losses taken at the trained pose."""
    stacked = stack_modules(models)
    res = fit(stacked, lambda m, *a: torch.sum(loss_fn(m, *a)), *args, lr=lr, num_steps=num_steps)
    with torch.no_grad():
        finals = loss_fn(res.model, *args).detach()
    best = int(np.argmin(finals.cpu().numpy()))
    return unstack_module(res.model, len(models))[best], float(finals[best]), finals


def eval_splits(models_stacked: nn.Module, eval_fn: Callable, *args_per_split, mesh=None):
    """Evaluate K trained splits at once, without gradients.

    ``eval_fn(stacked_model, *stacked_args)`` returns metric tensors with the
    split axis first; per-split args stack as in ``fit_splits``.  ``mesh``:
    each rank evaluates its K/P splits and every rank gets all K, in split
    order (K % P == 0)."""
    if mesh is not None:
        k = next(models_stacked.parameters()).shape[0]
        sl = rank_splits(k, mesh)
        local = eval_splits(_map_parameters(models_stacked, lambda p: p[sl]), eval_fn,
                            *_rank_args(args_per_split, sl))
        return gather_splits(local, mesh)
    stacked_args = _stack_args(args_per_split)
    with torch.no_grad():
        return eval_fn(models_stacked, *stacked_args)
