"""Split-batched training: the K benchmark splits as one stacked model.

Counterpart of ``nonstationary_precip_tpu/train/vmapped.py``.  The K
per-split models are stacked into one module whose parameters carry a
leading split axis, and every loss or evaluation works on the whole stack at
once (the JAX package's ``vmap`` written out).  Adam is elementwise, so the
gradient of the summed loss w.r.t. split k's parameters is exactly split
k's gradient: the batched run follows K sequential runs.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Sequence

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


def unstack_module(module: nn.Module, k: int) -> list:
    """Inverse of ``stack_modules``: the K per-split modules."""
    names = [(n, p.requires_grad) for n, p in module.named_parameters()]
    out = []
    with torch.no_grad():
        for i in range(k):
            m = copy.deepcopy(module)
            for name, requires_grad in names:
                value = module.get_parameter(name)[i].clone()
                _set_parameter(m, name, nn.Parameter(value, requires_grad=requires_grad))
            out.append(m)
    return out


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


def fit_splits(
    models: Sequence[nn.Module],
    loss_fn: Callable,
    *args_per_split,
    lr: float = 0.01,
    num_steps: int = 1000,
    chunk: int = 0,
    batched_loss: Callable = None,
) -> TrainResult:
    """Train K models on K datasets simultaneously.

    ``loss_fn(stacked_model, *stacked_args) -> (K,)`` is the per-split loss
    over the split axis; ``args_per_split`` are sequences of per-split
    tensors (or tuples of tensors), stacked here unless wrapped in
    ``Stacked``.  ``batched_loss`` (same signature) overrides ``loss_fn`` with
    a hand-batched form, e.g. ``models.gibbs_gp.gibbs_map_loss_batched``.
    Returns a TrainResult whose model is the stacked module and whose losses
    are (steps, K)."""
    stacked = stack_modules(models)
    stacked_args = _stack_args(args_per_split)
    per_split = batched_loss if batched_loss is not None else loss_fn

    def scalar_loss(m, *sa):
        per = per_split(m, *sa)
        return torch.sum(per), per

    return fit(stacked, scalar_loss, *stacked_args, lr=lr, num_steps=num_steps, has_aux=True, chunk=chunk)


def eval_splits(models_stacked: nn.Module, eval_fn: Callable, *args_per_split):
    """Evaluate K trained splits at once, without gradients.

    ``eval_fn(stacked_model, *stacked_args)`` returns metric tensors with the
    split axis first; per-split args stack as in ``fit_splits``."""
    stacked_args = _stack_args(args_per_split)
    with torch.no_grad():
        return eval_fn(models_stacked, *stacked_args)
