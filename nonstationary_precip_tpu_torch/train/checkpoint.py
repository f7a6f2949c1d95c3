"""Checkpointing: save *and* restore, with ``torch.save``.

Counterpart of ``nonstationary_precip_tpu/train/checkpoint.py``, where Orbax
saves pytrees: here a model (or an optimizer) is saved as its
``state_dict`` with ``torch.save`` and read back with ``torch.load(...,
weights_only=True)`` into a module built the same way, and
``BestCheckpointer`` keeps the JAX package's rolling layout (``best/``,
``best_rmse/``, ``best_nlpd/``, ``final/``, each with ``model``, an optional
``opt_state`` and ``meta.json``).  A JAX (Orbax) checkpoint is not read
here: ``interop`` carries JAX parameters into the port.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch


def _state(obj: Any):
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


def save_pytree(path, obj: Any):
    """Save ``obj``'s ``state_dict`` (a module's or an optimizer's; a plain
    dict of tensors as it is) to the file ``path``, creating its parent."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(_state(obj), path)


def restore_pytree(path, like: Any) -> Any:
    """Load what ``save_pytree`` wrote into ``like`` (a module or an
    optimizer built as the saved one was; strict) and return it; with a
    plain dict for ``like``, return the loaded dict.  Tensors land on the
    device of ``like``'s first parameter."""
    params = list(like.parameters()) if isinstance(like, torch.nn.Module) else []
    dev = params[0].device if params else "cpu"
    state = torch.load(Path(path), map_location=dev, weights_only=True)
    if hasattr(like, "load_state_dict"):
        like.load_state_dict(state)
        return like
    return state


class BestCheckpointer:
    """Rolling best-objective / best-RMSE / best-NLPD checkpoints (the
    reference's best.tar / best_rmse.tar / best_nlpd.tar)."""

    def __init__(self, logdir):
        self.dir = Path(logdir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.best = {"objective": np.inf, "rmse": np.inf, "nlpd": np.inf}

    def update(self, step: int, model, opt_state=None, **metrics) -> list:
        """Save under each metric that improved; returns which did."""
        improved = []
        for key in self.best:
            if key in metrics and float(metrics[key]) < self.best[key]:
                self.best[key] = float(metrics[key])
                tag = "best" if key == "objective" else f"best_{key}"
                save_pytree(self.dir / tag / "model", model)
                if opt_state is not None:
                    save_pytree(self.dir / tag / "opt_state", opt_state)
                (self.dir / tag / "meta.json").write_text(
                    json.dumps({"step": step, **{k: float(v) for k, v in metrics.items()}}))
                improved.append(key)
        return improved

    def save_final(self, step: int, model, opt_state=None):
        save_pytree(self.dir / "final" / "model", model)
        if opt_state is not None:
            save_pytree(self.dir / "final" / "opt_state", opt_state)
        (self.dir / "final" / "meta.json").write_text(json.dumps({"step": step}))
