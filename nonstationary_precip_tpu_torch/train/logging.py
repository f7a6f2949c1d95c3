"""Observability: a JSONL metric stream, TensorBoard scalars, parameter tables.

Counterpart of ``nonstationary_precip_tpu/train/logging.py`` (the
reference's stdout prints, TensorBoard scalars and figures and PrettyTable
parameter listings):

  * ``MetricsLogger``: JSONL always, mirrored to TensorBoard when
    ``tensorboardX`` imports;
  * ``param_table``: name / shape / #elements / trainable for every
    parameter of a module, in the JAX table's layout;
  * ``trainable_param_names``: the names of the parameters that train.

Trainability is ``requires_grad``, which the models' ``trainable(...)``
sets, in place of the JAX package's mask pytree.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

from torch import nn


class MetricsLogger:
    """Append-only JSONL metric log with optional TensorBoard mirroring."""

    def __init__(self, logdir, name: str = "run", use_tensorboard: bool = True):
        self.dir = Path(logdir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / f"{name}.jsonl"
        self._fh = open(self.path, "a")
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(logdir=str(self.dir / "tb" / name))

    def scalars(self, step: int, **values):
        """One record {"step", "time", **values}, each value a float."""
        rec = {"step": int(step), "time": time.time()}
        for k, v in values.items():
            rec[k] = float(v)
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, float(v), step)

    def figure(self, step: int, tag: str, fig):
        """Mirror a matplotlib figure to TensorBoard, then close it (without
        TensorBoard it would otherwise pile up in pyplot's manager)."""
        if self._tb is not None:
            self._tb.add_figure(tag, fig, step)
        import matplotlib.pyplot as plt

        plt.close(fig)

    def close(self):
        self._fh.close()
        if self._tb is not None:
            self._tb.close()


def trainable_param_names(model: nn.Module) -> list:
    """Names of the parameters that train (the reference's
    ``get_trainable_param_names``)."""
    return [name for name, p in model.named_parameters() if p.requires_grad]


def param_table(model: nn.Module) -> str:
    """The parameter table of the JAX package's ``param_table``: one row per
    parameter (name, shape, #elements, trainable) and the trainable total."""
    rows = [(name, str(tuple(p.shape)), p.numel(), p.requires_grad) for name, p in model.named_parameters()]
    total = sum(size for _, _, size, tr in rows if tr)
    width = max((len(r[0]) for r in rows), default=10) + 2
    lines = [f"{'Parameter':<{width}}{'shape':<16}{'#':<10}trainable"]
    lines.append("-" * (width + 36))
    for name, shape, size, tr in rows:
        lines.append(f"{name:<{width}}{shape:<16}{size:<10}{tr}")
    lines.append(f"Total trainable params: {total}")
    return "\n".join(lines)
