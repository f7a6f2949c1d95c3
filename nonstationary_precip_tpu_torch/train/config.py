"""Experiment config: one dataclass and its argparse bridge.

Counterpart of ``nonstationary_precip_tpu/train/config.py``: the same
``--name value`` CLI bridge, the fields the ported experiments read, and one
field more, ``device``.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass


@dataclass
class ExperimentConfig:
    """The fields the ported experiments and ``serve`` read; a later slice
    adds the fields of the experiments it ports (the JAX config's path,
    test and resume fields are not here yet)."""

    log_interval: int = 50

    model: str = "DiagonalGibbs"
    inference: str = "exact"  # 'exact' or 'sparse' (spatial_gibbs)
    train_percent: float = 80.0
    lr: float = 1e-2
    max_iters: int = 1000
    num_inducing: int = 250
    num_splits: int = 10
    seed: int = 173

    # Gibbs prior hypers (reference defaults, spatial_exp.py:76-80)
    prior_scale: float = 1.0
    prior_ell: float = 1.3
    prior_mean: float = 0.3
    noise: float = 0.011  # 0 → optimise noise
    scale: float = 0.644  # 0 → optimise outputscale

    # DSVI
    num_epochs: int = 400
    num_samples: int = 3
    num_layers: int = 2
    batch_size: int = 315

    # the torch device: 'cuda' (the card; raises where there is none) or 'cpu'
    device: str = "cuda"

    def parse_args(self, argv=None) -> "ExperimentConfig":
        """Override any field via --name value CLI flags."""
        parser = argparse.ArgumentParser()
        for f in dataclasses.fields(self):
            default = getattr(self, f.name)
            ftype = type(default) if default is not None else str
            if ftype is bool:
                parser.add_argument(f"--{f.name}", type=lambda s: s.lower() in ("1", "true", "yes"), default=default)
            else:
                parser.add_argument(f"--{f.name}", type=ftype, default=default)
        ns = parser.parse_args(argv)
        return dataclasses.replace(self, **vars(ns))
