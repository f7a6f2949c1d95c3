"""Experiment config: one dataclass and its argparse bridge.

Counterpart of ``nonstationary_precip_tpu/train/config.py``: the same
fields, the same ``--name value`` CLI bridge and ``dump``, and one field
more, ``device``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional


@dataclass
class ExperimentConfig:
    """Every experiment's defaults; each declares its own by instantiating
    this class, and ``parse_args`` overrides any field from the CLI."""

    # paths / logging
    data: str = "data/"
    root: str = "."
    logdir: str = "experiments/logs"
    name: Optional[str] = None
    log_interval: int = 50
    test_interval: int = 100
    plot_interval: int = 0  # 0 disables plots

    model: str = "DiagonalGibbs"
    inference: str = "exact"  # 'exact' or 'sparse' (spatial_gibbs)
    train_percent: float = 80.0
    lr: float = 1e-2
    max_iters: int = 1000
    threshold: float = 1e-6
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

    test_type: str = "random"  # 'random' | 'censored'
    resume: str = ""  # checkpoint dir (e.g. <logdir>/<name>/best) to restore from

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

    def dump(self, path: Path):
        """Write the resolved config as JSON (the reference's log.txt arg
        dump, precipitation_baselines.py:238-245), creating its parent."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(dataclasses.asdict(self), indent=2))
