"""The seeded split harness.

Counterpart of ``nonstationary_precip_tpu/data/dataprep.py::shuffle_split``;
split membership is bit-identical to it (same generator, same ceil rule).
"""

from __future__ import annotations

import math

import numpy as np


def shuffle_split(x: np.ndarray, y: np.ndarray, train_prop: float, seed: int):
    """Shuffled random split, the 10-seed harness of the reference's
    benchmarks: ``np.random.default_rng(seed)`` shuffles the row indices and
    the first ceil(train_prop · N) rows train."""
    rng = np.random.default_rng(seed)
    n_train = int(math.ceil(train_prop * len(x)))
    idx = np.arange(len(x))
    rng.shuffle(idx)
    tr, te = idx[:n_train], idx[n_train:]
    return x[tr], y[tr], x[te], y[te]
