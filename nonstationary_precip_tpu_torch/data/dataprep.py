"""Data preparation: CSV ingestion, host-side transforms and split harnesses.

Counterpart of ``nonstationary_precip_tpu/data/dataprep.py``.  Everything
runs on the host in float64 numpy; split membership is bit-identical to the
JAX package's (same generators, same rounding of the train count).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from nonstationary_precip_tpu_torch.data.datasets import _parse_float


def load_csv(filepath) -> np.ndarray:
    """CSV with one header row → float64 (rows, columns), each value read as
    pandas' default parser reads it (``datasets._parse_float``), an empty
    cell as NaN; the JAX package's ``load_csv`` without pandas."""
    with open(filepath) as fh:
        width = len(fh.readline().split(","))
        rows = [[_parse_float(v) if v.strip() else float("nan") for v in line.rstrip("\r\n").split(",")]
                for line in fh if line.strip()]
    arr = np.asarray(rows, dtype=np.float64)
    if arr.ndim != 2 or arr.shape[1] != width:
        raise ValueError(f"{filepath}: ragged rows")
    return arr


def prep_inputs(data: np.ndarray) -> np.ndarray:
    """Standardise all-but-last columns (ddof = 1)."""
    x = data[:, :-1]
    return (x - x.mean(axis=0)) / x.std(axis=0, ddof=1)


class BoxCox(NamedTuple):
    x: np.ndarray
    y: np.ndarray
    lmbda: float


def box_cox_transform(data: np.ndarray) -> BoxCox:
    """Standardised inputs and Box-Cox-transformed outputs, with the fitted
    lambda (scipy's MLE, as the JAX package)."""
    import scipy.stats

    y_tr, lmbda = scipy.stats.boxcox(data[:, -1])
    return BoxCox(x=prep_inputs(data), y=y_tr, lmbda=float(lmbda))


class Whitened(NamedTuple):
    x: np.ndarray
    y: np.ndarray
    meanx: np.ndarray
    stdx: np.ndarray
    meany: float
    stdy: float


def whitening_transform(data: np.ndarray) -> Whitened:
    """Zero-mean, unit-std (ddof = 1) inputs and outputs."""
    x = data[:, :-1]
    y = data[:, -1]
    meanx = x.mean(axis=0)
    stdx = x.std(axis=0, ddof=1)
    meany = float(y.mean())
    stdy = float(y.std(ddof=1))
    return Whitened((x - meanx) / stdx, (y - meany) / stdy, meanx, stdx, meany, stdy)


def train_test_split(x: np.ndarray, y: np.ndarray, train_prop: float):
    """Contiguous head/tail split: the first floor(train_prop · N) rows train."""
    n_train = int(math.floor(train_prop * len(x)))
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]


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


def sklearn_style_shuffle(data: np.ndarray, random_state: int) -> np.ndarray:
    """Row shuffle of sklearn.utils.shuffle(data, random_state): a
    ``np.random.RandomState(random_state)`` shuffles the row indices."""
    rs = np.random.RandomState(random_state)
    idx = np.arange(len(data))
    rs.shuffle(idx)
    return data[idx]
