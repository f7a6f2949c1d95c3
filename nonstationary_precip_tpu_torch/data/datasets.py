"""Bundled Upper-Indus-Basin dataset loaders (no pandas).

Counterpart of ``nonstationary_precip_tpu/data/datasets.py``'s
``load_uib_spatial``, ``load_khyber_time_series``,
``load_uib_spatio_temporal`` and ``spatio_temporal_month_split``, which
read the CSVs
with pandas.  pandas' default C parser does not round
every decimal string to the nearest double (on uib_spatial.csv 2 of 1182
values land one ulp from ``float()``/``np.loadtxt``), so the values here go
through a transcription of that parser: the port trains on bit-identical
data, and runs where pandas is absent.
"""

from __future__ import annotations

import numpy as np

from nonstationary_precip_tpu_torch.utils.config import DATASET_DIR

_UIB_SPATIAL_COLUMNS = ("lon", "lat", "tp")
_UIB_ST_COLUMNS = ("", "time", "lon", "lat", "tp")
_POW10 = [float(f"1e{i}") for i in range(309)]
_MAX_DIGITS = 17


def _parse_float(s: str) -> float:
    """A decimal string as pandas' default C parser reads it
    (``precise_xstrtod``): at most 17 significant digits are accumulated as
    ``number * 10 + digit`` in double precision, then scaled once by a
    power of ten."""
    s = s.strip()
    p, n = 0, len(s)
    negative = p < n and s[p] == "-"
    if p < n and s[p] in "+-":
        p += 1
    number, exponent, num_digits = 0.0, 0, 0
    while p < n and s[p].isdigit():
        if num_digits < _MAX_DIGITS:
            number = number * 10.0 + (ord(s[p]) - 48)
            num_digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and s[p] == ".":
        p += 1
        while p < n and s[p].isdigit():
            if num_digits < _MAX_DIGITS:
                number = number * 10.0 + (ord(s[p]) - 48)
                num_digits += 1
                exponent -= 1
            p += 1
    if num_digits == 0:
        raise ValueError(f"not a number: {s!r}")
    if negative:
        number = -number
    if p < n and s[p] in "eE":
        p += 1
        sign = -1 if p < n and s[p] == "-" else 1
        if p < n and s[p] in "+-":
            p += 1
        start = p
        while p < n and s[p].isdigit():
            p += 1
        if p == start:
            raise ValueError(f"not a number: {s!r}")
        exponent += sign * int(s[start:p])
    if p != n:
        raise ValueError(f"not a number: {s!r}")
    if exponent > 308:
        raise ValueError(f"out of range: {s!r}")
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308] if exponent >= -616 else 0.0
    return number / _POW10[-exponent]


def read_columns(name: str, columns: tuple) -> np.ndarray:
    """``data/<name>`` as float64 (rows, columns), each value read as pandas'
    default parser reads it; the header must be ``columns``."""
    path = DATASET_DIR / name
    with open(path) as fh:
        header = tuple(fh.readline().strip().split(","))
        if header != columns:
            raise ValueError(f"{path}: expected columns {columns}, found {header}")
        rows = [[_parse_float(v) for v in line.split(",")] for line in fh if line.strip()]
    arr = np.asarray(rows, dtype=np.float64)
    if arr.ndim != 2 or arr.shape[1] != len(header):
        raise ValueError(f"{path}: ragged rows")
    return arr


def load_uib_spatial():
    """(columns, x[394,2](lon,lat), y[394]) from ``data/uib_spatial.csv``.

    The first element is the column names where the JAX loader returns its
    DataFrame; x and y are the same float64 arrays, bit for bit."""
    arr = read_columns("uib_spatial.csv", _UIB_SPATIAL_COLUMNS)
    return _UIB_SPATIAL_COLUMNS, arr[:, 0:2], arr[:, -1]


def load_khyber_time_series():
    """(time[342], tp[342]) from ``data/khyber_time_series.csv``, monthly
    1979-2007 at one Khyber point: the JAX loader's arrays, bit for bit."""
    arr = read_columns("khyber_time_series.csv", ("time", "tp"))
    return arr[:, 0], arr[:, 1]


def load_uib_spatio_temporal():
    """(columns, x[5676,3](time,lon,lat), y[5676]) from
    ``data/uib_spatio_temporal.csv`` (43 sites × 132 months, 2000-2010):
    the JAX loader's x and y, bit for bit, where it returns its DataFrame
    first."""
    arr = read_columns("uib_spatio_temporal.csv", _UIB_ST_COLUMNS)
    return _UIB_ST_COLUMNS, arr[:, 1:4], arr[:, -1]


def spatio_temporal_month_split():
    """Year-2000 months 1-4 train / month 5 test, standardised: the JAX
    ``spatio_temporal_month_split`` (the reference's ``load_train_test``) in
    numpy, with the same row order, filters and arithmetic.  pandas'
    ``rank(method="dense")`` of the times is ``np.unique``'s inverse + 1.
    Yields 172 training rows and 43 test rows.

    Returns (x_train, y_train, x_test, y_test, meany, stdy, x_norm, y_raw)."""
    _, x_all, y_all = load_uib_spatio_temporal()
    keep = x_all[:, 0] < 2001
    x, y = x_all[keep], y_all[keep]
    month = np.unique(x[:, 0], return_inverse=True)[1] + 1
    keep = month < 6
    # column-major, as pandas hands the JAX loader its array: the column
    # means and deviations then sum in the same (pairwise) order
    x, y, month = np.asfortranarray(x[keep]), y[keep], month[keep]

    meanx, stdx = x.mean(axis=0), x.std(axis=0, ddof=1)
    x_norm = (x - meanx) / stdx
    meany, stdy = float(y.mean()), float(y.std(ddof=1))
    y_norm = (y - meany) / stdy

    split = int((month < 5).sum())
    return x_norm[:split], y_norm[:split], x_norm[split:], y_norm[split:], meany, stdy, x_norm, y
