"""Nested reference results (dicts of dicts of arrays and numbers) to and
from one ``.npz``: each leaf under its path of keys joined by "/", so keys
may hold dots (``jax_leaves``' names do) but not slashes."""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np

SEP = "/"
#: the key under which a fixture keeps the digest of the inputs it was made from
DIGEST = "inputs_digest"


def digest(leaves) -> str:
    """SHA-256 of a sequence of input leaves: arrays by dtype, shape and
    bytes, numbers, strings and None by ``repr``, any other object by its
    type's name (a function or a module's identity is not data)."""
    h = hashlib.sha256()
    for leaf in leaves:
        if leaf is None or isinstance(leaf, (bool, int, float, str)):
            h.update(repr(leaf).encode())
            continue
        try:
            a = np.asarray(leaf)
        except Exception:
            a = None
        if a is None or a.dtype == object:
            h.update(type(leaf).__name__.encode())
        else:
            h.update(f"{a.dtype}{a.shape}".encode())
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            key = str(k)
            assert SEP not in key, key
            out.update(flatten(v, f"{prefix}{SEP}{key}" if prefix else key))
        return out
    return {prefix: np.asarray(tree)}


def unflatten(flat) -> dict:
    out = {}
    for path in flat:
        *heads, last = path.split(SEP)
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = np.asarray(flat[path])
    return out


def save(path: Path, tree: dict):
    np.savez_compressed(path, **flatten(tree))


def load(path: Path) -> dict:
    with np.load(path) as f:
        return unflatten({k: f[k] for k in f.files})


def load_checked(path: Path, inputs_digest: str) -> dict:
    """``load``, after checking that the fixture was made from inputs with
    this digest (else the inputs changed since pinning)."""
    ref = load(path)
    pinned = str(ref.pop(DIGEST, "none"))
    assert pinned == inputs_digest, (f"{path.name} was pinned from other inputs ({pinned[:12]} != "
                                     f"{inputs_digest[:12]}): rerun tools/pin_jax_parallel.py")
    return ref
