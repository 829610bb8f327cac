"""Plain NumPy reference of the decode top-k.

It imports nothing of the program: it takes the logits the benchmark
handed the program and works the answer out again on the host.  The
control is the same reference without the configuration's tie rule, and
has to come out as not correct.
"""
from __future__ import annotations

import numpy as np

__all__ = ["answer", "control", "mismatches"]


def answer(keys: np.ndarray, k: int, largest: bool = True):
    """The exact top-``k`` of each row of ``keys`` (rows, vocab): the
    ``k`` largest logits, largest first (``largest=False``: the smallest,
    smallest first), ties to the lowest index (the stable order), as
    (values, int32 indices)."""
    idx = np.argsort(-keys if largest else keys, kind="stable", axis=-1)[:, :k]
    return np.take_along_axis(keys, idx, axis=-1), idx.astype(np.int32)


def control(keys: np.ndarray, k: int, largest: bool = True):
    """The top-``k`` one step below the configuration's stability
    guarantee: ties to the highest index."""
    rev = keys[:, ::-1]
    idx = keys.shape[-1] - 1 - np.argsort(-rev if largest else rev, kind="stable",
                                          axis=-1)[:, :k]
    return np.take_along_axis(keys, idx, axis=-1), idx.astype(np.int32)


def mismatches(got: np.ndarray, want: np.ndarray) -> int:
    """Entries at which ``got`` differs from ``want`` bit for bit (a shape
    or dtype that differs counts every entry of the larger)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return max(got.size, want.size)
    bits = np.dtype(f"u{got.itemsize}")
    return int(np.count_nonzero(np.ascontiguousarray(got).view(bits)
                                != np.ascontiguousarray(want).view(bits)))
