"""Plain NumPy reference of every answer the sort cells check.

It imports nothing of the program: it takes the keys the benchmark handed
the program and works each answer out again on the host.  The controls
are the same reference put in the program's place in a lower precision or
without a guarantee, and have to come out as not correct.
"""
from __future__ import annotations

import numpy as np

__all__ = ["answer", "control", "mismatches"]


def answer(op: str, keys: np.ndarray) -> np.ndarray:
    """The exact answer of ``op`` on one 1-D array of keys: ``sort`` gives
    the keys in ascending order, ``argsort`` the stable ascending order's
    indices."""
    if op == "sort":
        return np.sort(keys, kind="stable")
    if op == "argsort":
        return np.argsort(keys, kind="stable")
    raise ValueError(f"no reference for op {op!r}")


def _bfloat16_round(keys: np.ndarray) -> np.ndarray:
    """The keys rounded to bfloat16 (8 significant bits, nearest even),
    returned in their own dtype."""
    f = keys.astype(np.float32)
    bits = f.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32).astype(keys.dtype)


def control(op: str, keys: np.ndarray) -> np.ndarray:
    """The reference one step below what the configuration states:
    ``sort`` computed on bfloat16 keys (the step below float32, and
    8 significant bits for int32 keys), ``argsort`` without its stability
    guarantee."""
    if op == "sort":
        return np.sort(_bfloat16_round(keys))
    if op == "argsort":
        return np.argsort(keys, kind="quicksort")
    raise ValueError(f"no control for op {op!r}")


def mismatches(got: np.ndarray, want: np.ndarray) -> int:
    """Positions at which ``got`` differs from ``want``, with every
    position one of them lacks counted as differing."""
    n = min(len(got), len(want))
    return int(np.count_nonzero(got[:n] != want[:n])) + abs(len(got) - len(want))
