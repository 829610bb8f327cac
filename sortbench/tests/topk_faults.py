"""Faults planted in the decode top-k's front door, as ``run_cell`` hooks:
each must make ``correct`` come out false."""
from __future__ import annotations

from unittest import mock


def shifted_row(cell):
    """Row 0's indices rolled by one place; the values left right."""
    import torch

    from repro_torch import engine

    real = engine.topk

    def topk(x, k, **kw):
        vals, idx = real(x, k, **kw)
        idx = idx.clone()
        idx[0] = torch.roll(idx[0], 1)
        return vals, idx
    return [mock.patch.object(engine, "topk", topk)]


def stale_values(cell):
    """The values of the call before, from another slot of the pool; the
    indices right."""
    from repro_torch import engine

    real = engine.topk
    last = []

    def topk(x, k, **kw):
        vals, idx = real(x, k, **kw)
        last.append(vals)
        return last.pop(0) if len(last) > 1 else vals, idx
    return [mock.patch.object(engine, "topk", topk)]
