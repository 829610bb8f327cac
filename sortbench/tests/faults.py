"""Faults planted under the timed path, as ``run_cell`` hooks: each must
make ``correct`` come out false.  Every rank of a mesh run applies them."""
from __future__ import annotations

from unittest import mock


def _alter(out):
    """A copy of an answer with its first entry overwritten by its last."""
    out = out.clone() if hasattr(out, "clone") else out.copy()
    out[0] = out[-1]
    return out


def unchanged(cell):
    """The step hands back what it was given: keys unsorted, or the
    identity order."""
    import torch

    import repro_torch
    from repro_torch import engine

    driver, op = cell.config["driver"], cell.traffic.get("op", "sort")
    if driver == "ranks":
        return [mock.patch.object(repro_torch, "sort", lambda x, **kw: (
            x.clone(), torch.ones_like(x, dtype=torch.bool)))]
    if op == "argsort":
        return [mock.patch.object(engine, "argsort", lambda x, **kw: torch.arange(
            x.shape[-1], dtype=torch.int32, device=x.device))]
    return [mock.patch.object(repro_torch, "sort", lambda x, **kw: x.clone())]


def altered(cell):
    """One answer altered where it is produced: its first entry."""
    import repro_torch
    from repro_torch import engine

    driver, op = cell.config["driver"], cell.traffic.get("op", "sort")
    if driver == "ranks":
        real = repro_torch.sort

        def sort(x, **kw):
            slab, valid = real(x, **kw)
            return _alter(slab), valid
        return [mock.patch.object(repro_torch, "sort", sort)]
    owner, name = (engine, "argsort") if op == "argsort" else (repro_torch, "sort")
    real = getattr(owner, name)
    return [mock.patch.object(owner, name, lambda x, **kw: _alter(real(x, **kw)))]


def no_exchange(cell):
    """The exchange between cards left out: each rank sorts its own shard."""
    import torch

    def local(x, mesh, *args, **kw):
        out = torch.sort(x).values
        return out, torch.ones_like(out, dtype=torch.bool)
    return [mock.patch("repro_torch.engine.planner.cluster_sort", local)]
