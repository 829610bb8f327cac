"""Named meshes over the ranks of ``torch.distributed``.

Counterpart of ``repro/launch/mesh.py``.  The reference lays devices out
with ``jax.make_mesh``; here a ``Mesh`` lays out the ranks of the default
process group, one process a rank, row-major (the last axis varies
fastest, as ``jax.make_mesh`` orders devices).  Each rank knows its
coordinate on every axis, and every set of axes has an ``AxisGroup``: the
ranks that share this rank's coordinates on the other axes.  Collectives
the reference names by axis (``psum(x, "model")``) go to
``mesh.group("model")``; ``mesh.world`` is the whole mesh.

Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2, data=16,
model=16) = 512 ranks; the ``pod`` axis carries only the gradient
reduction of data parallelism.  Nothing here runs at import: building a
mesh creates process groups, so it is a function call.

``init_distributed`` brings the default group up for a driver: from
``torchrun``'s environment when it is there, else as one rank alone, on
the backend the caller names.  ``local_device`` gives a rank its card:
``LOCAL_RANK`` (or the rank) modulo the cards the host has, so ranks
sharing a card (gloo) all use it.
"""
from __future__ import annotations

import itertools
import math
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.exchange.group import AxisGroup

__all__ = [
    "MULTI_POD",
    "SINGLE_POD",
    "Mesh",
    "init_distributed",
    "local_device",
    "make_debug_mesh",
    "make_production_mesh",
]

SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)


class Mesh:
    """Named axes over every rank of the default group (which must be up).

    ``shape`` maps axis name to size in the axes' order (``jax.Mesh.shape``),
    ``coords`` this rank's coordinate on each axis.  Raises ``ValueError``
    when the axes' sizes do not multiply to the world size.

    >>> dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    >>> m = Mesh((1, 1), ("data", "model"))
    >>> m.shape, m.coords, m.group("model").size
    ({'data': 1, 'model': 1}, {'data': 0, 'model': 0}, 1)
    >>> dist.destroy_process_group()
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("a Mesh lays out the ranks of the default process group: "
                               "initialise it first (launch.mesh.init_distributed)")
        names, sizes = tuple(axis_names), tuple(int(s) for s in shape)
        if len(names) != len(sizes) or len(set(names)) != len(names):
            raise ValueError(f"mesh axes {names} do not match the shape {sizes}")
        need, world = math.prod(sizes), dist.get_world_size()
        if need != world:
            raise ValueError(f"mesh {dict(zip(names, sizes))} needs a world of {need} ranks, "
                             f"the default group has {world}")
        self.axis_names: Tuple[str, ...] = names
        self.shape = dict(zip(names, sizes))
        self.size = need
        self.rank = dist.get_rank()
        self._stride = {a: math.prod(sizes[i + 1:]) for i, a in enumerate(names)}
        self.coords = {a: (self.rank // self._stride[a]) % self.shape[a] for a in names}
        # every rank creates every group, in one order: new_group is collective
        self._groups = {}
        for r in range(1, len(names) + 1):
            for subset in itertools.combinations(names, r):
                self._groups[subset] = self._new_group(subset)
        self.world: AxisGroup = self._groups[names]

    def _rank_of(self, coords: dict) -> int:
        return sum(coords[a] * self._stride[a] for a in self.axis_names)

    def _new_group(self, subset: tuple) -> AxisGroup:
        if len(subset) == len(self.axis_names):
            return AxisGroup()
        others = [a for a in self.axis_names if a not in subset]
        mine = None
        for fixed in itertools.product(*(range(self.shape[a]) for a in others)):
            ranks = [self._rank_of({**dict(zip(others, fixed)), **dict(zip(subset, c))})
                     for c in itertools.product(*(range(self.shape[a]) for a in subset))]
            g = dist.new_group(ranks)
            if self.rank in ranks:
                mine = g
        return AxisGroup(mine)

    def group(self, axes) -> Optional[AxisGroup]:
        """The ``AxisGroup`` over ``axes`` (a name or names; their order does
        not matter: a group's ranks run row-major in the mesh's axis
        order).  ``None`` for no axes."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} are not in the mesh {self.axis_names}")
        key = tuple(a for a in self.axis_names if a in axes)
        return self._groups[key] if key else None


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(data=16, model=16), or (pod=2, data=16, model=16) with
    ``multi_pod``; raises with the world size it needs when the default
    group has another."""
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_debug_mesh(shape=(1, 1), axes=("data", "model")) -> Mesh:
    """A small mesh for tests and examples; raises with the world size it
    needs when the default group has another."""
    return Mesh(shape, axes)


def init_distributed(backend: str, device: torch.device) -> None:
    """Bring up the default process group unless it is up: from
    ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) when it is set, else as one rank alone.  ``backend``
    is taken as given: ``nccl`` needs CUDA and at most one rank a card on
    this host, and raises otherwise; nothing falls back to ``gloo``."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: want nccl or gloo")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, not {device}")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the default group runs {dist.get_backend()}, not {backend}")
    elif "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
        cards = torch.cuda.device_count()
        if local > cards:
            raise ValueError(f"nccl takes one rank a card: {local} ranks on this host, "
                             f"{cards} cards; run with --dist-backend gloo to share cards")


def local_device(device: torch.device) -> torch.device:
    """This rank's device: on CUDA, card ``LOCAL_RANK % device_count`` (the
    rank when ``LOCAL_RANK`` is unset); anything else unchanged."""
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())
