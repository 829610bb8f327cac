"""Warmup: build the whole executable ladder before traffic arrives.

Counterpart of ``repro/engine/frontend/warmup.py``.  A lazily-warming
serving process pays the first use of every (kind, length bucket, batch
bucket, dtype, direction) cell on its first request: in the port, the
kernel library's load (and its nvcc build, when the build directory is
cold) and the first allocations at that shape.  A production front end
warms its whole bucket ladder ahead of time instead: ``warmup(service,
plan_table)``
enumerates every (size bucket, dtype) cell the plan cache names
(``Planner.warmup_cells`` — tuned plans *and* learned-capacity cells, i.e.
everywhere real traffic has ever landed), crosses it with the request kinds
and the pow2 batch-bucket ladder the service pads into, and builds each
cell through the exact executable-identity path serving uses
(``SortService.warm_cell`` -> ``_signature``).  After warmup, a request for
any warmed cell is a pure cache hit: the cache's ``misses`` stay put.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from ..cache import size_bucket
from ..planner import Planner, dtype_name as _dtype_name
from ..service import SortService

__all__ = ["WarmupReport", "batch_bucket_ladder", "warmup"]


def batch_bucket_ladder(max_batch: int) -> Tuple[int, ...]:
    """The pow2 batch buckets serving can pad a coalesced batch into.

    A scheduler flushing up to ``max_batch`` requests produces batches of
    every size in ``1..max_batch``; the service pads each to its pow2 batch
    bucket, so these — and only these — batch shapes can ever be built.

    >>> batch_bucket_ladder(8)
    (1, 2, 4, 8)
    >>> batch_bucket_ladder(6)
    (1, 2, 4, 8)
    """
    ladder = []
    bb = 1
    while bb < max_batch:
        ladder.append(bb)
        bb *= 2
    ladder.append(bb)
    return tuple(ladder)


@dataclass
class WarmupReport:
    """What one ``warmup`` call built (and skipped as already warm).

    ``cells`` lists every executable cell visited as
    ``(kind, bucket, dtype, batch_bucket, ascending)``; ``compiled`` counts
    the fresh executables this call built, ``cached`` the cells that were
    already warm (a second warmup is a fast no-op), ``elapsed_s`` the wall
    time the compiles took — the latency the *first requests* would have
    paid without warmup.

    >>> WarmupReport(cells=[], compiled=0, cached=0, elapsed_s=0.0).compiled
    0
    """

    cells: list = field(default_factory=list)
    compiled: int = 0
    cached: int = 0
    elapsed_s: float = 0.0

    def summary(self) -> str:
        """One printable line for a serving script's ``--warmup`` output."""
        return (
            f"warmup: {len(self.cells)} cells, {self.compiled} compiled, "
            f"{self.cached} already warm, {self.elapsed_s * 1e3:.0f} ms"
        )


def warmup(
    service: Optional[SortService] = None,
    plan_table: Optional[Planner] = None,
    *,
    cells: Optional[Iterable[Tuple[int, object]]] = None,
    kinds: Sequence[str] = ("sort", "argsort"),
    max_batch: int = 16,
    ascending: Sequence[bool] = (True,),
    values_spec: Optional[Tuple[tuple, object]] = None,
    mesh=None,
    device="cuda",
) -> WarmupReport:
    """Build every executable cell the plan table names.

    Parameters
    ----------
    service:    the ``SortService`` whose cache to warm (a fresh one on
                ``device`` by default — but warming a fresh private service
                is rarely what you want: pass the service your scheduler
                serves on).
    plan_table: the ``Planner`` whose plan-cache keys enumerate the (bucket,
                dtype) cells; defaults to ``service.planner``.  Cells come
                from ``Planner.warmup_cells(mesh)`` — every key the tuned
                ``plans`` table or the ``learned`` capacity section holds for
                this hardware fingerprint (the service's device).
    cells:      explicit extra ``(size, dtype)`` cells to warm in addition to
                (or, with an empty plan table, instead of) the enumerated
                ones — sizes are bucketed with ``size_bucket`` first, so any
                expected request length works.
    kinds:      request kinds to compile per cell.  ``sort_kv`` requires
                ``values_spec=(trailing value shape, value dtype)``.
    max_batch:  top of the pow2 batch-bucket ladder — use the scheduler's
                ``max_batch`` so every flushable batch shape is covered.
    ascending:  sort directions to compile (descending argsort is the
                serving top-k shape: ``ascending=(False,)``).
    mesh:       hardware fingerprint to enumerate plan cells for (None =
                this process's local fingerprint, the serving case).
    device:     the device of a fresh service.

    >>> svc = SortService(planner=Planner(), device="cpu")   # hermetic plan table
    >>> rep = warmup(svc, cells=[(1000, "int32")], kinds=("sort",),
    ...              max_batch=2)
    >>> (rep.compiled, rep.cached)            # (1024,)x{1,2}: two cells
    (2, 0)
    >>> warmup(svc, cells=[(1000, "int32")], kinds=("sort",),
    ...        max_batch=2).compiled          # idempotent: already warm
    0
    """
    service = service if service is not None else SortService(device=device)
    planner = plan_table if plan_table is not None else service.planner
    targets = list(planner.warmup_cells(mesh, device=service.device))
    if cells is not None:
        for n, dtype in cells:
            targets.append(
                (size_bucket(int(n), min_bucket=service.min_bucket),
                 _dtype_name(dtype))
            )
    # dedupe while keeping deterministic order
    targets = sorted(set(targets))

    report = WarmupReport()
    t0 = time.perf_counter()
    for bucket, dtype_name in targets:
        for kind in kinds:
            for asc in ascending:
                for bb in batch_bucket_ladder(max_batch):
                    fresh = service.warm_cell(
                        kind,
                        bucket,
                        dtype_name,
                        batch_bucket=bb,
                        ascending=asc,
                        values_spec=values_spec if kind == "sort_kv" else None,
                    )
                    report.cells.append((kind, bucket, dtype_name, bb, asc))
                    report.compiled += int(fresh)
                    report.cached += int(not fresh)
    report.elapsed_s = time.perf_counter() - t0
    return report
