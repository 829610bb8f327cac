"""Batched sort front door: ragged requests in, one batched sort per bucket.

Counterpart of ``repro/engine/service.py``.  ``SortService.submit`` accepts
a ragged batch of 1-D numpy requests, groups them by (length bucket,
dtype), pads each group to a (pow2 batch, pow2 length) block in numpy,
copies the block to the service's device once, runs the cell's callable
from the ``CompiledCache`` (the batch's rows are rows of the kernels'
grid), and copies the result back once.  Results are numpy, as in the
reference.

The group/pad/execute core lives in ``_run_group`` so the sync ``submit``
path, the async micro-batching queue (``repro_torch.engine.queue``) and the
SLO frontend share one implementation.

Plans come from the ``Planner``: the per-bucket local sort recipe is the
tuned shared-memory plan for that (bucket, dtype, device) cell (a serving
front door is a single-device component; cluster plans apply to the mesh
path in kv.py).  A kernel plan (``local_impl='kernel'``) runs kernels A, B
and C for kind ``sort`` and their kv twins for ``argsort`` / ``sort_kv``.

The service runs on ``device`` (the card by default; a CUDA device with no
card raises at construction).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.carry import check_device, tensor_from_reference, tensor_to_reference
from repro_torch.core.shared_sort import shared_memory_sort

from .cache import CompiledCache, TensorSpec, size_bucket
from .kv import _gather_last, _order_keys
from .planner import Planner, SortPlan, default_planner, dtype_name

__all__ = ["SortService", "ServiceStats"]

_KINDS = ("sort", "argsort", "sort_kv")


@dataclass
class ServiceStats:
    """Rolling counters for one ``SortService`` (requests, padding, cells).

    ``elapsed_s`` is *busy* wall time: the union of the per-batch execution
    spans, overlaps between concurrent submitters merged.  ``compiles``
    counts cells served for the first time (cache misses).
    ``overflow_retries`` / ``recompiles`` / ``peak_mean_ratio`` mirror what
    the service's planner saw on the exchange path; ``recompiles`` stays 0
    in the port, which compiles nothing per capacity.

    >>> ServiceStats(keys_in=100, elapsed_s=2.0).throughput_keys_per_s()
    50.0
    """

    requests: int = 0
    batches: int = 0
    keys_in: int = 0
    padded_keys: int = 0
    elapsed_s: float = 0.0
    compiles: int = 0
    cache_hits: int = 0
    overflow_retries: int = 0
    recompiles: int = 0
    peak_mean_ratio: float = 0.0
    _busy_until: float = field(default=0.0, repr=False, compare=False)

    def throughput_keys_per_s(self) -> float:
        return self.keys_in / self.elapsed_s if self.elapsed_s else 0.0

    def account_span(self, t0: float, t1: float) -> None:
        """Merge one batch's [t0, t1] execution span into the busy time.

        >>> s = ServiceStats()
        >>> s.account_span(0.0, 1.0); s.account_span(0.5, 1.5)  # overlap
        >>> s.elapsed_s
        1.5
        """
        self.elapsed_s += max(0.0, t1 - max(t0, self._busy_until))
        self._busy_until = max(self._busy_until, t1)


def _np_sentinel(dtype: np.dtype, *, largest: bool):
    if np.issubdtype(dtype, np.floating):
        return np.inf if largest else -np.inf
    info = np.iinfo(dtype)
    return info.max if largest else info.min


class SortService:
    """Shape-bucketed, plan-driven batch sorter with cell accounting.

    >>> svc = SortService(device="cpu")
    >>> [out] = svc.submit([np.array([3, 1, 2], np.int32)])
    >>> out.tolist()
    [1, 2, 3]
    >>> svc.stats.requests
    1
    """

    def __init__(
        self,
        *,
        planner: Optional[Planner] = None,
        min_bucket: int = 8,
        device="cuda",
    ):
        self.device = check_device(device)
        self.planner = planner or default_planner()
        self.min_bucket = min_bucket
        self.cache = CompiledCache()
        self.stats = ServiceStats()
        # guards cache lookups/builds and stats counters; the call itself
        # runs outside it so concurrent batches still overlap
        self._lock = threading.Lock()
        self.planner.add_stats_sink(self)

    def _enter_device(self) -> None:
        """Make the service's card current on this thread (dispatcher
        threads call it before their first batch)."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def _note_exchange(self, obs) -> None:
        """Planner stats-sink hook: fold one exchange observation's retries,
        recompiles and peak/mean bucket ratio into this service's ledger."""
        with self._lock:
            self.stats.overflow_retries += obs.retries
            self.stats.recompiles += obs.recompiles
            self.stats.peak_mean_ratio = max(self.stats.peak_mean_ratio, obs.peak_mean_ratio())

    # ------------------------------------------------------------ builders ---
    @staticmethod
    def _plan_fields(kind: str, plan: SortPlan):
        """The (impl, block_n, n_threads) that actually shape ``kind``'s
        program; plans that differ only in fields this kind ignores share
        one cell."""
        impl = plan.local_impl
        if kind != "sort" and impl != "kernel":
            impl = "xla"  # argsort kinds only have the xla/kernel engines
        block_n = plan.block_n if impl == "kernel" else None
        n_threads = plan.n_threads if kind == "sort" else 0
        return impl, block_n, n_threads

    def _builder(self, kind: str, plan: SortPlan, ascending: bool):
        impl, block_n, n_threads = self._plan_fields(kind, plan)
        if kind == "sort":
            def build():
                return lambda xb: shared_memory_sort(
                    xb, n_threads=n_threads, local_impl=impl, ascending=ascending,
                    block_n=block_n,
                )
        elif kind == "argsort":
            def build():
                return lambda xb: _order_keys(xb, ascending=ascending, impl=impl, block_n=block_n)
        else:  # sort_kv
            def build():
                def f(xb, vb):
                    order = _order_keys(xb, ascending=ascending, impl=impl, block_n=block_n)
                    return _gather_last(xb, order), _gather_last(vb, order)
                return f
        return build

    # ---------------------------------------------------------- validation ---
    @staticmethod
    def _validate(
        kind: str,
        requests: Sequence[np.ndarray],
        values: Optional[Sequence[np.ndarray]],
    ) -> Tuple[List[np.ndarray], Optional[List[np.ndarray]]]:
        """Check one ragged batch; returns (reqs, vals) as numpy arrays."""
        if kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}")
        if (values is not None) != (kind == "sort_kv"):
            raise ValueError("values= is required iff kind='sort_kv'")
        reqs = [np.asarray(r) for r in requests]
        vals = None
        for i, r in enumerate(reqs):
            if r.ndim != 1:
                raise ValueError("requests must be 1-D arrays")
            if np.issubdtype(r.dtype, np.floating) and np.isnan(r).any():
                # NaN sorts after the padding sentinel, which would leak
                # padding values (or out-of-range argsort indices) into results
                raise ValueError(f"request {i} contains NaN keys (unsupported)")
        if kind == "sort_kv":
            vals = [np.asarray(v) for v in values]
            if len(vals) != len(reqs):
                raise ValueError("need exactly one values array per request")
            for i, (r, v) in enumerate(zip(reqs, vals)):
                if v.shape[:1] != r.shape:
                    raise ValueError(f"values[{i}] length must match request {i}")
        return reqs, vals

    def _group_key(self, req: np.ndarray, val: Optional[np.ndarray] = None) -> tuple:
        """(length bucket, dtype[, value signature]) — requests sharing this
        key pad into one batch and run one cell."""
        gk = (size_bucket(len(req), min_bucket=self.min_bucket), req.dtype.name)
        if val is not None:
            gk += (val.shape[1:], val.dtype.name)
        return gk

    def _signature(self, kind: str, gk: tuple, bb: int, ascending: bool):
        """The full executable identity of one (group key, batch bucket) cell:
        (plan, cache key, argument specs).  ``_run_group`` and ``warm_cell``
        both derive their cells from this one function, so a warmed cell
        *is* the serving cell."""
        bucket, name = gk[0], gk[1]
        plan = self.planner.plan_for(bucket, name, device=self.device)
        if plan.strategy != "shared":  # front door is single-device
            plan = SortPlan("shared")
        impl, block_n, n_threads = self._plan_fields(kind, plan)
        key = (kind, bucket, bb, name, ascending, impl, n_threads, block_n)
        args = [TensorSpec((bb, bucket), getattr(torch, name), self.device)]
        if kind == "sort_kv":
            vshape, vname = gk[2], gk[3]
            key = key + (vshape, vname)
            args.append(TensorSpec((bb, bucket) + vshape, getattr(torch, vname), self.device))
        return plan, key, args

    def warm_cell(
        self,
        kind: str,
        bucket: int,
        dtype,
        *,
        batch_bucket: int = 1,
        ascending: bool = True,
        values_spec: Optional[Tuple[tuple, Any]] = None,
    ) -> bool:
        """Build one cell before traffic arrives; True when this call built
        it, False when it was already warm.  ``values_spec`` (trailing value
        shape, value dtype) applies to ``kind='sort_kv'`` and defaults to
        scalar int32 values.

        >>> svc = SortService(device="cpu")
        >>> svc.warm_cell("sort", 1024, "int32")
        True
        >>> svc.warm_cell("sort", 1024, "int32")   # already warm
        False
        """
        gk: tuple = (int(bucket), dtype_name(dtype))
        if kind == "sort_kv":
            vshape, vdtype = values_spec if values_spec else ((), np.int32)
            gk += (tuple(vshape), dtype_name(vdtype))
        elif values_spec is not None:
            raise ValueError("values_spec= only applies to kind='sort_kv'")
        if kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}")
        plan, key, args = self._signature(kind, gk, int(batch_bucket), ascending)
        with self._lock:
            before = self.cache.misses
            self.cache.get_or_build(key, self._builder(kind, plan, ascending), args)
            fresh = self.cache.misses - before
            self.stats.compiles += fresh
            self.stats.cache_hits += int(fresh == 0)
        return bool(fresh)

    # ----------------------------------------------------------- execution ---
    def _run_group(
        self,
        kind: str,
        gk: tuple,
        reqs: List[np.ndarray],
        vals: Optional[List[np.ndarray]] = None,
        *,
        ascending: bool = True,
    ) -> List[Any]:
        """Pad one group (all ``reqs`` share ``gk``) and run its cell: numpy
        pad, one copy to the device, the cell's call, one copy back (inside
        the accounted span: it is what waits for the device), numpy slices.
        Returns one result per request, in the given order."""
        t0 = time.perf_counter()
        bucket, name = gk[0], gk[1]
        dtype = np.dtype(name)
        bb = size_bucket(len(reqs), min_bucket=1)  # pow2 batch bucket
        sent = _np_sentinel(dtype, largest=ascending)
        batch = np.full((bb, bucket), sent, dtype)
        for row, r in enumerate(reqs):
            batch[row, : len(r)] = r

        plan, key, args = self._signature(kind, gk, bb, ascending)

        if kind == "sort_kv":
            vshape, vdtype = gk[2], np.dtype(gk[3])
            vbatch = np.zeros((bb, bucket) + vshape, vdtype)
            for row, v in enumerate(vals):
                vbatch[row, : len(v)] = v

        with self._lock:
            before = self.cache.misses
            exe = self.cache.get_or_build(key, self._builder(kind, plan, ascending), args)
            self.stats.compiles += self.cache.misses - before
            self.stats.cache_hits += int(self.cache.misses == before)
            self.stats.batches += 1
            self.stats.padded_keys += bb * bucket - sum(len(r) for r in reqs)

        out: List[Any] = [None] * len(reqs)
        xb = tensor_from_reference(batch, self.device)
        if kind == "sort_kv":
            ks, vres = exe(xb, tensor_from_reference(vbatch, self.device))
            ks, vres = tensor_to_reference(ks), tensor_to_reference(vres)
            for row, r in enumerate(reqs):
                n = len(r)
                out[row] = (ks[row, :n], vres[row, :n])
        else:
            res = tensor_to_reference(exe(xb))
            for row, r in enumerate(reqs):
                # sentinel padding sorts last either direction, so the
                # leading n entries (indices < n for argsort) are the answer
                out[row] = res[row, : len(r)]

        t1 = time.perf_counter()
        with self._lock:
            self.stats.requests += len(reqs)
            self.stats.keys_in += sum(len(r) for r in reqs)
            self.stats.account_span(t0, t1)
        return out

    # -------------------------------------------------------------- submit ---
    def submit(
        self,
        requests: Sequence[np.ndarray],
        *,
        kind: str = "sort",
        values: Optional[Sequence[np.ndarray]] = None,
        ascending: bool = True,
    ) -> List[Any]:
        """Sort a ragged batch. Returns per-request numpy results, in order.

        kind='sort'    -> sorted keys
        kind='argsort' -> stable argsort indices (int32)
        kind='sort_kv' -> (sorted keys, aligned values); ``values[i]`` must
                          share ``requests[i]``'s length (extra trailing dims ok)
        """
        reqs, vals = self._validate(kind, requests, values)

        groups: Dict[tuple, List[int]] = {}
        for i, r in enumerate(reqs):
            gk = self._group_key(r, vals[i] if vals is not None else None)
            groups.setdefault(gk, []).append(i)

        out: List[Any] = [None] * len(reqs)
        for gk, idxs in sorted(groups.items(), key=lambda kv: repr(kv[0])):
            results = self._run_group(
                kind,
                gk,
                [reqs[i] for i in idxs],
                [vals[i] for i in idxs] if vals is not None else None,
                ascending=ascending,
            )
            for i, res in zip(idxs, results):
                out[i] = res
        return out
