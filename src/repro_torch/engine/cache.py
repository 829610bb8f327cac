"""Executable cache: pow2 shape bucketing so serving traffic reuses warm cells.

Counterpart of ``repro/engine/cache.py``.  Serving requests arrive with
ragged lengths; every request is padded to its power-of-two *bucket* (tail
filled with sort sentinels, so the valid prefix of the sorted output is
exactly the answer) and one executable is kept per (kind, bucket shape,
dtype, plan) key.

The reference keeps an ahead-of-time compiled XLA executable per key.  The
port compiles nothing per shape: its kernels are built once per process
(``kernels/bitonic_sort/bitonic_sort.py:_lib``).  So "building" a cell here
is ``build()`` plus one call on example tensors of the cell's shape, dtype
and device: that call loads the kernel library (and lets the allocator and
the library sort see the shape), and later calls of the cell pay no build.
The ``hits`` / ``misses`` counters keep the reference's meaning: a miss is a
cell served for the first time.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.core.bitonic import next_pow2

__all__ = ["size_bucket", "CompiledCache", "TensorSpec"]


def size_bucket(n: int, *, min_bucket: int = 8) -> int:
    """Pad target for a length-n request (pow2, floored at min_bucket).

    >>> size_bucket(1000)
    1024
    >>> size_bucket(3)
    8
    """
    return max(min_bucket, next_pow2(n))


class TensorSpec(NamedTuple):
    """Shape, dtype and device of one argument of a cell (the port's
    ``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype
    device: torch.device

    def example(self) -> torch.Tensor:
        """A zero tensor of this spec: the warm-up call's argument."""
        return torch.zeros(self.shape, dtype=self.dtype, device=self.device)


@dataclass
class CompiledCache:
    """key -> warmed callable, with hit/miss (= first-use) counters.

    The key is the caller's full executable identity — for the sort service
    that includes the plan's ``local_impl`` *and* ``block_n``, since a
    kernel plan with a different tile width is a different launch sequence.

    >>> cache = CompiledCache()
    >>> exe = cache.get_or_build(
    ...     ("double", 3),
    ...     lambda: (lambda v: v * 2),
    ...     [TensorSpec((3,), torch.int32, torch.device("cpu"))],
    ... )
    >>> exe(torch.tensor([1, 2, 3])).tolist()
    [2, 4, 6]
    >>> cache.stats()
    {'entries': 1, 'hits': 0, 'misses': 1}
    """

    executables: Dict[Tuple, Any] = field(default_factory=dict)
    hits: int = 0
    misses: int = 0

    def get_or_build(self, key: Tuple, build: Callable[[], Callable], example_args):
        """Return the callable for ``key``; on first use build it and run it
        once on ``example_args`` (``TensorSpec``s or tensors)."""
        exe = self.executables.get(key)
        if exe is not None:
            self.hits += 1
            return exe
        self.misses += 1
        exe = build()
        args = [a.example() if isinstance(a, TensorSpec) else a for a in example_args]
        exe(*args)
        for a in args:
            if a.device.type == "cuda":  # a failing launch surfaces here, not in traffic
                torch.cuda.synchronize(a.device)
                break
        self.executables[key] = exe
        return exe

    def __contains__(self, key: Tuple) -> bool:
        """Is ``key``'s cell already warm?

        >>> CompiledCache().__contains__(("sort", 8))
        False
        """
        return key in self.executables

    def keys(self):
        """The warmed cells, in insertion (= warmup/serve) order."""
        return list(self.executables)

    def stats(self) -> dict:
        return {
            "entries": len(self.executables),
            "hits": self.hits,
            "misses": self.misses,
        }
