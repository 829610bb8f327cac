"""Keys and a NumPy oracle for the top-k tests of kernel T (``topk_select``),
shared by the CPU tests and the card's (which import no JAX).

Every case is (kind, dtype, shape, k).  The shapes put rows shorter than one
of T's segments beside rows of several whose width no segment divides, and
k at 1, at n, at each list length of T and at ``SELECT_MAX_K``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.bitonic_sort.bitonic_sort import SELECT_MAX_K

CASES = [
    ("bf16_ties", torch.float32, (4, 3000), 50),
    ("bf16_ties", torch.bfloat16, (2, 20_000), 64),
    ("bf16_ties", torch.float16, (3, 700), 1),
    ("bf16_ties", torch.float32, (5,), 3),
    ("specials", torch.float32, (2, 1000), SELECT_MAX_K),
    ("specials", torch.bfloat16, (3, 9001), 65),
    ("specials", torch.float16, (3, 200), 200),
    ("equal", torch.float32, (2, 5000), 50),
    ("equal", torch.int32, (2, 100), 100),
    ("ints", torch.int32, (3, 8193), 50),
    ("ints", torch.uint8, (2, 1000), 129),
    ("ints", torch.uint32, (2, 3000), 10),
]


def case_id(case) -> str:
    kind, dtype, shape, k = case
    return f"{kind}-{str(dtype).split('.')[-1]}-{'x'.join(map(str, shape))}-k{k}"


def topk_keys(kind: str, dtype: torch.dtype, shape, seed: int) -> torch.Tensor:
    """Seeded CPU keys.  ``bf16_ties``: normal logits (std 3) rounded to
    bfloat16, so equal keys straddle the k-th place; ``specials``: the same
    with NaN of both signs, +-inf and +-0.0 in a quarter of the slots;
    ``equal``: every key alike; ``ints``: integers over the dtype's whole
    range, its extremes included, with duplicates."""
    g = torch.Generator().manual_seed(seed)
    if kind == "equal":
        return torch.full(shape, 3, dtype=dtype)
    if kind == "ints":
        info = torch.iinfo(torch.int32 if dtype == torch.uint32 else dtype)
        lo, hi = (0, (1 << 32) - 1) if dtype == torch.uint32 else (info.min, info.max)
        x = torch.randint(lo, hi + 1, shape, generator=g, dtype=torch.int64)
        x.view(-1)[::7] = x.view(-1)[3]
        x.view(-1)[:4] = torch.tensor([lo, hi, hi, lo])
        return x.to(dtype) if dtype != torch.uint32 else x.to(torch.uint32)
    x = (torch.randn(shape, generator=g) * 3.0).to(torch.bfloat16).float()
    if kind == "specials":
        special = torch.tensor([float("nan"), -float("nan"), float("inf"), -float("inf"), 0.0, -0.0])
        at = torch.rand(shape, generator=g) < 0.25
        x = torch.where(at, special[torch.randint(0, 6, shape, generator=g)], x)
    return x.to(dtype)


def numpy_topk(x: torch.Tensor, k: int, largest: bool) -> np.ndarray:
    """Indices of the k best keys of each row by NumPy's stable argsort: NaN
    of either sign last, -0.0 tied with +0.0, ties to the lowest index."""
    wide = x.double() if x.dtype.is_floating_point else x.to(torch.int64)
    a = wide.numpy()
    return np.argsort(-a if largest else a, axis=-1, kind="stable")[..., :k]
