"""Plain-torch oracles for the bitonic sort kernels (counterpart of
``repro/kernels/bitonic_sort/ref.py``).

The n-element network decomposes into:

  phase 1   per-block sort, block b ascending iff b even          (kernel A)
  stage k   global substages j = k/2 .. block_n                   (kernel C)
            local substages  j = block_n/2 .. 1                   (kernel B)

Each oracle is the bit-exact reference of one kernel, written with the
``core/bitonic.py`` network; ``full_sort_ref`` is the end-to-end op.  All
work on the last axis, so a leading batch of rows is one more dim.
"""
from __future__ import annotations

import torch

from repro_torch.core.bitonic import _compare_exchange, _network


def block_sort_ref(x: torch.Tensor, block_n: int) -> torch.Tensor:
    """Kernel A oracle: sort aligned blocks, alternating asc/desc per block."""
    n = x.shape[-1]
    nb = n // block_n
    blocks = x.reshape(*x.shape[:-1], nb, block_n)
    asc, _, _ = _network(blocks, None, None, ascending=True)
    desc, _, _ = _network(blocks, None, None, ascending=False)
    even = (torch.arange(nb, device=x.device) % 2 == 0)[:, None]
    return torch.where(even, asc, desc).reshape(x.shape)


def block_merge_ref(x: torch.Tensor, block_n: int, k: int) -> torch.Tensor:
    """Kernel B oracle: all substages j = block_n/2 .. 1 of stage ``k``."""
    n = x.shape[-1]
    sub = block_n // 2
    while sub >= 1:
        j = sub
        g = n // (2 * j)
        blk_of_group = (torch.arange(g, device=x.device) * 2 * j) // k
        x, _, _ = _compare_exchange(x, None, None, j, blk_of_group % 2 == 0, ascending=True)
        sub //= 2
    return x


def global_stage_ref(x: torch.Tensor, j: int, k: int) -> torch.Tensor:
    """Kernel C oracle: one cross-block substage (partner distance j >= block_n)."""
    n = x.shape[-1]
    g = n // (2 * j)
    dir_up = ((torch.arange(g, device=x.device) * 2 * j) // k) % 2 == 0
    x, _, _ = _compare_exchange(x, None, None, j, dir_up, ascending=True)
    return x


def full_sort_ref(x: torch.Tensor) -> torch.Tensor:
    """End-to-end oracle for the composed op: the library sort, stable as
    the reference's ``jnp.sort``."""
    return torch.sort(x, dim=-1, stable=True).values
