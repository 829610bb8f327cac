"""Tiled bitonic sort network: hand-written CUDA kernels for Hopper
(``csrc/bitonic_sort.cu``), their wrappers and plain versions
(``bitonic_sort.py``), the plain-torch oracles (``ref.py``) and the composed
sort / argsort / kv-sort (``ops.py``)."""
from .ops import DEFAULT_BLOCK_N, MAX_BLOCK_N, kernel_argsort, kernel_sort, kernel_sort_kv

__all__ = ["DEFAULT_BLOCK_N", "MAX_BLOCK_N", "kernel_argsort", "kernel_sort", "kernel_sort_kv"]
