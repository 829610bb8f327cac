"""repro_torch — the parallel-sort framework on PyTorch and CUDA.

The port of ``repro`` (JAX + Pallas) to an NVIDIA H100.  It imports neither
``jax`` nor ``repro``; ``tests/test_torch_*.py`` hold each module against
its reference.  Public façade: ``repro_torch.sort`` and the
``repro_torch.engine`` kv sorts.  Every hand-written kernel is in
``repro_torch/kernels``.
"""
from repro_torch.core.api import sort

__all__ = ["sort"]
