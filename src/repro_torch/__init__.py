"""repro_torch — the parallel-sort framework on PyTorch and CUDA.

The port of ``repro`` (JAX + Pallas) to an NVIDIA H100.  It imports neither
``jax`` nor ``repro``; ``tests/test_torch_*.py`` hold each module against
its reference.  Public façade: ``repro_torch.sort`` and the
``repro_torch.engine`` kv sorts.  Every hand-written kernel is in
``repro_torch/kernels``.
"""
__all__ = ["sort"]


def __getattr__(name: str):
    # the sort models load on first use of ``repro_torch.sort``, so that
    # importing a lower layer (``keys``, ``kernels``, ``exchange``) loads
    # nothing above it
    if name == "sort":
        from repro_torch.core.api import sort

        globals()["sort"] = sort
        return sort
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
