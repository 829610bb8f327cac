"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed, go through the reference (JAX, on
the CPU) and the port (torch, on CPU tensors), and come back as numpy
arrays whose bit patterns are compared: every op under test moves keys
without arithmetic, so the tolerance is exact.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.carry import tensor_from_reference, tensor_to_reference

DTYPES = {
    "float32": np.dtype(np.float32),
    "int32": np.dtype(np.int32),
    "float16": np.dtype(np.float16),
    "bfloat16": np.dtype(jnp.bfloat16),
}
LENGTHS = (1, 2, 3, 100, 500, 1000)
SIGNED_ZEROS = np.array([0.0, -0.0, 0.0, -0.0, 1.0, -0.0, 0.0, 2.0], np.float32)


def make_keys(dtype: str, shape, seed: int, *, duplicates: bool = False) -> np.ndarray:
    """Seeded keys: spread normals (floats) or integers; ``duplicates``
    draws from a handful of values so stability matters."""
    rng = np.random.default_rng(seed)
    if duplicates:
        return rng.integers(0, 7, shape).astype(DTYPES[dtype])
    if dtype == "int32":
        return rng.integers(-100_000, 100_000, shape).astype(np.int32)
    return (rng.standard_normal(shape) * 100).astype(DTYPES[dtype])


def cpu(a: np.ndarray):
    """numpy -> CPU tensor, dtype and bits kept."""
    return tensor_from_reference(np.asarray(a), "cpu")


def bits(a) -> np.ndarray:
    """Bit patterns of a reference array or a port tensor, for exact compares."""
    if isinstance(a, torch.Tensor):
        a = tensor_to_reference(a)
    a = np.asarray(a)
    if a.dtype.itemsize == 4 and a.dtype != np.int32:
        return a.view(np.int32)
    if a.dtype.itemsize == 2:
        return a.view(np.int16)
    return a


def assert_bits_equal(port, ref) -> None:
    np.testing.assert_array_equal(bits(port), bits(ref))
