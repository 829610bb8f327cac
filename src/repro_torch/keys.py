"""How a key is ordered and moved: every such decision of the port, in one place.

The float image the merge tree, kernel M and the kernel argsort compare on;
the integer views under which keys and payloads move bit for bit; the
order-reversing map of descending sorts; and the map of narrow and unsigned
keys into the int32 the bitonic kernels take.  A leaf: it imports torch and
nothing of ``repro_torch``.
"""
from __future__ import annotations

import torch

__all__ = [
    "sort_image", "int_bits", "gather_bits", "rev_key", "to_kernel_keys", "from_kernel_keys",
    "INT32_MAPPED",
]

_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
# torch has no gather and no bitwise NOT for these
_UNSIGNED = (torch.uint16, torch.uint32, torch.uint64)
_INT32_SIGN = -(1 << 31)
# widened exactly: int32 keeps their order
_WIDENED = (torch.int8, torch.uint8, torch.int16, torch.uint16)
# the dtypes to_kernel_keys maps onto int32 keys in the same order
INT32_MAPPED = (*_WIDENED, torch.uint32)


def sort_image(x: torch.Tensor) -> torch.Tensor:
    """Floats as integers in the order of ``jnp.sort`` and
    ``jnp.searchsorted``: -0.0 == +0.0, and NaN (either sign) above
    ``+inf``, all NaN equal.  Other dtypes as they are.  torch's library
    sort on the card orders a negative NaN first; on this image it orders
    as on the CPU and as the reference does.

    >>> sort_image(torch.tensor([-1.0, -0.0, 0.0, float("inf"), float("nan")])).tolist()
    [-1065353217, 0, 0, 2139095040, 2147483647]
    """
    if not x.dtype.is_floating_point:
        return x
    ft, it = (torch.float64, torch.int64) if x.dtype == torch.float64 else (torch.float32, torch.int32)
    f = x.to(ft) + 0.0  # -0.0 -> +0.0
    i = f.view(it)
    mag = torch.iinfo(it).max
    i = torch.where(i < 0, i ^ mag, i)  # sign-magnitude -> two's-complement order
    return torch.where(torch.isnan(f), mag, i)


def int_bits(x: torch.Tensor) -> torch.Tensor:
    """``x`` viewed as the signed integer of its size where torch cannot
    move or invert it as it is: floats (the CPU's vectorized bfloat16 gather
    rewrites NaN payloads) and uint16 / uint32 / uint64 (no gather, no
    bitwise NOT).  Other dtypes as they are.

    >>> int_bits(torch.tensor([1.0])).dtype, int_bits(torch.tensor([1], dtype=torch.uint8)).dtype
    (torch.int32, torch.uint8)
    """
    if x.dtype.is_floating_point or x.dtype in _UNSIGNED:
        return x.view(_SIGNED[x.element_size()])
    return x


def gather_bits(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``torch.gather`` along the last axis that keeps every bit (on
    ``int_bits``)."""
    return torch.gather(int_bits(x), -1, index).view(x.dtype)


def rev_key(keys: torch.Tensor) -> torch.Tensor:
    """Order-reversing self-inverse bijection: negation for floats, bitwise
    NOT for ints (~x = -x-1 is strictly decreasing; even INT_MIN is safe;
    unsigned, ~x = MAX - x).

    >>> rev_key(torch.tensor([0, 65535], dtype=torch.uint16)).tolist()
    [65535, 0]
    """
    if keys.dtype.is_floating_point:
        return -keys
    return (~int_bits(keys)).view(keys.dtype)


def to_kernel_keys(x: torch.Tensor) -> torch.Tensor:
    """Keys in a dtype the kernels take, in the same order: narrow integers
    widened to int32, uint32 with its sign bit flipped and viewed as int32."""
    if x.dtype in _WIDENED:
        return x.to(torch.int32)
    if x.dtype == torch.uint32:
        return x.view(torch.int32) ^ _INT32_SIGN
    if x.dtype == torch.bool:
        raise TypeError("bool keys are not sorted: the reference's kernels reject them too")
    if x.dtype in (torch.int64, torch.uint64, torch.float64):
        raise TypeError(
            f"{x.dtype} keys are not sorted: the reference runs with JAX's default of 32-bit "
            "types (x64 off), so it has no 64-bit keys"
        )
    return x


def from_kernel_keys(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of ``to_kernel_keys``.

    >>> x = torch.tensor([0, 4000000000], dtype=torch.uint32)
    >>> torch.equal(from_kernel_keys(to_kernel_keys(x), x.dtype), x)
    True
    """
    if dtype in _WIDENED:
        return y.to(dtype)
    if dtype == torch.uint32:
        return (y ^ _INT32_SIGN).view(torch.uint32)
    return y
