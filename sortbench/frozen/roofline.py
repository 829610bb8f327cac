"""Frozen roofline arithmetic: the card's peak and the least bytes of a call.

``HBM_BYTES_PER_S`` and the rule "each input read once, each output
written once" are copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``,
``bytes_bound_ms``) at commit cde9681ff4dce80b2a5ab2f1a8f2026b890519d5.
"""
from __future__ import annotations

from typing import Iterable

# H100 SXM device memory rate, NVIDIA's data sheet (at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12


def least_bytes(inputs: Iterable, outputs: Iterable) -> int:
    """Bytes a call must move at the least: every input tensor read once
    and every output tensor written once (``numel * element_size``)."""
    return sum(t.numel() * t.element_size() for t in (*inputs, *outputs))


def roofline_share(nbytes: float, device_s: float) -> float:
    """Percent of the memory roofline: the least time ``nbytes`` take at
    the peak rate over the device time the work took."""
    return nbytes / HBM_BYTES_PER_S / device_s * 100.0
