"""Capacity-doubling retry loop shared by every exchange consumer (torch).

Counterpart of ``repro/exchange/retry.py``.  ``cluster_sort`` /
``cluster_sort_kv`` run their exchange through ``run_with_capacity_retries``:
execute at the current capacity, detect collective overflow, double and
re-execute, and report the final attempt's telemetry (peak per-(sender,
bucket) count, overflow and retry events).

The port compiles nothing, so a retry never builds a fresh executable: the
``recompiles`` it reports is always 0, and there is no compile cache to
pass in.  Every other telemetry field is the reference's.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.tracing import span

__all__ = ["run_with_capacity_retries"]


def run_with_capacity_retries(
    run_fn: Callable[[int], tuple],
    *,
    m: int,
    part_buckets: int,
    cap: int,
    max_retries: int,
    telemetry: Optional[Callable[..., None]],
    label: str,
    strict: bool = True,
    partition: Optional[str] = None,
):
    """Run ``run_fn(capacity)``, doubling the capacity while it overflows.

    ``run_fn`` returns ``(*outputs, counts, peak, overflow)``.  On success
    returns ``(outputs, counts)``.  On persistent overflow, ``strict=True``
    (the sort contract: losing keys is corruption) raises ``RuntimeError``;
    ``strict=False`` (the MoE contract: overflow-drop is well defined)
    returns the last attempt's outputs.  Either way the final attempt's
    telemetry goes to ``telemetry`` (keyword args ``m``, ``part_buckets``,
    ``capacity``, ``peak``, ``overflowed``, ``retries``, ``recompiles``,
    ``partition``).

    >>> def run(cap):                      # toy: overflows until cap >= 3
    ...     return "out", [3], 3, cap < 3
    >>> seen = []
    >>> outs, counts = run_with_capacity_retries(
    ...     run, m=8, part_buckets=1, cap=1, max_retries=4,
    ...     telemetry=lambda **kw: seen.append(kw), label="toy")
    >>> outs, counts                       # cap doubled 1 -> 2 -> 4, then fit
    (['out'], [3])
    >>> seen[0]["capacity"], seen[0]["retries"], seen[0]["recompiles"]
    (4, 2, 0)
    """
    retries, peak = 0, 0

    def report(overflowed: bool) -> None:
        if telemetry is not None:
            telemetry(
                m=m,
                part_buckets=part_buckets,
                capacity=cap,
                peak=peak,
                overflowed=overflowed,
                retries=retries,
                recompiles=0,
                partition=partition,
            )

    for attempt in range(max_retries + 1):
        if attempt:
            cap = min(m, cap * 2)
        *outs, counts, att_peak, overflow = run_fn(cap)
        with span("repro_torch.retry.read"):  # the host waits for the attempt here
            att_peak, overflow = int(att_peak), bool(overflow)
        peak = max(peak, att_peak)
        retries = attempt
        if not overflow:
            report(overflowed=attempt > 0)
            return outs, counts
        if cap >= m:
            break  # already loss-free capacity; more retries can't help
    report(overflowed=True)
    if strict:
        raise RuntimeError(f"{label}: capacity overflow persisted after retries")
    return outs, counts
