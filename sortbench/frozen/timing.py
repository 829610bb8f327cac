"""Frozen CUDA-event timing, copied from ``chip_smoke.py`` (``time_ms``) at
commit cde9681ff4dce80b2a5ab2f1a8f2026b890519d5."""
from __future__ import annotations


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
