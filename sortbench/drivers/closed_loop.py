"""Closed loop: one caller makes back-to-back calls of one front door on a
pool of device-resident arrays, stepping through the pool so that no call
finds its input in the card's L2.

Configuration keys: ``n`` (keys a call), ``pool`` (arrays),
``warm_rounds`` (passes over the pool before the window), ``check_calls``
(calls drawn from the seed whose answers are checked), ``trace_seconds``
(the traced window's length).  Traffic keys: ``op`` (``sort``:
``repro_torch.sort(x, local_impl="kernel")``; ``argsort``:
``repro_torch.engine.argsort(x, impl="kernel")``), ``dtype``, ``keys``
(``harness.make_keys``).
"""
from __future__ import annotations

import importlib
import time
from contextlib import ExitStack, nullcontext

import numpy as np

from sortbench import harness
from sortbench.frozen.roofline import least_bytes
from sortbench.frozen.timing import time_ms
from sortbench.reference import numpy_sort as ref
from sortbench.trace import collect, patched, profiler


def entry(op: str):
    """The front door a call goes through, with the kernels (looked up at
    each call)."""
    import repro_torch
    from repro_torch import engine

    if op == "sort":
        return lambda x: repro_torch.sort(x, local_impl="kernel")
    if op == "argsort":
        return lambda x: engine.argsort(x, impl="kernel")
    raise ValueError(f"closed_loop has no op {op!r}")


def library(op: str):
    """The library's own call on the same keys: the baseline line."""
    import torch

    if op == "sort":
        return lambda x: torch.sort(x).values
    return lambda x: torch.argsort(x, stable=True)


class Reservoir:
    """``k`` items drawn uniformly from a stream of unknown length, by a
    generator seeded from the run's seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items = k, np.random.default_rng(seed), []

    def offer(self, i: int, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.k:
                self.items[j] = item


def run(ctx: harness.Context) -> harness.Outcome:
    import torch
    from torch.profiler import record_function

    from repro_torch.kernels.bitonic_sort import bitonic_sort as kernels

    shared_sort = importlib.import_module("repro_torch.core.shared_sort")
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dev, op = ctx.device, tr["op"]
    on_card = dev == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    # set-up's phases, seconds from process start: imports, keys (the
    # card's context with them), warm-up (the kernels' build or load)
    phases = {"imports": time.perf_counter() - ctx.t_start}
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(harness.derive(ctx.seed, "keys"))
    pool = harness.make_keys(tr["keys"], (cfg["pool"], cfg["n"]), getattr(torch, tr["dtype"]),
                             gen, dev)
    sync()
    phases["keys"] = time.perf_counter() - ctx.t_start
    call = entry(op)
    for _ in range(cfg["warm_rounds"]):
        for row in pool:
            call(row)
    sync()
    phases["warm"] = time.perf_counter() - ctx.t_start
    ctx.info({"setup_phases_s": phases})

    seconds = min(ctx.seconds, cfg["trace_seconds"]) if ctx.trace else ctx.seconds
    span = record_function if ctx.trace else (lambda name: nullcontext())
    keep = Reservoir(cfg["check_calls"], harness.derive(ctx.seed, "check"))
    kernels.reset_launch_counts()
    with ExitStack() as stack:
        prof = smi = None
        if ctx.trace:
            smi = stack.enter_context(harness.SmiSampler()) if on_card else None
            stack.enter_context(patched(shared_sort, "merge_adjacent", "sb.merge"))
            prof = stack.enter_context(profiler(dev))
        with span("sb.window"):
            sync()
            t0 = time.perf_counter()
            calls = 0
            while True:
                slot = calls % len(pool)
                with span("sb.call"):
                    out = call(pool[slot])
                keep.offer(calls, (slot, out))
                calls += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            sync()
            t1 = time.perf_counter()
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    window_s = t1 - t0
    counters = {"calls": calls, "window_s": window_s,
                "least_bytes_per_call": least_bytes([pool[0]], [out])}
    outcome = harness.Outcome(
        end_to_end={"keys_per_s": calls * cfg["n"] / window_s / 1e6,
                    "setup_s": t0 - ctx.t_start},
        counters=counters, checks={}, attempted=calls, failed=0, memory_peak_bytes=peak,
        chips=1)
    if ctx.trace:
        outcome.trace = trace = collect(prof)
        if trace.ops:
            outcome.busy_s, outcome.window_s = trace.busy_s(), trace.window_s
        lines = {"launch_counts_per_call": {k: v / calls for k, v in launches.items() if v},
                 "calls": calls}
        if on_card:
            lib = library(op)
            lines["library_ms"] = {op: time_ms(lambda: [lib(x) for x in pool], reps=3) / len(pool)}
            lines["repro_torch_ms"] = window_s / calls * 1e3
            lines["nvidia_smi_samples"] = smi.lines
        ctx.info(lines)
    ctx.info(harness.card_info())

    # the answers: each sampled call's output against the reference on the
    # same keys, on the host, once the window has closed and the peak is read
    sampled = [(pool[slot].cpu().numpy(), o.cpu().numpy()) for slot, o in keep.items]
    del pool, out, keep
    wrong = sum(ref.mismatches(got, ref.answer(op, keys)) for keys, got in sampled)
    outcome.checks = {"mismatched_keys": (wrong, 0),
                      "unchecked_calls": (min(cfg["check_calls"], calls) - len(sampled), 0)}
    return outcome
