"""Closed loop of the decode top-k: one caller makes back-to-back calls of
``repro_torch.engine.topk(logits, k, impl="kernel")`` on a pool of
device-resident batches of logits (rows, vocab), one batch a decode step,
stepping through the pool so that no call finds its logits in the card's
L2.  No synchronize between calls; one closes the window.

Configuration keys: ``rows`` and ``vocab`` (a batch's shape), ``k``,
``pool``, ``warm_rounds``, ``check_calls`` and ``trace_seconds`` (as in
``closed_loop``).  Traffic keys: ``op`` (``topk``), ``largest``,
``dtype`` (the dtype the logits are held in), ``round_to`` (the dtype they
are computed in, which rounds them; absent: none), ``keys``
(``harness.make_keys``).

``control_patches`` puts ``reference.topk_ref.control`` in
``engine.topk``'s place, as a ``run_cell`` hook; on a card

    PYTHONPATH=src python3 -m sortbench.drivers.rows_topk --seeds a,b,c

runs the cell so, once a seed, and ``correct`` must read false.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import ExitStack, nullcontext

from sortbench import harness
from sortbench.drivers.closed_loop import Reservoir
from sortbench.frozen.roofline import least_bytes
from sortbench.frozen.timing import time_ms
from sortbench.reference import topk_ref as ref
from sortbench.trace import collect, profiler

CONTROL = "sortbench.drivers.rows_topk:control_patches"


def entry(k: int, largest: bool):
    """The front door a call goes through, with the kernels (looked up at
    each call)."""
    from repro_torch import engine

    return lambda x: engine.topk(x, k, largest=largest, impl="kernel")


def control_patches(cell: harness.Cell):
    """The patch that puts the control (ties to the highest index) where
    the program's answer is made."""
    from unittest import mock

    import torch

    from repro_torch import engine

    def on_host(x, k, *, largest=True, **kw):
        vals, idx = ref.control(x.cpu().numpy(), k, largest)
        return torch.from_numpy(vals).to(x.device), torch.from_numpy(idx).to(x.device)

    return [mock.patch.object(engine, "topk", on_host)]


def run(ctx: harness.Context) -> harness.Outcome:
    import torch
    from torch.profiler import record_function

    from repro_torch.kernels.bitonic_sort import bitonic_sort as kernels

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    if tr["op"] != "topk":
        raise ValueError(f"rows_topk has no op {tr['op']!r}")
    dev, k, largest = ctx.device, cfg["k"], tr["largest"]
    on_card = dev == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    # set-up's phases, seconds from process start: imports, logits (the
    # card's context with them), warm-up (the kernels' build or load)
    phases = {"imports": time.perf_counter() - ctx.t_start}
    gen = torch.Generator(device=dev).manual_seed(harness.derive(ctx.seed, "keys"))
    computed = getattr(torch, tr.get("round_to", tr["dtype"]))
    pool = harness.make_keys(tr["keys"], (cfg["pool"], cfg["rows"], cfg["vocab"]), computed,
                             gen, dev).to(getattr(torch, tr["dtype"]))
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()  # the pool and the calls, not its draw
    phases["keys"] = time.perf_counter() - ctx.t_start
    call = entry(k, largest)
    for _ in range(cfg["warm_rounds"]):
        for batch in pool:
            call(batch)
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
                "least_bytes_per_call": least_bytes([pool[0]], out),
                "launches_per_call": sum(launches.values()) / calls}
    outcome = harness.Outcome(
        end_to_end={"keys_per_s": calls * cfg["rows"] * cfg["vocab"] / window_s / 1e6,
                    "setup_s": t0 - ctx.t_start},
        counters=counters, checks={}, attempted=calls, failed=0, memory_peak_bytes=peak,
        chips=1)
    if ctx.trace:
        outcome.trace = trace = collect(prof)
        if trace.ops:
            outcome.busy_s, outcome.window_s = trace.busy_s(), trace.window_s
        lines = {"launch_counts_per_call": {n: v / calls for n, v in launches.items() if v},
                 "calls": calls}
        if on_card:
            lines["library_ms"] = {"topk": time_ms(
                lambda: [torch.topk(x, k, largest=largest) for x in pool], reps=3) / len(pool)}
            lines["repro_torch_ms"] = window_s / calls * 1e3
            lines["nvidia_smi_samples"] = smi.lines
        ctx.info(lines)
    ctx.info(harness.card_info())

    # the answers: each sampled call's values and indices against the
    # reference on the same logits, on the host, once the window has closed
    sampled = [(pool[slot].cpu().numpy(), vals.cpu().numpy(), idx.cpu().numpy())
               for slot, (vals, idx) in keep.items]
    del pool, out, keep
    wrong_idx = wrong_vals = 0
    for keys, vals, idx in sampled:
        want_vals, want_idx = ref.answer(keys, k, largest)
        wrong_idx += ref.mismatches(idx, want_idx)
        wrong_vals += ref.mismatches(vals, want_vals)
    outcome.checks = {"mismatched_indices": (wrong_idx, 0),
                      "mismatched_values": (wrong_vals, 0),
                      "unchecked_calls": (min(cfg["check_calls"], calls) - len(sampled), 0)}
    return outcome


def main() -> int:
    ap = argparse.ArgumentParser(description="Run a top-k cell with its control in the "
                                             "program's place, once a seed, on a card.")
    ap.add_argument("--workload", default="topk_cmdr256k.decode")
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("rows_topk: the control needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds.split(","):
        r = harness.run_cell(args.workload, int(seed), args.seconds, False, device="cuda",
                             info=lambda obj: None, hooks=(CONTROL,))
        print(json.dumps({"workload": args.workload, "seed": int(seed), "correct": r["correct"],
                          "attempted": r["attempted"], "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
