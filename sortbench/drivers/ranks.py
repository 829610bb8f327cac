"""Closed loop over ranks: every rank of a group, one a card, calls the
mesh front door on its own shard, all ranks in step, back to back.

Rank 0 is the process the command started; it starts ranks 1..world-1
(``harness.worker_main`` in fresh processes), meets them through a
FileStore under ``TMPDIR``, decides when the window closes (a flag on a
host-side gloo group, so the device sees no extra collective), gathers
the other ranks' readings and judges the answers.

Configuration keys: ``world``, ``n_per_rank``, ``warm_calls`` (least
calls before the window), ``max_warm_calls`` (warm-up ends once the
capacity loop's learned table stops moving, or here), ``check_calls``,
``trace_seconds``, ``timeout_s`` (a collective's and a rank's limit).
Traffic keys: ``op`` (``sort``: ``repro_torch.sort(x, mesh=group,
local_impl="kernel")``), ``dtype``, ``keys``.
"""
from __future__ import annotations

import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from contextlib import ExitStack, nullcontext
from datetime import timedelta

from sortbench import harness
from sortbench.drivers.closed_loop import Reservoir
from sortbench.reference import numpy_sort as ref
from sortbench.trace import collect, patched, profiler


def _spawn(ctx: harness.Context, world: int, store: str, overrides: dict):
    """Start ranks 1..world-1; their output goes to this process's stderr."""
    procs = []
    for rank in range(1, world):
        spec = {"workload": ctx.cell.name, "seed": ctx.seed, "seconds": ctx.seconds,
                "trace": ctx.trace, "device": ctx.device, "rank": rank, "store": store,
                "plans": ctx.plans, "overrides": overrides, "hooks": list(ctx.hooks)}
        code = (f"import sys; sys.path[:0] = {[harness.ROOT, os.path.join(harness.ROOT, 'src')]!r}; "
                f"from sortbench import harness; sys.exit(harness.worker_main({json.dumps(spec)!r}))")
        procs.append(subprocess.Popen([sys.executable, "-c", code], stdout=sys.stderr,
                                      cwd=harness.ROOT))
    return procs


class _Watch:
    """Ends the run if a rank worker fails, so rank 0 never waits on a
    collective that a dead peer will not join."""

    def __init__(self, procs):
        self.procs, self.stop = procs, threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self) -> None:
        while not self.stop.wait(0.5):
            bad = [p.returncode for p in self.procs if p.poll() not in (None, 0)]
            if bad:
                print(f"sortbench: a rank worker failed ({bad}); ending the run", file=sys.stderr,
                      flush=True)
                for p in self.procs:
                    p.kill()
                os._exit(1)

    def __enter__(self) -> "_Watch":
        self.thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop.set()
        self.thread.join()


def run(ctx: harness.Context) -> harness.Outcome:
    cfg = ctx.cell.config
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if ctx.rank:
        return _rank(ctx)
    tmp = tempfile.mkdtemp(prefix="sortbench-ranks-")
    store = os.path.join(tmp, "store")
    overrides = {"config": ctx.cell.config, "traffic": ctx.cell.traffic}
    procs = _spawn(ctx, cfg["world"], store, overrides)
    try:
        with _Watch(procs):
            ctx.store = store
            outcome = _rank(ctx)
        for p in procs:
            p.wait(timeout=cfg["timeout_s"])
        if any(p.returncode for p in procs):
            raise RuntimeError(f"rank workers exited with {[p.returncode for p in procs]}")
        return outcome
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def _rank(ctx: harness.Context):
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import record_function

    import repro_torch
    from repro_torch.engine.planner import default_planner
    from repro_torch.exchange import AxisGroup
    from repro_torch.exchange.group import CollectiveCounter

    cluster_sort = importlib.import_module("repro_torch.core.cluster_sort")
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    world, n, rank = cfg["world"], cfg["n_per_rank"], ctx.rank
    on_card = ctx.device == "cuda"
    if on_card:
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
        torch.cuda.reset_peak_memory_stats()
    else:
        device = torch.device("cpu")
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    timeout = timedelta(seconds=cfg["timeout_s"])
    dist.init_process_group("nccl" if on_card else "gloo", init_method=f"file://{ctx.store}",
                            rank=rank, world_size=world, timeout=timeout,
                            **({"device_id": device} if on_card else {}))
    try:
        ctl = dist.new_group(backend="gloo", timeout=timeout)
        group = AxisGroup()
        dtype = getattr(torch, tr["dtype"])

        def shard(r: int):
            gen = torch.Generator(device=device).manual_seed(harness.derive(ctx.seed, "keys", r))
            return harness.make_keys(tr["keys"], (n,), dtype, gen, device)

        if tr["op"] != "sort":
            raise ValueError(f"ranks has no op {tr['op']!r}")
        x = shard(rank)
        planner = default_planner()

        def call():
            return repro_torch.sort(x, mesh=group, local_impl="kernel")

        def all_ranks(flag: bool) -> bool:
            t = torch.tensor([int(flag)])
            dist.all_reduce(t, op=dist.ReduceOp.MIN, group=ctl)
            return bool(t.item())

        def learned():
            return {k: (v.capacity_factor, v.partition) for k, v in planner.learned.items()}

        # warm up until the capacity-learning loop has stopped learning
        before = None
        for i in range(cfg["max_warm_calls"]):
            call()
            now = learned()
            if all_ranks(i + 1 >= cfg["warm_calls"] and now == before):
                break
            before = now
        sync()

        seconds = min(ctx.seconds, cfg["trace_seconds"]) if ctx.trace else ctx.seconds
        span = record_function if ctx.trace else (lambda name: nullcontext())
        keep = Reservoir(cfg["check_calls"], harness.derive(ctx.seed, "check"))
        tel = planner.telemetry
        calls0, retries0 = tel.calls, tel.total_retries
        flag = torch.zeros(1, dtype=torch.int32)
        with ExitStack() as stack:
            prof = smi = None
            counter = stack.enter_context(CollectiveCounter())
            if ctx.trace:
                smi = stack.enter_context(harness.SmiSampler()) if on_card and not rank else None
                stack.enter_context(patched(cluster_sort, "partition_exchange", "sb.exchange"))
                stack.enter_context(patched(cluster_sort, "fast_local_sort", "sb.local_sort"))
                prof = stack.enter_context(profiler(ctx.device))
            with span("sb.window"):
                dist.barrier(group=ctl)
                t0 = time.perf_counter()
                calls = 0
                while True:
                    with span("sb.call"):
                        out = call()
                    keep.offer(calls, out)
                    calls += 1
                    flag[0] = int(time.perf_counter() - t0 >= seconds)
                    dist.broadcast(flag, src=0, group=ctl)
                    if flag.item():
                        break
                sync()
                t1 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        trace = collect(prof) if ctx.trace else None
        mine = {"peak": peak, "busy_s": trace.busy_s() if trace and trace.ops else None,
                "window_s": trace.window_s if trace else None}
        readings = [None] * world
        dist.all_gather_object(readings, mine, group=ctl)

        # the answers: each sampled call's valid blocks, gathered in rank order
        blocks = []
        for slab, valid in keep.items:
            block = slab[valid]
            sizes = [torch.zeros(1, dtype=torch.int64, device=device) for _ in range(world)]
            dist.all_gather(sizes, torch.tensor([block.numel()], device=device))
            most = int(max(s.item() for s in sizes))
            padded = torch.zeros(most, dtype=block.dtype, device=device)
            padded[: block.numel()] = block
            parts = [torch.empty_like(padded) for _ in range(world)]
            dist.all_gather(parts, padded)
            if not rank:
                blocks.append(np.concatenate([p[: int(s.item())].cpu().numpy()
                                              for p, s in zip(parts, sizes)]))
            del parts, padded, block
        del keep, out
        if rank:
            return None
        inputs = np.concatenate([shard(r).cpu().numpy() for r in range(world)])
    finally:
        dist.destroy_process_group()

    want = ref.answer(tr["op"], inputs)
    wrong = sum(ref.mismatches(got, want) for got in blocks)
    window_s = t1 - t0
    retries = tel.total_retries - retries0
    counters = {"calls": calls, "window_s": window_s, "retries": retries,
                "exchanges": tel.calls - calls0}
    outcome = harness.Outcome(
        end_to_end={"mesh_keys_per_s": calls * n * world / window_s / 1e6,
                    "setup_s": t0 - ctx.t_start},
        counters=counters,
        checks={"mismatched_keys": (wrong, 0),
                "unchecked_calls": (min(cfg["check_calls"], calls) - len(blocks), 0)},
        attempted=calls, failed=0, memory_peak_bytes=max(r["peak"] for r in readings),
        chips=world, trace=trace)
    busy = [r["busy_s"] for r in readings]
    if ctx.trace and all(b is not None for b in busy):
        outcome.busy_s = sum(busy) / world
        outcome.window_s = sum(r["window_s"] for r in readings) / world
    ctx.info({"calls": calls, "collective_bytes_per_call":
              {k: v / calls for k, v in counter.bytes.items() if v},
              "collectives_per_call": {k: v / calls for k, v in counter.counts.items() if v},
              "capacity_retries": retries, "peaks": [r["peak"] for r in readings],
              "nvidia_smi_samples": smi.lines if smi else None})
    ctx.info(harness.card_info())
    return outcome
