"""Production-mesh dry-run on fake tensors: trace every (arch x shape x mesh)
cell's step as one rank of the mesh and record what it holds and moves.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell for 256 or 512 placeholder devices and reads XLA's memory and cost
analyses and the collectives of the optimized HLO.  Here nothing is
compiled and nothing is allocated: a ``fake`` process group stands in for
the mesh's world (one process, as its rank 0), and the
port's own ``train_step`` / ``prefill_step`` / ``serve_decode_step`` run on
``FakeTensorMode`` tensors (shape, dtype and device, no storage) on the
rank's blocks of params, optimizer state, batch and cache, under

* ``StepTracer``: the bytes of the tensors alive on the rank, at their
  peak (every tensor the step makes, rounded up to the CUDA caching
  allocator's 512-byte blocks on a CUDA device, the step's arguments
  counted from its start), and the FLOPs of its matrix products by
  ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s, its
  recomputes included; elementwise work is not counted);
* ``exchange.group.CollectiveCounter``: every collective the step makes
  through ``AxisGroup``, its kind and the bytes of its result on this rank.

The inputs follow the reference's ``build_cell``: params from
``model_init(device="meta")`` cut by ``shard_tree`` (train: the stored
FSDP x TP layout, ``param_specs``; prefill and decode: the compute layout
the port's serving steps take, ``compute_specs``), AdamW state with int8
moments above 3e10 params, 4 microbatches, a loss chunk of 512, this
rank's rows of ``input_specs`` and, for decode, its cache from
``init_cache`` on this rank's mesh context: its rows and, split-K, its
block of every attention cache's positions.  Records go to
``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json`` with the
reference's keys (``lower_s`` is the trace's seconds, ``compile_s`` 0).
Every count is one of the port's step on one rank, not a TPU number.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all --mesh both            # fake CUDA tensors
  python -m repro_torch.launch.dryrun --all --mesh pod --device cpu  # without a card
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
import weakref
from functools import partial

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import ARCHS, SHAPES, all_cells, cell_applicable, input_specs
from repro_torch.distributed.sharding import (
    batch_specs,
    compute_specs,
    fit_tree,
    param_specs,
    shard_tree,
    tp_layout,
)
from repro_torch.exchange.group import CollectiveCounter
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import ShardCtx, init_cache, model_init
from repro_torch.optim.adamw import OptConfig, init_opt_state
from repro_torch.train.steps import prefill_step, serve_decode_step, train_step
from repro_torch.tree import from_paths, paths

__all__ = ["StepTracer", "build_cell", "fake_world", "main", "parser", "run_cell",
           "storage_bytes", "trace"]

BLOCK = 512  # the CUDA caching allocator's smallest block


def _storage_size(st) -> int:
    n = st.nbytes()
    return -(-n // BLOCK) * BLOCK if st.device.type == "cuda" else n


class StepTracer(TorchDispatchMode):
    """Bytes of the storages alive, now and at their peak, counting every
    tensor an op under this mode returns and those handed to ``track``
    (a storage is counted once, views share it, and leaves the count when
    it dies; sizes on a CUDA device round up to ``BLOCK``), and the FLOPs
    of the ops ``torch.utils.flop_counter`` has a formula for."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.formulas = flop_registry
        self.live = {}
        self.now = self.peak = self.flops = 0

    def track(self, *trees) -> None:
        for t in tree_leaves(trees):
            if isinstance(t, torch.Tensor):
                self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = _storage_size(st)
        self.live[key] = (weakref.ref(st, partial(self._free, key)), n)
        self.now += n
        if self.now > self.peak:
            self.peak = self.now

    def _free(self, key, _ref) -> None:
        _, n = self.live.pop(key)
        self.now -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = self.formulas.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if isinstance(out, torch.Tensor):
            self._track(out)
        elif isinstance(out, (tuple, list)):
            for t in out:
                if isinstance(t, torch.Tensor):
                    self._track(t)
        return out


def storage_bytes(*trees, exclude=()) -> int:
    """Bytes of the distinct storages of the tensors in ``trees`` (sized as
    ``StepTracer`` sizes them), less those of ``exclude``'s tensors."""
    skip = {t.untyped_storage()._cdata for t in tree_leaves(exclude)
            if isinstance(t, torch.Tensor)}
    seen, total = set(), 0
    for t in tree_leaves(trees):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if st._cdata not in skip and st._cdata not in seen:
                seen.add(st._cdata)
                total += _storage_size(st)
    return total


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A ``fake`` default process group of ``world_size`` ranks in this
    process, as rank ``rank``: collectives return tensors of the right
    shapes and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake(tree, device):
    """Fake tensors (inside a ``FakeTensorMode``) shaped as ``tree``'s."""
    return from_paths((p, torch.empty(t.shape, dtype=t.dtype, device=device))
                      for p, t in paths(tree))


def build_cell(cfg, kind: str, inputs: dict, mesh, device, mode, *, cache_len: int = 0,
               n_microbatch: int = 4, loss_chunk: int = 512, opt_cfg=None):
    """``(fn, args, notes)`` for one step of ``cfg`` (``kind`` train,
    prefill or decode) on this rank of ``mesh``.  ``inputs`` are the whole
    batch's ``meta`` stand-ins (``input_specs``), ``cache_len`` the decode
    cache's positions; ``args`` are this rank's blocks as fake tensors of
    ``mode`` (a ``FakeTensorMode``) on ``device``.  ``opt_cfg`` defaults to
    the reference's choice (int8 moments above 3e10 params)."""
    M = mesh.shape["model"]
    ctx = ShardCtx(mesh=mesh, axes=mesh.axis_names, ep_axis="model")
    meta = model_init(torch.Generator(), cfg, ep_shards=M, device="meta")
    stored = fit_tree(param_specs(meta), meta, mesh)
    notes = []
    if "mamba" in cfg.pattern and not tp_layout(cfg, M).mamba:
        notes.append(f"{cfg.mamba_cfg().n_heads} SSM heads do not divide model={M}: "
                     "every rank runs every head")
    if cfg.n_heads and not tp_layout(cfg, M).heads:
        notes.append(f"{cfg.n_heads} heads do not divide model={M}: every rank runs every head")
    # the blocks' shapes, cut on meta tensors; the fakes are made in the mode
    b_meta = shard_tree(inputs, fit_tree(batch_specs(inputs), inputs, mesh), mesh)
    if kind == "train":
        p_meta = shard_tree(meta, stored, mesh)
    else:
        p_meta = shard_tree(meta, compute_specs(param_specs(meta), cfg, M), mesh)
    if kind == "decode":
        c_meta = init_cache(cfg, b_meta["tokens"].shape[0], cache_len, device="meta", ctx=ctx)
    with mode:
        b_in, p_in = _fake(b_meta, device), _fake(p_meta, device)
        if kind == "train":
            ocfg = opt_cfg or OptConfig(
                state_dtype="int8" if cfg.param_count() > 3e10 else "f32")
            o_in = init_opt_state(p_in, ocfg)

            def fn(params, opt_state, b):
                return train_step(params, opt_state, b, cfg=cfg, opt_cfg=ocfg, ctx=ctx,
                                  loss_chunk=loss_chunk, remat=True, n_microbatch=n_microbatch,
                                  specs=stored)

            return fn, (p_in, o_in, b_in), notes
        if kind == "prefill":
            def fn(params, b):
                return prefill_step(params, cfg, b["tokens"], ctx=ctx,
                                    frontend_embeds=b.get("frontend_embeds"))

            return fn, (p_in, b_in), notes
        c_in = {name: type(c)(*(torch.empty(t.shape, dtype=t.dtype, device=device) for t in c))
                for name, c in c_meta.items()}

        def fn(params, b, cache):
            return serve_decode_step(params, cfg, b["tokens"], cache, ctx=ctx)

        return fn, (p_in, b_in, c_in), notes


def trace(fn, args, mode) -> dict:
    """Run ``fn(*args)`` on fake tensors of ``mode`` under a ``StepTracer``
    and a ``CollectiveCounter``: the reference record's ``memory``,
    ``cost`` and ``collectives`` and the trace's seconds."""
    tracer = StepTracer()
    t0 = time.perf_counter()
    with mode, CollectiveCounter() as coll, tracer:
        tracer.track(args)
        arg_bytes = tracer.now
        out = fn(*args)
        out_bytes = storage_bytes(out, exclude=args)
    return {
        "trace_s": time.perf_counter() - t0,
        "memory": {"argument_bytes_per_device": arg_bytes,
                   "output_bytes_per_device": out_bytes,
                   "temp_bytes_per_device": tracer.peak - arg_bytes - out_bytes,
                   "peak_bytes_per_device": tracer.peak},
        "cost": {"flops": tracer.flops},
        "collectives": coll.record(),
    }


def run_cell(arch: str, shape: str, mesh_kind: str, outdir: str, device="cuda") -> dict:
    """Trace one cell as rank 0 of the production mesh (``mesh_kind``
    ``pod`` or ``multipod``); writes and returns its record."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    multi = mesh_kind == "multipod"
    seq, _, kind = SHAPES[shape]
    world = 512 if multi else 256
    with fake_world(world):
        mesh = make_production_mesh(multi_pod=multi)
        mode = FakeTensorMode()
        t0 = time.perf_counter()
        cfg = ARCHS[arch]
        fn, args, notes = build_cell(
            cfg, kind, input_specs(cfg, shape), mesh, torch.device(device), mode,
            cache_len=seq)
        traced = trace(fn, args, mode)
    rec = {
        "arch": arch,
        "shape": shape,
        "mesh": mesh_kind,
        "n_devices": world,
        "device": str(device),
        "lower_s": round(time.perf_counter() - t0, 2),
        "compile_s": 0,
        "memory": traced["memory"],
        "cost": traced["cost"],
        "collectives": traced["collectives"],
        "notes": notes,
    }
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, f"{arch}__{shape}__{mesh_kind}.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=("pod", "multipod", "both"), default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device: cuda (the default) or cpu")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its own")
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("name --arch and --shape, or --all")

    meshes = ("pod", "multipod") if args.mesh == "both" else (args.mesh,)
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    runs = []
    for arch, shape in cells:
        if not cell_applicable(arch, shape):
            print(f"SKIP {arch} {shape} (documented: needs sub-quadratic path)")
            continue
        runs += [(arch, shape, mk, args.out, args.device) for mk in meshes]
    pool = None
    if args.jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        pool = ProcessPoolExecutor(args.jobs, mp_context=multiprocessing.get_context("spawn"))
        # the longest traces (train, then prefill) first, so none starts last
        runs.sort(key=lambda r: ("train", "prefill", "decode").index(SHAPES[r[1]][2]))
    failures = 0
    try:
        pending = [pool.submit(run_cell, *r) if pool else r for r in runs]
        for (arch, shape, mk, *_), job in zip(runs, pending):
            try:
                rec = job.result() if pool else run_cell(*job)
                peak = rec["memory"]["peak_bytes_per_device"]
                print(
                    f"OK   {arch:28s} {shape:12s} {mk:8s} "
                    f"peak/dev={peak / 2**30:7.2f}GiB "
                    f"flops={rec['cost']['flops']:.3e} "
                    f"coll={rec['collectives']['total_bytes'] / 2**30:.2f}GiB "
                    f"trace={rec['lower_s']:.0f}s", flush=True)
            except Exception as e:
                failures += 1
                print(f"FAIL {arch} {shape} {mk}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc(limit=3)
    finally:
        if pool:
            pool.shutdown()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
