"""End-to-end training driver (torch), on one device or a mesh.

Counterpart of ``repro/launch/train.py``, every flag the same, plus
``--device`` (default ``cuda``; ``cpu`` runs on the CPU) and
``--dist-backend``.  It wires together
the config registry, model init (from ``torch.Generator(device)`` seeded
with ``--seed``), ``train_step`` (chunked CE, remat, AdamW), the synthetic
data pipeline with its prefetch thread, the checkpoint manager and the
fault-tolerant control loop (watchdog, anomaly monitor, restore and
replay).

MoE archs close the capacity-learning loop during training: a
``MoECapacityController`` reads the planner's learned factor before each
step, folds the step's ``moe_dropped`` / ``moe_peak`` back in afterwards,
and the factors persist to the plan cache (``--plans``, else
``$REPRO_SORT_PLANS`` through the process planner), so capacity learned
here warms ``serve --moe`` and vice versa.  The planner's telemetry feeds
``AnomalyMonitor.watch_exchange``.  The reference compiles one step per
capacity; here a capacity change compiles nothing.

A checkpoint holds the params, the optimizer state and the pipeline's
(seed, step) with ``step`` the number of batches the steps consumed; a
restore restarts the prefetch thread from there, so a replay sees the
batches the lost steps saw.

``--mesh data=2,model=2`` trains on a (data, model) mesh of every rank of
the default process group, one process a rank: the batch over ``data``,
the vocabulary and the experts over ``model``, the params and the AdamW
state stored as each rank's block, FSDP x TP (``distributed.sharding``).
The group comes from ``torchrun``'s environment (or is one rank alone, or
is already up when a caller spawned the ranks itself); ``--dist-backend``
names its backend: ``nccl`` (the default on ``cuda``) takes one rank a
card and raises when there are more ranks than cards, ``gloo`` (the
default on ``cpu``) also lets several ranks share a card, its CUDA tensors
staged through host memory.  Nothing falls back from one to the other.
Each rank takes card ``LOCAL_RANK % device_count``.  Every rank draws the
same global batch and keeps its rows, so a mesh run sees the one-device
run's batches; the metrics the monitor and the capacity controller read
are rank 0's on every rank, and a failed step restores every rank.
Checkpoints are whole (gathered, written by rank 0) and restore onto any
mesh.

Usage:
  python -m repro_torch.launch.train --arch qwen3-0.6b --steps 50 --reduced \\
      --batch 8 --seq 64 --ckpt-dir /tmp/ckpt [--device cpu]
  python -m repro_torch.launch.train --arch granite-moe-3b-a800m --reduced \\
      --moe-skew 6.0 --plans /tmp/plans.json
  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch granite-moe-3b-a800m --reduced --mesh data=2,model=2
"""
from __future__ import annotations

import argparse
import functools
import time

import torch
import torch.distributed as dist

from repro_torch.carry import check_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ARCHS, reduced
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.distributed.fault_tolerance import (
    AnomalyMonitor,
    agree_metrics,
    any_rank,
    run_with_recovery,
)
from repro_torch.distributed.sharding import (
    batch_specs,
    fit_tree,
    opt_state_specs,
    param_specs,
    shard_tree,
)
from repro_torch.launch.mesh import init_distributed, local_device
from repro_torch.models.transformer import ShardCtx, model_init
from repro_torch.optim.adamw import OptConfig, init_opt_state
from repro_torch.train.adaptive import MoECapacityController, parse_mesh_spec
from repro_torch.train.steps import train_step
from repro_torch.tree import paths

__all__ = ["main"]


def _has_moe(cfg) -> bool:
    return cfg.n_experts > 0 and "moe" in cfg.ffn_pattern


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true", help="smoke-size config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--state-dtype", choices=("f32", "int8"), default="f32")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", default="",
                    help="axis=size,... mesh spec (e.g. data=2,model=4) over every rank of "
                         "the process group; experts and vocabulary shard over 'model'")
    ap.add_argument("--plans", default="",
                    help="plan-cache path for learned MoE capacity factors "
                         "(default: $REPRO_SORT_PLANS via the process planner)")
    ap.add_argument("--moe-skew", type=float, default=0.0,
                    help="collapse every MoE router at this logit scale: "
                         "worst-case skew for capacity-loop demos/tests")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda: the card; cpu runs on the CPU)")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="process-group backend under --mesh (default: nccl on cuda, gloo on "
                         "cpu); nccl takes one rank a card, gloo lets ranks share one")
    args = ap.parse_args(argv)

    device = check_device(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced(cfg)
    mesh, owns_group = None, False
    if args.mesh:
        owns_group = not dist.is_initialized()
        init_distributed(args.dist_backend or ("nccl" if device.type == "cuda" else "gloo"),
                         device)
        device = check_device(local_device(device))
        if device.type == "cuda":
            torch.cuda.set_device(device)
        mesh, axes = parse_mesh_spec(args.mesh)
        ctx = ShardCtx(mesh=mesh, axes=axes)
    else:
        ctx = ShardCtx()
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model_init(gen, cfg, ep_shards=ctx.ep_shards, device=device)
    if args.moe_skew and _has_moe(cfg):
        from repro_torch.models.moe import collapse_router

        def skew(gp):
            return {**gp, "moe": collapse_router(gp["moe"], args.moe_skew)}

        params["blocks"] = {
            pos: skew(gp) if "moe" in gp else gp for pos, gp in params["blocks"].items()
        }
    n_params = sum(x.numel() for _, x in paths(params))
    say(f"arch={cfg.name} params={n_params/1e6:.2f}M steps={args.steps}")

    ocfg = OptConfig(
        peak_lr=args.lr,
        warmup_steps=max(2, args.steps // 10),
        total_steps=args.steps,
        state_dtype=args.state_dtype,
        compress_grads=args.compress_grads,
    )
    pspecs = ospecs = shardings = None
    if mesh is not None:
        # every rank drew the same params; each keeps its block of them
        pspecs = fit_tree(param_specs(params), params, mesh)
        params = shard_tree(params, pspecs, mesh)
    opt = init_opt_state(params, ocfg)
    if mesh is not None:
        ospecs = opt_state_specs(opt, pspecs)
        shardings = {"params": pspecs, "opt": ospecs, "pipeline": {"seed": (), "step": ()}}

    controller = planner = None
    if _has_moe(cfg):
        from repro_torch.engine.planner import Planner, default_planner

        planner = Planner(args.plans, device=device) if args.plans else default_planner()
        controller = MoECapacityController(
            cfg.moe_cfg(),
            tokens=args.batch * args.seq // args.microbatch,
            ctx=ctx,
            planner=planner,
            dtype=cfg.compute_dtype,
            device=device,
        )

    @functools.lru_cache(maxsize=None)
    def step_fn_for(moe_capacity):
        # one step function per learned capacity, as the reference keys its
        # executables; nothing is compiled, so a bump costs nothing
        return functools.partial(
            train_step,
            cfg=cfg,
            opt_cfg=ocfg,
            ctx=ctx,
            n_microbatch=args.microbatch,
            loss_chunk=min(64, args.seq),
            moe_capacity=moe_capacity,
            specs=pspecs,
        )

    pipe = SyntheticLM(cfg.vocab_size, args.batch, args.seq, seed=args.seed)
    data = {"it": Prefetcher(iter(pipe))}
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    state = {"params": params, "opt": opt}
    t0 = time.time()
    losses = []

    def one_step(i: int) -> dict:
        batch = {k: torch.from_numpy(v) for k, v in next(data["it"]).items()}
        if mesh is not None:  # every rank drew the global batch; it keeps its rows
            batch = shard_tree(batch, batch_specs(batch), mesh)
        batch = {k: v.to(device) for k, v in batch.items()}
        cap = controller.capacity if controller else None
        state["params"], state["opt"], m = step_fn_for(cap)(state["params"], state["opt"], batch)
        m = {k: float(v) if v.dim() == 0 else v for k, v in m.items()}
        if mesh is not None:  # every rank decides on rank 0's numbers
            m = agree_metrics(m, mesh.world, device)
        if controller:
            # between-step learning: fold this step's dropped/peak into the
            # planner so the next step's capacity covers the observed skew
            controller.observe(m, capacity=cap)
        losses.append(m["loss"])
        if (i + 1) % args.log_every == 0:
            dt = (time.time() - t0) / (i + 1)
            moe = (
                f" moe[cap {cap} drop {int(m['moe_dropped'])} "
                f"peak {int(m['moe_peak'])}]"
                if controller else ""
            )
            say(f"step {i+1:5d} loss {m['loss']:.4f} gnorm {m['grad_norm']:.3f} "
                  f"lr {m['lr']:.2e} {dt*1e3:.0f} ms/step{moe}")
        return m

    def save(i: int) -> None:
        if mgr:
            # i steps done = i batches consumed (the prefetch thread reads ahead)
            pipeline = {"seed": pipe.state.seed, "step": i}
            mgr.save(i, {**state, "pipeline": pipeline}, blocking=False, shardings=shardings,
                     mesh=mesh)

    def restore() -> int:
        if not mgr:
            return 0
        try:
            restored, s = mgr.restore({**state, "pipeline": pipe.checkpoint_state()},
                                      shardings=shardings, mesh=mesh)
        except FileNotFoundError:
            return 0  # crash before the first checkpoint: replay from step 0
        state["params"], state["opt"] = restored["params"], restored["opt"]
        data["it"].close()
        pipe.restore_state(restored["pipeline"])
        data["it"] = Prefetcher(iter(pipe))
        return s

    # fresh routers overflow until balanced; short demo runs shouldn't trip
    monitor = AnomalyMonitor(overflow_patience=max(200, args.steps))
    if planner is not None:
        # served MoE drops observed by the controller accrue into the
        # routing-collapse counter
        monitor.watch_exchange(planner.telemetry)

    try:
        summary = run_with_recovery(
            n_steps=args.steps,
            step_fn=one_step,
            save_fn=save,
            restore_fn=restore,
            checkpoint_every=args.ckpt_every,
            monitor=monitor,
            agree=None if mesh is None else any_rank(mesh.world, device),
        )
    finally:
        data["it"].close()
        if mgr:
            mgr.wait()
        if owns_group:
            dist.destroy_process_group()
    if controller is not None and planner.path:
        # debounced saves may have skipped the last in-memory move; make the
        # learned factor durable so serving warm-starts from this run
        planner.save()
    if controller is not None:
        say(f"moe: learned_cf={controller.factor:.2f} "
            f"capacity={controller.capacity} cell={controller.key}")
    say(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"({summary['restarts']} restarts)")
    return losses


if __name__ == "__main__":
    main()
