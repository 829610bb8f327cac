"""Body functions the port's multihost harness runs inside every rank process.

The port's counterparts of ``tests/multihost/bodies.py``.  Each body takes a
``MultihostContext`` (rank, nprocs, args, the gloo ``AxisGroup``, the
device, shard/allgather helpers) and returns a JSON-serializable report
with the reference body's fields, where the port has them.  Bodies are
deterministic functions of ``ctx.args``: every rank builds the same host
data from the shared seed, and the same body on one rank
(``_torch_multihost.run_single``) gives the same sorted output.

Fingerprints name ranks (``cpu/ranks=P/procsPx1``) where the reference's
name mesh axes and per-host devices (``cpu/x=P``, ``.../procs2x2``): each
rank of the port is a process with one device.

``args["device"]`` is where the body works (``"cpu"`` by default);
``args["local_impl"]`` picks the mesh sorts' local sort (``"xla"`` by
default, ``"kernel"`` on the card, whose launches the sort bodies report).
The MoE bodies take the reference's params from ``args["params_npz"]``
(flat ``a/b/c`` keys), since the reference draws them from ``jax.random``.

Loaded by file path in ``_torch_multihost_worker.py``: torch is imported
inside the bodies.
"""
from __future__ import annotations

import hashlib
import os
import time

# sorted outputs above this many keys are reported by hash only
_LIST_MAX = 1 << 16


def _sha(arr) -> str:
    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _local_impl(ctx) -> dict:
    return {"local_impl": ctx.args.get("local_impl", "xla")}


def _launch_counts() -> dict:
    """The kernels' launch counts of this process (zero on CPU tensors,
    which run the plain versions)."""
    from repro_torch.kernels.bitonic_sort import bitonic_sort as kernels

    return kernels.launch_counts()


def _reset_launches() -> None:
    from repro_torch.kernels.bitonic_sort import bitonic_sort as kernels

    kernels.reset_launch_counts()


def _synced_seconds(ctx, fn):
    """(result, host seconds of ``fn``, ending in a synchronize of the card)."""
    import torch

    def sync():
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)

    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def _npz_tree(path: str) -> dict:
    """A flat ``a/b/c`` npz as a nested dict of numpy arrays."""
    import numpy as np

    tree: dict = {}
    with np.load(path) as z:
        for k in z.files:
            node = tree
            *head, leaf = k.split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[leaf] = z[k]
    return tree


# ----------------------------------------------------------- cluster sort ---
def cluster_sort_body(ctx):
    """Model-D cluster_sort across every rank; returns the sorted output.

    Asserts it against ``torch.sort`` of the whole input in-process; the
    coordinator asserts bit-identity across ranks, against the one-rank run
    and against the reference body's output.
    """
    import numpy as np
    import torch

    from repro_torch.core.cluster_sort import cluster_sort
    from repro_torch.engine.planner import mesh_fingerprint, parse_plan_key, plan_key

    a = ctx.args
    n, seed, mode = a.get("n", 256), a.get("seed", 0), a.get("mode", "splitters")
    hi = 1 << 20
    rng = np.random.default_rng(seed)
    x_np = rng.integers(0, hi, size=n).astype(np.int32)
    x = ctx.shard(x_np)
    kwargs = {"mode": mode, **_local_impl(ctx)}
    if mode == "range":
        kwargs.update(lo=0, hi=hi)
    _reset_launches()
    (slab, valid), seconds = _synced_seconds(ctx, lambda: cluster_sort(x, ctx.group, **kwargs))
    launches = _launch_counts()
    got = ctx.allgather(slab)[ctx.allgather(valid)]
    want = torch.sort(torch.from_numpy(x_np).to(ctx.device)).values.cpu().numpy()
    assert np.array_equal(got, want), "cluster_sort output wrong"

    # the fingerprint round-trips through plan keys on this topology
    fp = mesh_fingerprint(ctx.group, device=ctx.device)
    key = plan_key(n, torch.int32, ctx.group, device=ctx.device)
    bucket, dtype_name, parsed_fp = parse_plan_key(key)
    assert (dtype_name, parsed_fp) == ("int32", fp) and bucket >= n
    out = {
        "processes": ctx.nprocs,
        "local_devices": 1,
        "devices": ctx.nprocs,
        "mesh_fp": fp,
        "local_fp": mesh_fingerprint(None, device=ctx.device),
        "plan_key": key,
        "sorted_sha": _sha(got),
        "launches": launches,
        "seconds": seconds,
    }
    if n <= _LIST_MAX:
        out["sorted"] = got.tolist()
    return out


def cluster_sort_kv_body(ctx):
    """Stable key-value cluster sort: payloads ride the exchange exactly."""
    import numpy as np
    import torch

    from repro_torch.engine.kv import cluster_sort_kv

    a = ctx.args
    n, seed = a.get("n", 256), a.get("seed", 0)
    rng = np.random.default_rng(seed)
    # few distinct keys -> heavy duplicates, so stability does real work
    k_np = rng.integers(0, 32, size=n).astype(np.int32)
    idx_np = np.arange(n, dtype=np.int32)
    w_np = rng.standard_normal(n).astype(np.float32)
    keys = ctx.shard(k_np)
    values = {"idx": ctx.shard(idx_np), "w": ctx.shard(w_np)}
    _reset_launches()
    (slab_k, slab_v, valid), seconds = _synced_seconds(
        ctx, lambda: cluster_sort_kv(keys, values, ctx.group, **_local_impl(ctx)))
    launches = _launch_counts()
    valid_g = ctx.allgather(valid)
    got_k = ctx.allgather(slab_k)[valid_g]
    got_idx = ctx.allgather(slab_v["idx"])[valid_g]
    got_w = ctx.allgather(slab_v["w"])[valid_g]

    order = torch.argsort(torch.from_numpy(k_np).to(ctx.device), stable=True).cpu().numpy()
    assert np.array_equal(got_k, k_np[order]), "keys not sorted"
    assert np.array_equal(got_idx, order.astype(np.int32)), "not stable"
    assert np.array_equal(got_w, w_np[order]), "payload misaligned"
    out = {
        "sorted_keys_sha": _sha(got_k),
        "idx_sha": _sha(got_idx),
        "w_sha": _sha(got_w),
        "launches": launches,
        "seconds": seconds,
    }
    if n <= _LIST_MAX:
        out.update(sorted_keys=got_k.tolist(), idx=got_idx.tolist())
    return out


# -------------------------------------------------------------- wire layer ---
def exchange_roundtrip_body(ctx):
    """partition_exchange -> combine_exchange round trip, plain and int8 wire."""
    import numpy as np

    from repro_torch.exchange import combine_exchange, partition_exchange

    a = ctx.args
    seed, d = a.get("seed", 0), a.get("d", 4)
    P_ = ctx.nprocs
    m = a.get("m", 32)                      # per-shard elements
    n = m * P_
    rng = np.random.default_rng(seed)
    k_np = rng.integers(0, P_, size=n).astype(np.int32)   # bucket == dest shard
    v_np = rng.standard_normal((n, d)).astype(np.float32)
    i_np = np.arange(n, dtype=np.int32)
    keys, vals, ids = ctx.shard(k_np), ctx.shard(v_np), ctx.shard(i_np)

    def roundtrip(compress):
        ex = partition_exchange(keys, {"v": vals, "i": ids}, keys, ctx.group, capacity=m,
                                compress=compress)
        back = combine_exchange(ex.recv_values, ex, ctx.group)
        return ctx.allgather(back["v"]), ctx.allgather(back["i"]), bool(ex.overflow)

    bv, bi, ovf = roundtrip(False)
    assert not ovf
    assert np.array_equal(bv, v_np), "uncompressed payload must round-trip exactly"
    assert np.array_equal(bi, i_np)

    qv, qi, qovf = roundtrip(True)                        # the int8 wire
    assert not qovf
    assert np.array_equal(qi, i_np), "integer leaves must never be quantized"
    # int8 + per-row scale: bounded relative error, bit-exact determinism
    scale = np.maximum(np.abs(v_np).max(axis=-1, keepdims=True) / 127.0, 1e-12)
    assert np.all(np.abs(qv - v_np) <= 0.5 * scale + 1e-6), "int8 wire error bound"
    return {"plain_sha": _sha(bv), "int8_sha": _sha(qv), "ids_sha": _sha(qi)}


# ---------------------------------------------------------------- MoE layer ---
def moe_adaptive_body(ctx):
    """moe_apply_adaptive learning expert capacity into a *shared* plan file.

    Every rank runs the replicated adaptive MoE forward on the same skewed
    tokens (the reference's params and tokens, ``args["params_npz"]``:
    ``router/w``, ``w_in``, ``w_out`` and ``x``) with a planner backed by
    the same ``plans_path``: the concurrent-writer case the fcntl-locked
    merge-save exists for.
    """
    from repro_torch.carry import params_from_reference
    from repro_torch.engine.planner import Planner
    from repro_torch.models.moe import (
        MoEConfig,
        collapse_router,
        moe_apply_adaptive,
        moe_plan_key,
    )

    a = ctx.args
    planner = Planner(a["plans_path"], learned_scope=a.get("scope", "global"), device=ctx.device)
    cfg = MoEConfig(
        d_model=8, d_ff=16, n_experts=4, top_k=2, capacity_factor=1.0,
        mlp_gated=False,
    )
    tree = params_from_reference(_npz_tree(a["params_npz"]), ctx.device)
    x = tree.pop("x")
    p = collapse_router(tree)                  # worst-case routing skew
    y, aux, counts = moe_apply_adaptive(p, cfg, x, planner=planner)
    planner.save()
    key = moe_plan_key(x.shape[0], cfg, x.dtype, device=ctx.device)
    factor = planner.capacity_factor_for(key, default=cfg.capacity_factor)
    assert factor > cfg.capacity_factor, "skew must have raised the factor"
    y_np = y.cpu().numpy()
    return {
        "y_sha": _sha(y_np),
        "y": y_np.tolist(),
        "counts": [int(c) for c in counts],
        "plan_key": key,
        "scoped_key": planner.scoped_key(key),
        "learned_factor": factor,
        "learned_keys": sorted(planner.learned),
    }


# ----------------------------------------------------- concurrent learning ---
def sort_learn_body(ctx):
    """Skewed model-D sort with the full capacity-learning loop active,
    persisting into one shared plan-cache file from every rank at once."""
    import numpy as np
    import torch

    from repro_torch.core.cluster_sort import cluster_sort
    from repro_torch.engine.planner import Planner, plan_key

    a = ctx.args
    planner = Planner(a["plans_path"], learned_scope=a.get("scope", "global"), device=ctx.device)
    n, seed = a.get("n", 256), a.get("seed", 0)
    hi = 1 << 20
    rng = np.random.default_rng(seed)
    # every key in the bottom 1/64 of the range: range-mode bucket 0 is hot
    x_np = rng.integers(0, hi // 64, size=n).astype(np.int32)
    x = ctx.shard(x_np)
    # mode= is passed explicitly below, so hint it to cluster_kwargs: a
    # skew-promoted cell must not inject a second "mode" key into kwargs
    kwargs = planner.cluster_kwargs(n, torch.int32, ctx.group, mode="range")
    slab, valid = cluster_sort(x, ctx.group, mode="range", lo=0, hi=hi, **kwargs,
                               **_local_impl(ctx))
    got = ctx.allgather(slab)[ctx.allgather(valid)]
    assert np.array_equal(got, np.sort(x_np))
    planner.save()
    key = plan_key(n, torch.int32, ctx.group, device=ctx.device)
    return {
        "plan_key": key,
        "scoped_key": planner.scoped_key(key),
        "learned_factor": planner.capacity_factor_for(key),
        "learned_keys": sorted(planner.learned),
    }


def skew_promotion_body(ctx):
    """The radix->sample auto-promotion loop across real ranks.

    Every rank serves the same persistently skewed (Zipfian) keys through
    the planner's capacity-learning loop against one shared plan-cache file:
    the cell starts on the radix partition, accrues skew strikes, latches to
    the sample partition, and a fresh planner over the same file (the
    simulated restart) comes back already promoted.  Returns the per-step
    (mode, partition, retries, ratio, promoted, strikes) trace.
    """
    import numpy as np
    import torch

    from repro_torch.core.cluster_sort import cluster_sort
    from repro_torch.engine.adapt import CapacityLearner
    from repro_torch.engine.planner import Planner, plan_key

    a = ctx.args
    scope = a.get("scope", "global")
    planner = Planner(a["plans_path"], learned_scope=scope, device=ctx.device)
    # a 2-rank group has only 2 buckets, so peak/mean tops out at exactly 2.0:
    # small topologies lower the threshold (an operator knob)
    if "promote_ratio" in a:
        planner.learner = CapacityLearner(promote_ratio=a["promote_ratio"])
    n, seed, steps = a.get("n", 256), a.get("seed", 0), a.get("steps", 5)
    rng = np.random.default_rng(seed)
    x_np = np.minimum(rng.zipf(1.5, n), 1 << 30).astype(np.int32)
    x = ctx.shard(x_np)
    key = plan_key(n, torch.int32, ctx.group, device=ctx.device)
    want = np.sort(x_np)

    trace = []
    for _ in range(steps):
        kwargs = planner.cluster_kwargs(n, torch.int32, ctx.group, default=2.0)
        # un-promoted: no "mode" key -> the radix family; promoted: "sample"
        mode = kwargs.pop("mode", "radix")
        slab, valid = cluster_sort(x, ctx.group, mode=mode, **kwargs, **_local_impl(ctx))
        got = ctx.allgather(slab)[ctx.allgather(valid)]
        assert np.array_equal(got, want), f"{mode}-mode sort output wrong"
        obs = planner.telemetry.last(planner.scoped_key(key))
        part, strikes = planner.promotion_state(key)
        trace.append(
            {
                "mode": mode,
                "partition": obs.partition,
                "retries": int(obs.retries),
                "ratio": round(planner.telemetry.last_ratio(planner.scoped_key(key)), 4),
                "promoted": part,
                "strikes": strikes,
            }
        )
    planner.save()

    # simulated restart: a fresh planner over the shared locked plan cache
    # comes back promoted, and its serving path injects the sample mode
    p2 = Planner(a["plans_path"], learned_scope=scope, device=ctx.device)
    part2, strikes2 = p2.promotion_state(key)
    return {
        "trace": trace,
        "restart_partition": part2,
        "restart_strikes": strikes2,
        "restart_mode": p2.cluster_kwargs(n, torch.int32, ctx.group, default=2.0).get("mode"),
        "sorted": got.tolist(),
    }


# ------------------------------------------------- expert-parallel training ---
def moe_train_step_body(ctx):
    """The between-step MoE capacity loop on a (data=2, model=2) mesh of four
    ranks.

    ``train_step`` for a tiny skewed MoE LM (the reference's params,
    router collapsed, from ``args["params_npz"]``), with the
    ``MoECapacityController`` reading and writing a shared plan-cache file.
    Parameter updates are discarded between steps, so the routing, and with
    it the integer dropped/peak trace and the learned factor, is a function
    of ``ctx.args`` alone.  Float loss is only checked finite.
    """
    import math
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.carry import shard_from_reference
    from repro_torch.configs.base import ARCHS
    from repro_torch.distributed.sharding import fit_tree, param_specs
    from repro_torch.engine.planner import Planner
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.transformer import ShardCtx
    from repro_torch.optim.adamw import OptConfig, init_opt_state
    from repro_torch.train.adaptive import MoECapacityController
    from repro_torch.train.steps import train_step

    a = ctx.args
    steps = a.get("steps", 2)
    cfg = replace(
        ARCHS["qwen3-0.6b"], name="moe-mh-tiny",
        n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=64, kv_chunk=16,
        pattern=("attn",), ffn_pattern=("moe",),
        n_experts=8, top_k=2, capacity_factor=1.0,
        param_dtype=torch.float32, compute_dtype=torch.float32,
    )
    mesh = Mesh((2, 2), ("data", "model"))
    tctx = ShardCtx(mesh=mesh, axes=mesh.axis_names)

    full = _npz_tree(a["params_npz"])
    specs = fit_tree(param_specs(full), full, mesh)
    params = shard_from_reference(full, specs, mesh, ctx.device)
    ocfg = OptConfig(peak_lr=1e-4, warmup_steps=2, total_steps=max(steps, 2))
    opt = init_opt_state(params, ocfg)

    planner = Planner(a["plans_path"], learned_scope=a.get("scope", "global"), device=ctx.device)
    batch_sz, seq = 4, 16                 # T = 64 tokens over 4 ranks
    ctl = MoECapacityController(
        cfg.moe_cfg(), tokens=batch_sz * seq, ctx=tctx,
        planner=planner, dtype=cfg.compute_dtype, device=ctx.device,
    )

    rng = np.random.default_rng(a.get("seed", 0))
    rows = batch_sz // mesh.shape["data"]
    mine = slice(mesh.coords["data"] * rows, (mesh.coords["data"] + 1) * rows)
    trace = []
    losses_finite = True
    for _ in range(steps):
        tok = rng.integers(1, cfg.vocab_size, (batch_sz, seq + 1)).astype(np.int32)
        tok = torch.from_numpy(tok[mine]).to(ctx.device)
        batch = {"tokens": tok[:, :-1].contiguous(), "labels": tok[:, 1:].contiguous()}
        cap = ctl.capacity
        _, _, m = train_step(params, opt, batch, cfg=cfg, opt_cfg=ocfg, ctx=tctx,
                             n_microbatch=1, loss_chunk=seq, moe_capacity=cap, specs=specs)
        m = {k: float(v) for k, v in m.items()}  # updates discarded (see docstring)
        ctl.observe(m, capacity=cap)
        trace.append(
            {"cap": cap, "dropped": int(m["moe_dropped"]), "peak": int(m["moe_peak"])}
        )
        losses_finite = losses_finite and math.isfinite(m["loss"])
    planner.save()

    factor = ctl.factor
    assert factor > cfg.moe_cfg().capacity_factor, "skew must raise the factor"
    return {
        "processes": ctx.nprocs,
        "plan_key": ctl.key,
        "scoped_key": planner.scoped_key(ctl.key),
        "learned_factor": factor,
        "trace": trace,
        "losses_finite": losses_finite,
    }


# -------------------------------------------------- distributed autotune ---
def _autotune_candidates():
    """The explicit candidate list the autotune bodies sweep: one member of
    each strategy family, small enough for a 2-rank sweep in a test."""
    from repro_torch.engine.planner import SortPlan

    return [
        SortPlan("shared", local_impl="xla"),
        SortPlan("shared", local_impl="merge"),
        SortPlan("cluster", local_impl="xla", capacity_factor=2.0, mode="splitters"),
        SortPlan("cluster", local_impl="xla", capacity_factor=2.0, mode="sample"),
    ]


def autotune_body(ctx):
    """Rank-coordinated ``Planner.autotune`` over the whole group.

    Every rank sweeps the same candidate list against one shared plan-cache
    file; every rank must end up holding the same winning plan (rank 0's),
    the same plan table, and - after the post-save barrier - a file whose
    tuned cell matches.  ``ctx.maybe_fault`` hooks each candidate boundary,
    so the same body is the fault-injection battery (crash/hang mid-sweep).
    """
    import torch

    from repro_torch.engine.planner import Planner, mesh_fingerprint, plan_key

    a = ctx.args
    n, reps = a.get("n", 256), a.get("reps", 3)
    planner = Planner(a["plans_path"], device=ctx.device)

    def on_candidate(i, cand):
        ctx.maybe_fault(f"candidate:{i}")

    best = planner.autotune(
        n,
        torch.int32,
        mesh=ctx.group,
        reps=reps,
        candidates=_autotune_candidates(),
        on_candidate=on_candidate,
    )
    key = plan_key(n, torch.int32, ctx.group, device=ctx.device)
    # every rank re-reads the shared file the post-save barrier guarantees
    # is on disk; its tuned cell must be what this rank holds in memory
    ondisk = Planner(a["plans_path"], device=ctx.device).plans.get(key)
    assert ondisk == best, f"disk {ondisk} != broadcast winner {best}"
    return {
        "processes": ctx.nprocs,
        "mesh_fp": mesh_fingerprint(ctx.group, device=ctx.device),
        "plan_key": key,
        "best": best.to_dict(),
        "plans": {k: p.to_dict() for k, p in sorted(planner.plans.items())},
        "wrote": planner.last_autotune_wrote,
    }


def autotune_local_body(ctx):
    """Two *uncoordinated* autotuners racing one shared plan cache.

    Each rank opts out of the coordinated sweep (``distributed=False``: its
    cells are rank-divergent, so collectives would deadlock) and tunes a
    rank-specific size bucket into the same file.  The fcntl-locked
    merge-on-save must union the tables.
    """
    import torch

    from repro_torch.engine.planner import Planner, SortPlan, plan_key

    a = ctx.args
    n = a.get("base_n", 64) << ctx.rank  # rank-distinct size buckets
    planner = Planner(a["plans_path"], device=ctx.device)
    cands = [
        SortPlan("shared", local_impl="xla"),
        SortPlan("shared", local_impl="merge"),
    ]
    best = planner.autotune(
        n, torch.int32, reps=a.get("reps", 2), distributed=False, candidates=cands
    )
    key = plan_key(n, torch.int32, device=ctx.device)
    return {
        "plan_key": key,
        "best": best.to_dict(),
        "wrote": planner.last_autotune_wrote,
        "file_keys": sorted(Planner(a["plans_path"], device=ctx.device).plans),
    }


def gloo_timing_body(ctx):
    """Time model B (shared) and model D (cluster) on this job's group.

    Run on several ranks and on one, the two reports say what the gloo wire
    costs: the shared row is local compute, the cluster row pays the
    exchange.  The planner's own helpers time it: median of reps, max over
    ranks, the number a coordinated autotune sweep would score.
    """
    import numpy as np
    import torch

    from repro_torch.engine import planner as planner_mod
    from repro_torch.engine.planner import SortPlan

    a = ctx.args
    n, reps, seed = a.get("n", 4096), a.get("reps", 3), a.get("seed", 0)
    rng = np.random.default_rng(seed)
    x_np = rng.integers(0, 1 << 20, size=n).astype(np.int32)
    plans = {
        "shared": (SortPlan("shared", local_impl="xla"), torch.from_numpy(x_np).to(ctx.device)),
        "cluster": (
            SortPlan("cluster", local_impl="xla", capacity_factor=2.0, mode="sample"),
            ctx.shard(x_np),
        ),
    }
    out = {}
    for name, (plan, arr) in sorted(plans.items()):
        times = planner_mod._time_plan_reps(plan, arr, ctx.group, None, reps=reps)
        us = planner_mod._median(times)
        out[name] = planner_mod._max_over_ranks(ctx.group, us) if ctx.nprocs > 1 else us
    out["devices"] = ctx.nprocs
    return out


# --------------------------------------------------------- failure injection ---
def crash_body(ctx):
    """The victim rank dies hard mid-test; survivors sit in a long wait.

    Exercises the harness's crash containment: the coordinator must fail the
    run promptly (victim rc != 0) and terminate the survivors.
    """
    victim = ctx.args.get("victim", 1)
    if ctx.rank == victim:
        os._exit(17)  # no report, no cleanup: as close to a segfault as python gets
    time.sleep(120)
    return {"survived": True}


def hang_body(ctx):
    """Every rank wedges; only the run timeout can end this test."""
    time.sleep(600)
    return {"finished": True}
