"""MoE token dispatch is the paper's model D, on the PyTorch/CUDA port.

Shows, on a group of ranks, that expert routing through the exchange layer
(``repro_torch.exchange.partition_exchange`` / ``combine_exchange``, the
two calls ``core/cluster_sort.py`` sorts with) (a) sends every token to
its expert's rank and back in arrival order, (b) sorts (key, payload)
records across the ranks stably (``engine.sort_kv`` / ``argsort``), and
(c) closes the adaptive capacity loop: a skewed router pays its overflow
retry once, then serves at the learned expert capacity factor.

    PYTHONPATH=src python examples/torch_moe_routing_demo.py              # NCCL, a rank a card
    PYTHONPATH=src python examples/torch_moe_routing_demo.py --device cpu # 4 gloo ranks
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

from torch_ranks import default_ranks, run_ranks


def demo(rank, world, device, n):
    from repro_torch.engine import Planner, argsort, sort_kv
    from repro_torch.exchange import AxisGroup, combine_exchange, partition_exchange
    from repro_torch.models.moe import (MoEConfig, collapse_router, moe_apply_adaptive,
                                        moe_apply_ep_replicated, moe_init, moe_plan_key)

    group = AxisGroup()
    rng = np.random.default_rng(0)
    say = print if rank == 0 else (lambda *a: None)

    # --- raw dispatch: tokens keyed by expert id, one all_to_all each way ---
    E, T, D = 4, 16 * world, 8
    expert_of = torch.from_numpy(rng.integers(0, E, T).astype(np.int32))
    tokens = torch.arange(T * D, dtype=torch.float32).reshape(T, D)
    mine = slice(rank * (T // world), (rank + 1) * (T // world))
    keys, vals = expert_of[mine].to(device), tokens[mine].to(device)
    ex = partition_exchange(keys, vals, keys, group, capacity=T, n_buckets=E)
    # this rank now holds every token routed to its experts, grouped stably;
    # "process" = tag with this rank's id, then send everything back
    back = combine_exchange(ex.recv_values + group.rank * 1000.0, ex, group).cpu()
    assert ((back[:, 0] // 1000).long() == keys.cpu().long() * world // E).all()
    assert torch.equal(back % 1000, vals.cpu() % 1000)
    say("dispatch: every token visited exactly its expert's rank and returned  OK")

    # --- record sort: the engine sorts (key, payload) pairs across the ranks ---
    rec_keys = rng.integers(0, 1000, n).astype(np.int32)
    rec_payload = rng.standard_normal((n, 8)).astype(np.float32)
    m = n // world
    shard = slice(rank * m, (rank + 1) * m)
    order = np.argsort(rec_keys, kind="stable")
    sk, sv = sort_kv(torch.from_numpy(rec_keys[shard]).to(device),
                     {"tok": torch.from_numpy(rec_payload[shard]).to(device)}, mesh=group)
    idx = argsort(torch.from_numpy(rec_keys[shard]).to(device), mesh=group)
    counts = group.all_gather(torch.tensor([sk.shape[0]], device=device)).cpu().numpy().ravel()
    start = int(counts[:rank].sum())
    want = order[start:start + sk.shape[0]]
    assert (sk.cpu().numpy() == rec_keys[want]).all()
    assert (sv["tok"].cpu().numpy() == rec_payload[want]).all()
    assert (idx.cpu().numpy() == want).all()
    say("engine: distributed sort_kv / argsort == np.argsort(stable) reference  OK")

    # --- a full MoE layer (one device) --------------------------------------
    cfg = MoEConfig(d_model=16, d_ff=8, n_experts=4, top_k=2, capacity_factor=8.0)
    p = moe_init(torch.Generator(device=device).manual_seed(0), cfg, torch.float32, ep_shards=1,
                 device=device)
    x = torch.randn(32, 16, generator=torch.Generator(device=device).manual_seed(1), device=device)
    y, aux, overflow = moe_apply_ep_replicated(p, cfg, x)
    assert bool(torch.isfinite(y).all()) and not bool(overflow)
    say(f"MoE layer: aux_loss={float(aux):.3f} overflow={bool(overflow)} "
        f"out_norm={float(y.norm()):.2f}  OK")

    # --- adaptive capacity learning over the same layer ----------------------
    # a router collapsed onto a few hot experts and a lean capacity factor:
    # the first adaptive call overflows, retries and teaches the planner a
    # factor for this (n_experts, top_k, token-bucket) cell; the second call
    # (and, through the plan file, a restarted process) pays nothing
    acfg = cfg._replace(capacity_factor=1.0)
    skewed = collapse_router(p, 8.0)
    planner = Planner(device=device)  # in memory; give it a path to persist
    cell = moe_plan_key(x.shape[0], acfg, x.dtype, device=device)
    y1, _, counts = moe_apply_adaptive(skewed, acfg, x, planner=planner)
    first = planner.telemetry.last(cell)
    y2, _, _ = moe_apply_adaptive(skewed, acfg, x, planner=planner)
    assert first.retries > 0 and planner.telemetry.last(cell).retries == 0
    assert torch.allclose(y1, y2)
    say(f"adaptive: skewed router paid {first.retries} retrie(s) once, learned "
        f"cf={planner.capacity_factor_for(cell, default=acfg.capacity_factor):.2f} "
        f"(counts={counts.cpu().tolist()}), steady state pays zero  OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (NCCL, a rank a card) or cpu (gloo)")
    ap.add_argument("--ranks", type=int, default=None, help="default: every card, or 4 on the CPU")
    ap.add_argument("--n", type=int, default=4096, help="records in the distributed sort")
    args = ap.parse_args()
    run_ranks(demo, args.ranks or default_ranks(args.device, 4), args.device, args.n)
