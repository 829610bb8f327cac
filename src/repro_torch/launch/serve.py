"""Batched serving driver (torch): prefill a prompt batch, decode N tokens.

Counterpart of ``repro/launch/serve.py``, every flag the same, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain versions of the
kernels).  Greedy or temperature sampling over the logits.  The decode
loop's top-k is the sort engine's stable descending argsort
(``repro_torch.engine.topk``).

``--topk-queue`` routes each row's top-k through the async micro-batching
queue (``repro_torch.engine.AsyncSortService``): every row is a request of
its own and the queue coalesces them into one batched call a step.
``--adaptive`` (implies ``--topk-queue``) lets a ``DelayController`` move
the flush window with the arrival rate; ``--stats`` prints the service's
ledger.  ``--tenants web:3:0,batch:1:1`` routes the rows through the
multi-tenant SLO frontend instead (``SortFrontend``), round-robin over the
named tenants, each row stamped with the ``--slo-ms`` deadline; ``--warmup``
builds the vocab-size argsort cells of the batch ladder before traffic.
The service plans each row length with the default planner, so
``$REPRO_SORT_PLANS`` pins its plans (a ``'kernel'`` plan puts the top-k on
the CUDA kernels).

``--moe`` serves MoE expert routing through the adaptive exchange instead
of decoding: a skewed (``--moe-skew``) router dispatches ``--batch x
--prompt-len`` tokens a step with ``moe_apply_adaptive``, which runs at the
planner's learned capacity factor, retries over drops, and feeds the
telemetry ``--stats`` prints.

Usage:
  python -m repro_torch.launch.serve --arch qwen3-0.6b --reduced --batch 4 \\
      --prompt-len 32 --gen 16 [--topk-queue] [--adaptive] [--stats]
  python -m repro_torch.launch.serve --moe --batch 4 --prompt-len 64 --gen 8 \\
      --experts 8 --moe-skew 6.0 --stats
  python -m repro_torch.launch.serve --reduced --batch 4 --gen 8 \\
      --tenants web:3:0,batch:1:1 --warmup --slo-ms 50 --stats
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.carry import check_device
from repro_torch.configs.base import ARCHS, reduced
from repro_torch.engine import topk
from repro_torch.models.transformer import ShardCtx, model_init
from repro_torch.train.steps import prefill_step, serve_decode_step

__all__ = ["sample_next", "run_moe_serving", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sample_next(logits: torch.Tensor, gen: torch.Generator, *, temperature: float, top_k: int,
                queue=None, frontend=None, tenants=(), ticket_log=None) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 token ids.  Greedy (``temperature <= 0``)
    takes the lowest index of each row's maximum; otherwise a draw from
    ``gen`` over the softmax of the top-k logits, top-k by the engine's
    stable argsort (ties to the lowest index, as ``lax.top_k``).

    With ``queue=`` (an ``AsyncSortService``) each row becomes one
    ``submit_async(kind='argsort', ascending=False)`` request, coalesced
    into one batched call a step; with ``frontend=`` (a ``SortFrontend``)
    rows go round-robin over ``tenants``, and the tickets land in
    ``ticket_log``.  Both routes hand the service the rows as numpy arrays.
    """
    device = logits.device
    if frontend is not None or queue is not None:
        rows = logits.float().cpu().numpy()
        if frontend is not None:
            futs = [frontend.submit(tenants[i % len(tenants)], r, kind="argsort", ascending=False)
                    for i, r in enumerate(rows)]
            if ticket_log is not None:
                ticket_log.extend(futs)
        else:
            futs = [queue.submit_async(r, kind="argsort", ascending=False) for r in rows]
        order = np.stack([np.asarray(f.result())[:top_k] for f in futs])
        idx = torch.from_numpy(order.astype(np.int32)).to(device)
        if temperature <= 0:
            return idx[:, 0]
        vals = torch.take_along_dim(logits.float(), idx.long(), dim=1)
    else:
        if temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        vals, idx = topk(logits, top_k)
    probs = torch.softmax(vals / temperature, dim=-1)
    choice = torch.multinomial(torch.clamp(probs, min=1e-20), 1, generator=gen)
    return torch.take_along_dim(idx.long(), choice, dim=1)[:, 0].to(torch.int32)


def run_moe_serving(args, device: torch.device):
    """--moe: serve expert routing through the adaptive exchange engine.

    Every step dispatches one token batch with ``moe_apply_adaptive``
    through the process-wide planner, so the expert capacity factor is
    learned (and, with $REPRO_SORT_PLANS, persisted).  A skewed router pays
    its overflow retry on the first step and none after.
    """
    from repro_torch.engine.planner import default_planner
    from repro_torch.models.moe import (
        MoEConfig,
        collapse_router,
        moe_apply_adaptive,
        moe_init,
        moe_plan_key,
    )

    cfg = MoEConfig(d_model=64, d_ff=32, n_experts=args.experts, top_k=args.moe_top_k)
    planner = default_planner()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    p = moe_init(gen, cfg, torch.float32, ep_shards=1, device=device)
    if args.moe_skew:
        # worst-case skew, so the capacity loop has something to learn
        p = collapse_router(p, args.moe_skew)

    T = args.batch * args.prompt_len
    key = moe_plan_key(T, cfg, torch.float32, device=device)
    rng = np.random.default_rng(args.seed)
    led = planner.telemetry
    # the default planner's ledger is process-wide: report this run's deltas
    base = {name: getattr(led, name) for name in (
        "calls", "total_dropped", "total_dropped_averted", "overflow_events",
        "total_retries", "total_recompiles")}
    retries0 = base["total_retries"]

    t_start = time.time()
    y = None
    first_retries = 0
    t_warm = dt = 0.0
    for step in range(args.gen):
        x = torch.from_numpy(rng.standard_normal((T, cfg.d_model)).astype(np.float32)).to(device)
        y, aux, counts = moe_apply_adaptive(p, cfg, x, planner=planner)
        if step == 0:
            _sync(device)
            first_retries = led.total_retries - retries0
            t_warm = time.time() - t_start
            t0 = time.time()
    _sync(device)
    if args.gen > 1:
        dt = time.time() - t0
    steady_steps = max(args.gen - 1, 1)

    cf = planner.capacity_factor_for(key, default=cfg.capacity_factor)
    steady = (
        f"steady {dt / steady_steps * 1e3:.2f} ms/step "
        f"({T * (args.gen - 1) / max(dt, 1e-9):.0f} tokens/s)"
        if args.gen > 1 else "steady n/a (needs --gen >= 2)"
    )
    print(f"moe-serve: experts={cfg.n_experts} top_k={cfg.top_k} "
          f"tokens/step={T} steps={args.gen}")
    print(f"moe-serve: warmup {t_warm * 1e3:.1f} ms "
          f"(retries={first_retries}); {steady} learned_cf={cf:.2f}")
    if args.stats:
        d = {name: getattr(led, name) - v for name, v in base.items()}
        # routing is the same every step, so the last observation's
        # required factor is this run's peak requirement
        last = led.last(key)
        rf = last.required_factor() if d["calls"] and last else 0.0
        print(f"moe-stats: calls={d['calls']} "
              f"dropped={d['total_dropped']} "
              f"dropped_averted={d['total_dropped_averted']} "
              f"overflows={d['overflow_events']} "
              f"retries={d['total_retries']} "
              f"recompiles={d['total_recompiles']} "
              f"required_factor={rf:.2f}")
    late = led.total_retries - retries0 - first_retries
    if late:
        print(f"moe-serve: note — {late} post-warmup retrie(s) "
              f"(skew exceeded the learned margin; factor re-learned)")
    return y


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--topk-queue", action="store_true",
                    help="route per-row top-k through the AsyncSortService "
                         "micro-batching queue")
    ap.add_argument("--adaptive", action="store_true",
                    help="adapt the queue's flush window to the arrival rate "
                         "(DelayController; implies --topk-queue)")
    ap.add_argument("--min-delay-ms", type=float, default=0.1,
                    help="lower bound of the adaptive flush window")
    ap.add_argument("--stats", action="store_true",
                    help="print the full service ledger at exit (implies "
                         "--topk-queue: the ledger lives on the sort service)")
    ap.add_argument("--moe", action="store_true",
                    help="serve MoE expert routing through the adaptive "
                         "exchange engine instead of decoding")
    ap.add_argument("--experts", type=int, default=8, help="expert count for --moe serving")
    ap.add_argument("--moe-top-k", type=int, default=2, help="router top-k for --moe serving")
    ap.add_argument("--moe-skew", type=float, default=6.0,
                    help="router logit bias onto a hot expert subset (0 = "
                         "uniform routing, nothing for the loop to learn)")
    ap.add_argument("--tenants", default="",
                    help="serve the top-k path through the multi-tenant SLO "
                         "frontend; comma-separated name[:weight[:priority]] "
                         "specs, decode rows assigned round-robin")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-request deadline for --tenants rows; late rows "
                         "are still answered and counted as SLO misses")
    ap.add_argument("--warmup", action="store_true",
                    help="build the serving sort cells (vocab-size argsort "
                         "across the batch ladder) before traffic")
    ap.add_argument("--device", default="cuda",
                    help="where the model and the top-k run (cuda raises "
                         "without a card; cpu runs the kernels' plain versions)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    device = check_device(args.device)

    if args.moe:
        return run_moe_serving(args, device)

    frontend = None
    fe_tenants: list = []
    fe_tickets: list = []
    qsvc = None
    if args.tenants:
        from repro_torch.engine import SortFrontend, Tenant

        specs = []
        for spec in args.tenants.split(","):
            parts = spec.split(":")
            specs.append(Tenant(
                parts[0],
                weight=float(parts[1]) if len(parts) > 1 else 1.0,
                priority=int(parts[2]) if len(parts) > 2 else 0,
                slo_ms=args.slo_ms,
            ))
        # shed_expired=False: a decode row must produce a token, so late
        # rows are served and the miss is counted instead
        frontend = SortFrontend(tenants=specs, max_batch=args.batch, shed_expired=False,
                                start=True, device=device)
        fe_tenants = [t.name for t in specs]
    elif args.topk_queue or args.adaptive or args.stats:
        from repro_torch.engine import AsyncSortService

        qsvc = AsyncSortService(
            max_batch=args.batch,
            max_delay_ms=2.0,
            min_delay_ms=args.min_delay_ms if args.adaptive else None,
            device=device,
        )

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced(cfg)

    if args.warmup:
        # build every cell the decode loop's top-k can touch: a descending
        # float32 argsort of one vocab row at every pow2 batch bucket up to
        # --batch (partial flushes make partial batches)
        from repro_torch.engine.frontend import warmup as engine_warmup

        svc = frontend.service if frontend is not None else (
            qsvc.service if qsvc is not None else None
        )
        if svc is None:
            from repro_torch.engine import AsyncSortService

            qsvc = AsyncSortService(max_batch=args.batch, max_delay_ms=2.0, device=device)
            svc = qsvc.service
        rep = engine_warmup(svc, cells=[(cfg.vocab_size, "float32")], kinds=("argsort",),
                            ascending=(False,), max_batch=args.batch, device=device)
        print(rep.summary())

    ctx = ShardCtx()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model_init(gen, cfg, ep_shards=ctx.ep_shards, device=device)
    sample_gen = torch.Generator(device=device).manual_seed(args.seed)

    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(args.batch, args.prompt_len)).astype(np.int32)
    ).to(device)
    fe = None
    if cfg.frontend != "none":
        fe = torch.from_numpy(
            rng.standard_normal((args.batch, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
        ).to(device=device, dtype=cfg.compute_dtype)

    _sync(device)
    t0 = time.time()
    cache_len = args.prompt_len + args.gen
    logits, cache = prefill_step(params, cfg, prompts, ctx=ctx, frontend_embeds=fe,
                                 cache_len=cache_len)
    _sync(device)
    t_prefill = time.time() - t0

    route = dict(temperature=args.temperature, top_k=args.top_k, queue=qsvc, frontend=frontend,
                 tenants=fe_tenants, ticket_log=fe_tickets)
    out_tokens = [sample_next(logits, sample_gen, **route)]
    t0 = time.time()
    for _ in range(args.gen - 1):
        lg, cache = serve_decode_step(params, cfg, out_tokens[-1][:, None], cache, ctx=ctx)
        out_tokens.append(sample_next(lg[:, 0], sample_gen, **route))
    _sync(device)
    t_decode = time.time() - t0

    gen_ids = torch.stack(out_tokens, dim=1).cpu().numpy()
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} gen={args.gen}")
    print(f"prefill {t_prefill*1e3:.1f} ms; decode {t_decode/max(args.gen-1,1)*1e3:.2f} ms/tok")
    print("sampled token ids (first row):", gen_ids[0][:16].tolist())
    if frontend is not None:
        frontend.close()
        st = frontend.stats
        served = " ".join(f"{k}={v}" for k, v in sorted(st.tenant_served.items()))
        misses = sum(1 for t in fe_tickets if not t.slo_met)
        print(f"frontend: tenants[{served}] batches={st.batches} "
              f"fill={st.fill_ratio():.2f} compiles={st.compiles} "
              f"slo_misses={misses}/{len(fe_tickets)} "
              f"shed={st.shed_total()}")
        if args.stats:
            pct = st.latency_percentiles()
            print(f"frontend-stats: requests={st.requests} "
                  f"keys_in={st.keys_in} cache_hits={st.cache_hits} "
                  f"queue p50={pct[50]*1e3:.2f} ms p99={pct[99]*1e3:.2f} ms "
                  f"throughput={st.throughput_keys_per_s():.0f} keys/s")
    if qsvc is not None:
        qsvc.close()
        qs = qsvc.stats
        pct = qs.latency_percentiles()
        print(f"sort-queue: batches={qs.coalesced_batches} "
              f"fill={qs.fill_ratio():.2f} compiles={qs.compiles} "
              f"queue p50={pct[50]*1e3:.2f} ms p99={pct[99]*1e3:.2f} ms")
        if qsvc.delay is not None:
            print(f"adaptive-delay: window={qsvc.delay.delay_ms:.3f} ms "
                  f"(bounds [{qsvc.delay.min_delay_s*1e3:.3f}, "
                  f"{qsvc.delay.max_delay_s*1e3:.3f}]) "
                  f"shrinks={qsvc.delay.shrinks} grows={qsvc.delay.grows} "
                  f"arrival_rate={qsvc.delay.arrival_rate():.1f}/s")
        if args.stats:
            print(f"service-stats: requests={qs.requests} batches={qs.batches} "
                  f"keys_in={qs.keys_in} compiles={qs.compiles} "
                  f"cache_hits={qs.cache_hits} "
                  f"overflow_retries={qs.overflow_retries} "
                  f"recompiles={qs.recompiles} "
                  f"peak_mean_ratio={qs.peak_mean_ratio:.2f} "
                  f"throughput={qs.throughput_keys_per_s():.0f} keys/s")
    if gen_ids.min() < 0 or gen_ids.max() >= cfg.vocab_size:
        raise RuntimeError("a sampled token lies in the vocabulary's padding")
    return gen_ids


if __name__ == "__main__":
    main()
