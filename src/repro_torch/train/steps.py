"""Training and serving step functions (torch).

Counterpart of ``repro/train/steps.py``:

* ``train_step``: CE loss (sequence-chunked, so (tokens, V) logits never
  exist at once: one chunk's (B, c, V) float32 logits at a time, each
  chunk under ``torch.utils.checkpoint``), the MoE aux loss, gradients by
  ``torch.autograd.grad`` over the param leaves, optional microbatch
  accumulation in float32, and the AdamW update.
* ``prefill_step``: a full-sequence pass that fills the KV / SSM caches and
  returns the last position's logits only.
* ``serve_decode_step``: one token through the stack with caches.

The reference scans over layer groups under ``jax.checkpoint``; here the
stack is a loop over groups, each group under ``torch.utils.checkpoint``:
``cfg.remat_policy == "dots"`` saves the outputs of matrix products
(``aten.mm`` / ``bmm`` / ``addmm``) and recomputes the rest, ``"none"``
recomputes the whole group.

On a mesh (``ctx.mesh``) the steps run as explicit SPMD, one process a
rank.  ``train_step`` takes each rank's blocks of the params and the
optimizer state (``distributed.sharding``: ``specs`` are the params'
fitted specs) and this rank's rows of the batch.  Each layer group's
leaves are all-gathered to the compute layout inside the group's
checkpointed body, so the recompute gathers them again, and the gradients
come back to blocks by reduce-scatter (``sharding.gather_leaf``).  The
loss is vocab-parallel (each model rank's logits over its rows of the
table, the logsumexp combined by a max and a sum over "model", the gold
logit a second vocab-parallel lookup) and its mean covers every batch
row: sum and count are summed over the batch axes.  ``prefill_step`` and
``serve_decode_step`` take params in the compute layout
(``sharding.compute_specs``: heads, FFN hidden units and SSM heads split
over "model") and this rank's rows; their cache holds each rank's block
of every attention cache's positions (split-K) where its length divides
"model", and all of them where it does not, and its heads' Mamba state
and conv channels (with ``B`` / ``C`` whole).

A step reads nothing on the host: the dry-run (``launch/dryrun.py``)
traces these same functions on fake tensors.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.distributed.sharding import gather_tree, map_with_path
from repro_torch.exchange.group import copy_to, reduce_from
from repro_torch.models.attention import (KVCache, SplitKVCache, _pin_heads, _project_qkv, attend,
                                          kv_rows)
from repro_torch.models.layers import linear, rmsnorm
from repro_torch.models.mamba2 import MambaCache, mamba_scan
from repro_torch.models.transformer import (
    ModelConfig,
    ShardCtx,
    _apply_block,
    _apply_ffn,
    _with_frontend,
    decode_step as model_decode_step,
    embed_tokens,
    group_params,
    logits_of,
    stack_caches,
)
from repro_torch.optim.adamw import OptConfig, apply_updates
from repro_torch.tree import from_paths, paths

__all__ = [
    "chunked_ce_loss",
    "loss_fn",
    "train_step",
    "prefill_step",
    "serve_decode_step",
]


# ------------------------------------------------------------- chunked CE ---
def _ce_chunk(xb, yb, table, gold_table, vocab_size: int):
    """Summed CE and valid count of one (B, c) chunk; logits in float32."""
    # cast before the product: a bf16 product would round the logits first
    logits = torch.einsum("bcd,vd->bcv", xb.float(), table.to(xb.dtype).float())
    v_pad = table.shape[0]
    if v_pad != vocab_size:  # padding rows of the table never win
        keep = torch.arange(v_pad, device=logits.device) < vocab_size
        logits = torch.where(keep, logits, float("-inf"))
    lz = torch.logsumexp(logits, dim=-1)                      # (B, c)
    # the gold logit is a second embedding lookup, not a gather of logits
    gold_emb = F.embedding(torch.clamp(yb, min=0).long(), gold_table)
    gold = torch.sum(xb.float() * gold_emb.float(), dim=-1)
    valid = yb >= 0
    loss = torch.where(valid, lz - gold, 0.0)
    return loss.sum(), valid.sum().to(torch.int32)


def _ce_chunk_mesh(xb, yb, table, cfg: ModelConfig, ctx: ShardCtx):
    """``_ce_chunk`` with the table vocab-sharded over ``ctx.ep_axis``."""
    group = ctx.ep_group
    vloc = table.shape[0]
    logits = torch.einsum("bcd,vd->bcv", copy_to(group, xb).float(), table.to(xb.dtype).float())
    rows = group.rank * vloc + torch.arange(vloc, device=logits.device)
    if group.size * vloc != cfg.vocab_size:  # padding rows of the table never win
        logits = torch.where(rows < cfg.vocab_size, logits, float("-inf"))
    # the shift is a constant: the logsumexp's value and gradient do not move with it
    m = group.pmax(logits.detach().amax(dim=-1))
    lz = torch.log(reduce_from(group, torch.exp(logits - m[..., None]).sum(dim=-1))) + m
    gold_emb = embed_tokens({"table": table}, torch.clamp(yb, min=0), cfg, ctx)
    gold = torch.sum(xb.float() * gold_emb.float(), dim=-1)
    valid = yb >= 0
    loss = torch.where(valid, lz - gold, 0.0)
    return loss.sum(), valid.sum().to(torch.int32)


def chunked_ce_loss(
    x: torch.Tensor,            # (B, S, D) final hidden states (pre-unembed)
    p_embed: dict,              # {"table": (V, D)} tied embedding
    labels: torch.Tensor,       # (B, S) int32; -1 = masked
    cfg: ModelConfig,
    ctx: Optional[ShardCtx],
    *,
    chunk: int = 512,
) -> torch.Tensor:
    """Mean CE over the valid labels, the vocab projection run one sequence
    chunk at a time (the chunk is the largest divisor of S not above
    ``chunk``).  Each chunk is recomputed in the backward, so only one
    chunk's logits are ever held.  On a mesh the logits are vocab-parallel
    and the mean covers the rows of every rank (module docstring)."""
    B, S, D = x.shape
    c = min(chunk, S)
    while S % c:
        c -= 1
    table = p_embed["table"]
    mesh = ctx is not None and ctx.mesh is not None
    if mesh and ctx.ep_shards > 1:
        fn, args = _ce_chunk_mesh, (table, cfg, ctx)
    else:  # embed_tokens' lookup table for the gold logit
        fn, args = _ce_chunk, (table, table.to(cfg.compute_dtype), cfg.vocab_size)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int32, device=x.device)
    for i in range(S // c):
        sl = slice(i * c, (i + 1) * c)
        loss, n = checkpoint(fn, x[:, sl], labels[:, sl], *args, use_reentrant=False)
        tot, cnt = tot + loss, cnt + n
    rows = ctx.group(ctx.batch_axes) if mesh else None
    if rows is not None:  # each rank's gradient is that of its own rows' share
        tot, cnt = reduce_from(rows, tot), rows.psum(cnt)
    return tot / torch.clamp(cnt, min=1)


# the outputs "dots" remat keeps (the reference's checkpoint_dots_with_no_batch_dims:
# products with no batch dim, so not attention's scores); the rest is recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _group_body(cfg: ModelConfig, ctx: ShardCtx, moe_capacity, specs, x, gp, aux, ovf, drp, pk):
    if specs is not None:  # stored blocks -> the compute layout, again in the recompute
        gp = gather_tree(gp, specs, ctx.mesh, cfg, ep_axis=ctx.ep_axis)
    x = ctx.constrain_batch(x)
    stats = {"moe_aux": aux, "moe_overflow": ovf, "moe_dropped": drp, "moe_peak": pk}
    for i, (kind, ffn) in enumerate(zip(cfg.pattern, cfg.ffn_pattern)):
        x, stats = _apply_block(gp[f"pos{i}"], cfg, kind, ffn, x, ctx, stats,
                                moe_capacity=moe_capacity, moe_stats=True)
    return (x, stats["moe_aux"], stats["moe_overflow"],
            torch.as_tensor(stats["moe_dropped"]).to(torch.int32),
            torch.as_tensor(stats["moe_peak"]).to(torch.int32))


def _hidden_states(params, cfg: ModelConfig, tokens, frontend_embeds, ctx, remat,
                   moe_capacity=None, block_specs=None):
    """Run the stack up to the final norm: (hidden states, stats).

    The stats carry ``moe_dropped`` (tokens lost to capacity overflow,
    summed over layers) and ``moe_peak`` (the hottest per-(sender, expert)
    count, maxed over layers) beside ``moe_aux`` / ``moe_overflow``.
    ``moe_capacity`` overrides every MoE layer's capacity.  With
    ``block_specs`` (the stacked blocks' fitted specs on a mesh) each
    group's blocks are gathered inside its body.
    """
    x = _with_frontend(embed_tokens(params["embed"], tokens, cfg, ctx), frontend_embeds)
    device = x.device
    carry = (torch.zeros((), dtype=torch.float32, device=device),
             torch.zeros((), dtype=torch.bool, device=device),
             torch.zeros((), dtype=torch.int32, device=device),
             torch.zeros((), dtype=torch.int32, device=device))
    group_specs = None if block_specs is None else map_with_path(
        lambda _, spec: spec[1:], block_specs)  # one group's slice: no group axis
    body = functools.partial(_group_body, cfg, ctx, moe_capacity, group_specs)
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    for g in range(cfg.n_groups):
        gp = group_params(params["blocks"], g)
        if remat:
            x, *carry = checkpoint(body, x, gp, *carry, use_reentrant=False, **kw)
        else:
            x, *carry = body(x, gp, *carry)
    aux, ovf, drp, pk = carry
    x = rmsnorm(params["final_norm"], x)
    return x, {"moe_aux": aux / max(cfg.n_layers, 1), "moe_overflow": ovf,
               "moe_dropped": drp, "moe_peak": pk}


def loss_fn(
    params,
    cfg: ModelConfig,
    batch: dict,
    *,
    ctx: ShardCtx = ShardCtx(),
    aux_weight: float = 0.01,
    loss_chunk: int = 512,
    remat: bool = True,
    moe_capacity: Optional[int] = None,
    specs=None,
):
    """``(loss, {"ce", "moe_aux", "moe_overflow", "moe_dropped", "moe_peak"})``.

    On a mesh ``params`` are this rank's blocks under ``specs`` (their
    fitted specs) and ``batch`` this rank's rows; the loss and the stats
    are the whole batch's, the same on every rank."""
    block_specs = None
    if ctx.mesh is not None:
        if specs is None:
            raise ValueError("a mesh step takes the params' fitted specs (specs=)")
        params = {**{k: gather_tree(params[k], specs[k], ctx.mesh, cfg, ep_axis=ctx.ep_axis)
                     for k in params if k != "blocks"}, "blocks": params["blocks"]}
        block_specs = specs["blocks"]
    x, stats = _hidden_states(params, cfg, batch["tokens"], batch.get("frontend_embeds"), ctx,
                              remat, moe_capacity, block_specs)
    ce = chunked_ce_loss(x, params["embed"], batch["labels"], cfg, ctx, chunk=loss_chunk)
    loss = ce + aux_weight * stats["moe_aux"]
    return loss, {"ce": ce, **stats}


def train_step(
    params,
    opt_state,
    batch: dict,
    *,
    cfg: ModelConfig,
    opt_cfg: OptConfig,
    ctx: ShardCtx = ShardCtx(),
    n_microbatch: int = 1,
    loss_chunk: int = 512,
    remat: bool = True,
    moe_capacity: Optional[int] = None,
    specs=None,
):
    """One optimizer step, optionally accumulating over microbatches.

    Returns ``(new_params, new_opt_state, metrics)``; ``params`` and
    ``opt_state`` are not modified.  On a mesh they are this rank's blocks
    (``specs``: the params' fitted specs), the batch is this rank's rows,
    and the gradients arrive reduced to the blocks.  Gradients of several microbatches
    accumulate in float32, each divided by ``n_microbatch``; the metrics
    sum ``moe_dropped`` and max ``moe_peak`` over microbatches, and keep
    the last microbatch's value of every other stat.
    """
    pairs = list(paths(params))

    def grads_of(b):
        leaves = [leaf.detach().requires_grad_(True) for _, leaf in pairs]
        p = from_paths((path, leaf) for (path, _), leaf in zip(pairs, leaves))
        with torch.enable_grad():
            loss, stats = loss_fn(p, cfg, b, ctx=ctx, loss_chunk=loss_chunk, remat=remat,
                                  moe_capacity=moe_capacity, specs=specs)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(leaf) if g is None else g for leaf, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in stats.items()}, grads

    if n_microbatch == 1:
        loss, stats, grads = grads_of(batch)
    else:
        def split(leaf, i):
            size = leaf.shape[0] // n_microbatch
            return leaf[i * size:(i + 1) * size]

        loss = torch.zeros((), dtype=torch.float32, device=pairs[0][1].device)
        grads = [torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.device)
                 for _, leaf in pairs]
        per_micro = []
        for i in range(n_microbatch):
            mb_loss, mb_stats, mb_grads = grads_of({k: split(v, i) for k, v in batch.items()})
            loss = loss + mb_loss / n_microbatch
            grads = [a + g.float() / n_microbatch for a, g in zip(grads, mb_grads)]
            per_micro.append(mb_stats)
        reduce = {"moe_dropped": lambda s: torch.stack(s).sum().to(torch.int32),
                  "moe_peak": lambda s: torch.stack(s).max()}
        stats = {k: reduce[k]([s[k] for s in per_micro]) if k in reduce else per_micro[-1][k]
                 for k in per_micro[-1]}

    grad_tree = from_paths((path, g) for (path, _), g in zip(pairs, grads))
    new_params, new_opt, metrics = apply_updates(params, grad_tree, opt_state, opt_cfg,
                                                 specs=specs, mesh=ctx.mesh)
    return new_params, new_opt, {**metrics, "loss": loss, **stats}


# ---------------------------------------------------------------- serving ---
def _prefill_attention(p, cfg: ModelConfig, kind: str, h: torch.Tensor, cache_len: int,
                       ctx: ShardCtx, constrain=None):
    """One attention block over the prompt: (output, its KVCache).  On a
    mesh the heads split as in training and the cache holds every KV head,
    of this rank's block of positions where they split over "model"
    (``ShardCtx.seq_group``, a ``SplitKVCache``), else of all of them
    (``_cache_block``)."""
    B, S, _ = h.shape
    acfg = cfg.attn_cfg(kind)
    w = acfg.sliding_window
    ring = bool(w) and S > w
    size = w if ring else cache_len
    tp, seq = ctx.tp_heads(cfg), ctx.seq_group(size)
    x = h if tp is None else copy_to(tp.group, h)
    positions = torch.arange(S, device=h.device).expand(B, S)
    q, k, v = _pin_heads(*_project_qkv(p, acfg, x, positions, tp), constrain)
    out = linear(p["wo"], attend(q, k, v, acfg).reshape(B, S, -1))
    if tp is not None:
        out = reduce_from(tp.group, out)
    if tp is not None or seq is not None:
        kc, vc = _cache_block(p, acfg, x, size, ring, tp, seq)
    elif ring:
        # ring buffer filled in order: position S-w+j sits in slot (S+j) % w
        roll = (-(S % w)) % w
        kc = torch.roll(k[:, -w:], -roll, dims=1)
        vc = torch.roll(v[:, -w:], -roll, dims=1)
    else:
        pad = (0, 0, 0, 0, 0, cache_len - S)
        kc, vc = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    length = torch.tensor(S, dtype=torch.int32, device=h.device)
    return out, (KVCache if seq is None else SplitKVCache)(
        kc.to(cfg.compute_dtype), vc.to(cfg.compute_dtype), length)


def _cache_block(p, acfg, x: torch.Tensor, size: int, ring: bool, tp, seq):
    """This rank's block of a prefilled cache's ``size`` slots (all of
    them where ``seq`` is ``None``), every KV head: the one-device layout
    (the prompt padded to ``size``, or a local layer's ``ring`` of its
    window) cut over ``seq``; each slot's K/V projected from the prompt
    row it holds, zeros where it holds none."""
    B, S, _ = x.shape
    w = acfg.sliding_window
    rank, n = (0, 1) if seq is None else (seq.rank, seq.size)
    local = size // n
    slots = range(rank * local, (rank + 1) * local)
    if ring:  # slot s holds the position of the window congruent to it (mod w)
        rows = [S - w + (s + (-(S % w)) % w) % w for s in slots]
    else:
        rows = [min(s, S - 1) for s in slots]
    idx = torch.tensor(rows, device=x.device)
    k, v = kv_rows(p, acfg, x[:, idx], idx.expand(B, local), tp)
    held = torch.tensor([ring or s < S for s in slots], device=x.device)[None, :, None, None]
    zero = torch.zeros((), dtype=k.dtype, device=x.device)
    return torch.where(held, k, zero), torch.where(held, v, zero)


def prefill_step(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,                      # (B, S)
    *,
    ctx: ShardCtx = ShardCtx(),
    frontend_embeds: Optional[torch.Tensor] = None,
    cache_len: Optional[int] = None,
):
    """Fill the caches for the whole prompt; return (last_logits (B, V), cache).

    Global attention caches hold ``cache_len`` positions (the prompt, then
    zeros); local layers hold their window as a ring buffer; Mamba layers
    keep the last ``conv_kernel - 1`` conv inputs and the final SSM state.
    On a mesh each rank keeps its block of every attention cache's
    positions where they divide ``ctx.ep_axis``, else all of them, and its
    heads' part of every Mamba cache (``ShardCtx.mamba_group``).
    """
    B, S = tokens.shape
    cache_len = cache_len or S
    x = _with_frontend(embed_tokens(params["embed"], tokens, cfg, ctx), frontend_embeds)
    pin = ctx.constrain_spec if ctx.mesh is not None else None
    attn_pin = pin if (pin and cfg.n_heads % ctx.ep_shards) else None  # as _apply_block
    per_group = []
    for g in range(cfg.n_groups):
        gp = group_params(params["blocks"], g)
        new_cache = {}
        for i, (kind, ffn) in enumerate(zip(cfg.pattern, cfg.ffn_pattern)):
            p = gp[f"pos{i}"]
            h = rmsnorm(p["norm1"], x)
            if kind.startswith("attn"):
                out, new_cache[f"pos{i}"] = _prefill_attention(p["attn"], cfg, kind, h, cache_len,
                                                               ctx, attn_pin)
            else:
                mcfg = cfg.mamba_cfg()
                out, xbc, h_last = mamba_scan(p["mamba"], mcfg, h, pin, ctx.mamba_group(cfg))
                new_cache[f"pos{i}"] = MambaCache(
                    conv=xbc[:, S - (mcfg.conv_kernel - 1):, :].to(cfg.compute_dtype),
                    ssm=h_last,
                )
            x = x + out
            if ffn is not None:
                x, _ = _apply_ffn(p, cfg, x, ctx, {})
        per_group.append(new_cache)
    x_last = rmsnorm(params["final_norm"], x[:, -1:])
    logits = logits_of(params["embed"], x_last, cfg, ctx)[:, 0]
    return logits, stack_caches(per_group)


def serve_decode_step(params, cfg: ModelConfig, tokens, cache, *, ctx: ShardCtx = ShardCtx()):
    """One decode token for the whole batch; returns (logits (B, 1, V), cache)."""
    return model_decode_step(params, cfg, tokens, cache, ctx=ctx)
