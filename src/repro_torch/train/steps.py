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

from repro_torch.models.attention import KVCache, _blocked_local, _flash_causal, _project_qkv
from repro_torch.models.layers import linear, rmsnorm, unembed
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
    chunk's logits are ever held."""
    if ctx is not None:
        ctx.single_device("the vocab-parallel loss")
    B, S, D = x.shape
    c = min(chunk, S)
    while S % c:
        c -= 1
    table = p_embed["table"]
    gold_table = table.to(cfg.compute_dtype)  # embed_tokens' lookup table
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int32, device=x.device)
    for i in range(S // c):
        sl = slice(i * c, (i + 1) * c)
        loss, n = checkpoint(_ce_chunk, x[:, sl], labels[:, sl], table, gold_table,
                             cfg.vocab_size, use_reentrant=False)
        tot, cnt = tot + loss, cnt + n
    return tot / torch.clamp(cnt, min=1)


# the outputs "dots" remat keeps; everything else is recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _group_body(cfg: ModelConfig, ctx: ShardCtx, moe_capacity, x, gp, aux, ovf, drp, pk):
    stats = {"moe_aux": aux, "moe_overflow": ovf, "moe_dropped": drp, "moe_peak": pk}
    for i, (kind, ffn) in enumerate(zip(cfg.pattern, cfg.ffn_pattern)):
        x, stats = _apply_block(gp[f"pos{i}"], cfg, kind, ffn, x, ctx, stats,
                                moe_capacity=moe_capacity, moe_stats=True)
    return (x, stats["moe_aux"], stats["moe_overflow"],
            torch.as_tensor(stats["moe_dropped"]).to(torch.int32),
            torch.as_tensor(stats["moe_peak"]).to(torch.int32))


def _hidden_states(params, cfg: ModelConfig, tokens, frontend_embeds, ctx, remat,
                   moe_capacity=None):
    """Run the stack up to the final norm: (hidden states, stats).

    The stats carry ``moe_dropped`` (tokens lost to capacity overflow,
    summed over layers) and ``moe_peak`` (the hottest per-(sender, expert)
    count, maxed over layers) beside ``moe_aux`` / ``moe_overflow``.
    ``moe_capacity`` overrides every MoE layer's capacity.
    """
    x = _with_frontend(embed_tokens(params["embed"], tokens, cfg, ctx), frontend_embeds)
    device = x.device
    carry = (torch.zeros((), dtype=torch.float32, device=device),
             torch.zeros((), dtype=torch.bool, device=device),
             torch.zeros((), dtype=torch.int32, device=device),
             torch.zeros((), dtype=torch.int32, device=device))
    body = functools.partial(_group_body, cfg, ctx, moe_capacity)
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
):
    """``(loss, {"ce", "moe_aux", "moe_overflow", "moe_dropped", "moe_peak"})``."""
    x, stats = _hidden_states(params, cfg, batch["tokens"], batch.get("frontend_embeds"), ctx,
                              remat, moe_capacity)
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
):
    """One optimizer step, optionally accumulating over microbatches.

    Returns ``(new_params, new_opt_state, metrics)``; ``params`` and
    ``opt_state`` are not modified.  Gradients of several microbatches
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
                                  moe_capacity=moe_capacity)
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
    new_params, new_opt, metrics = apply_updates(params, grad_tree, opt_state, opt_cfg)
    return new_params, new_opt, {**metrics, "loss": loss, **stats}


# ---------------------------------------------------------------- serving ---
def _prefill_attention(p, cfg: ModelConfig, kind: str, h: torch.Tensor, cache_len: int):
    """One attention block over the prompt: (output, its KVCache)."""
    B, S, _ = h.shape
    acfg = cfg.attn_cfg(kind)
    positions = torch.arange(S, device=h.device).expand(B, S)
    q, k, v = _project_qkv(p, acfg, h, positions)
    if acfg.sliding_window and S > acfg.sliding_window:
        out = _blocked_local(q, k, v, acfg)
        w = acfg.sliding_window
        # ring buffer filled in order: position S-w+j sits in slot (S+j) % w
        roll = (-(S % w)) % w
        kc = torch.roll(k[:, -w:], -roll, dims=1)
        vc = torch.roll(v[:, -w:], -roll, dims=1)
    else:
        out = _flash_causal(q, k, v, acfg)
        pad = (0, 0, 0, 0, 0, cache_len - S)
        kc, vc = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    length = torch.tensor(S, dtype=torch.int32, device=h.device)
    cache = KVCache(kc.to(cfg.compute_dtype), vc.to(cfg.compute_dtype), length)
    return linear(p["wo"], out.reshape(B, S, -1)), cache


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
    """
    B, S = tokens.shape
    cache_len = cache_len or S
    x = _with_frontend(embed_tokens(params["embed"], tokens, cfg, ctx), frontend_embeds)
    per_group = []
    for g in range(cfg.n_groups):
        gp = group_params(params["blocks"], g)
        new_cache = {}
        for i, (kind, ffn) in enumerate(zip(cfg.pattern, cfg.ffn_pattern)):
            p = gp[f"pos{i}"]
            h = rmsnorm(p["norm1"], x)
            if kind.startswith("attn"):
                out, new_cache[f"pos{i}"] = _prefill_attention(p["attn"], cfg, kind, h, cache_len)
            else:
                mcfg = cfg.mamba_cfg()
                out, xbc, h_last = mamba_scan(p["mamba"], mcfg, h)
                new_cache[f"pos{i}"] = MambaCache(
                    conv=xbc[:, S - (mcfg.conv_kernel - 1):, :].to(cfg.compute_dtype),
                    ssm=h_last,
                )
            x = x + out
            if ffn is not None:
                x, _ = _apply_ffn(p, cfg, x, ctx, {})
        per_group.append(new_cache)
    x_last = rmsnorm(params["final_norm"], x[:, -1:])
    logits = unembed(params["embed"], x_last, cfg.vocab_size)[:, 0]
    return logits, stack_caches(per_group)


def serve_decode_step(params, cfg: ModelConfig, tokens, cache, *, ctx: ShardCtx = ShardCtx()):
    """One decode token for the whole batch; returns (logits (B, 1, V), cache)."""
    return model_decode_step(params, cfg, tokens, cache, ctx=ctx)
