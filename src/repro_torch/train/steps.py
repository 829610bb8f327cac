"""Serving step functions (torch): prefill and one decode token.

Counterpart of the serving half of ``repro/train/steps.py``:

* ``prefill_step``: a full-sequence pass that fills the KV / SSM caches and
  returns the last position's logits only.
* ``serve_decode_step``: one token through the stack with caches.

The training half (``chunked_ce_loss``, ``loss_fn``, ``train_step``) waits
for the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.attention import KVCache, _blocked_local, _flash_causal, _project_qkv
from repro_torch.models.layers import linear, rmsnorm, unembed
from repro_torch.models.mamba2 import MambaCache, mamba_scan
from repro_torch.models.transformer import (
    ModelConfig,
    ShardCtx,
    _apply_ffn,
    _with_frontend,
    decode_step as model_decode_step,
    embed_tokens,
    group_params,
    stack_caches,
)

__all__ = ["prefill_step", "serve_decode_step"]


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
