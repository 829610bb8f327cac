"""Config-driven decoder stack (torch): dense / MoE / SSM / hybrid, one code path.

Counterpart of ``repro/models/transformer.py``.  ``cfg.pattern`` is a period
of block kinds (e.g. ``("attn_l",) * 5 + ("attn",)`` for gemma3,
``("attn",) + ("mamba",) * 7`` for jamba) and block params are stacked with
a leading ``n_layers / len(pattern)`` group axis, the reference's layout, so
carrying weights across is a tree map.  The stack is a Python loop over that
axis; the training step (``repro_torch.train.steps``) runs its backward
through the same blocks, with remat per group where the reference scans.

Block kinds:
  attn    full causal attention (+ MoE or dense FFN)
  attn_l  sliding-window local attention
  mamba   Mamba-2 SSD
Every block is pre-norm residual: x += Block(RMSNorm(x)); FFN likewise.

``ShardCtx`` names a process group for the model's mesh branches (the
vocab-parallel embedding and the expert-parallel FFN).  Those branches are
not ported yet: a ``ShardCtx`` with a group raises ``NotImplementedError``
rather than running on one device.  ``model_init`` and ``init_cache`` place
their tensors on ``device``, the card by default.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
from torch.utils._pytree import tree_map

from repro_torch.carry import check_device

from .attention import (
    AttnConfig,
    attention_decode,
    attention_train,
    attn_init,
    init_kv_cache,
)
from .layers import Params, embed, embed_init, mlp, mlp_init, rmsnorm, rmsnorm_init, unembed
from .mamba2 import (
    MambaConfig,
    init_mamba_cache,
    mamba_decode,
    mamba_init,
    mamba_train,
)
from .moe import MoEConfig, moe_apply_ep_replicated, moe_init

__all__ = [
    "ModelConfig",
    "ShardCtx",
    "embed_tokens",
    "padded_vocab",
    "model_init",
    "forward",
    "init_cache",
    "decode_step",
    "group_params",
    "stack_caches",
]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # layer pattern (period); "attn" | "attn_l" | "mamba"
    pattern: Tuple[str, ...] = ("attn",)
    # which positions in the period carry an FFN ("dense" | "moe" | None)
    ffn_pattern: Tuple[Optional[str], ...] = ("dense",)
    mlp_gated: bool = True
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_theta_local: float = 10_000.0
    sliding_window: int = 0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 2.0
    compress_dispatch: bool = False   # int8 MoE all_to_all payloads
    # SSM
    ssm_state: int = 128
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # modality frontend stub ("none" | "vision" | "audio")
    frontend: str = "none"
    n_frontend_tokens: int = 0
    # numerics
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    kv_chunk: int = 1024
    # the reference's remat policy for its training step, kept so configs match
    remat_policy: str = "dots"
    notes: str = ""

    @property
    def n_groups(self) -> int:
        if self.n_layers % len(self.pattern):
            raise ValueError(f"{self.n_layers} layers do not split into periods {self.pattern}")
        return self.n_layers // len(self.pattern)

    def attn_cfg(self, kind: str) -> AttnConfig:
        local = kind == "attn_l"
        return AttnConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim,
            qkv_bias=self.qkv_bias,
            qk_norm=self.qk_norm,
            rope_theta=self.rope_theta_local if local else self.rope_theta,
            sliding_window=self.sliding_window if local else 0,
            kv_chunk=self.kv_chunk,
        )

    def mamba_cfg(self) -> MambaConfig:
        return MambaConfig(
            d_model=self.d_model,
            d_state=self.ssm_state,
            head_dim=self.ssm_head_dim,
            chunk=self.ssm_chunk,
        )

    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(
            d_model=self.d_model,
            d_ff=self.d_ff,
            n_experts=self.n_experts,
            top_k=self.top_k,
            capacity_factor=self.capacity_factor,
            mlp_gated=self.mlp_gated,
            compress_dispatch=self.compress_dispatch,
        )

    def _params(self, experts: int) -> int:
        """Embedding plus stacked blocks, with ``experts`` experts counted
        in each MoE FFN."""
        D, F = self.d_model, self.d_ff
        per_period = 0
        for kind, ffn in zip(self.pattern, self.ffn_pattern):
            if kind.startswith("attn"):
                per_period += D * self.head_dim * (self.n_heads + 2 * self.n_kv_heads)
                per_period += self.n_heads * self.head_dim * D
            else:
                mc = self.mamba_cfg()
                per_period += D * (2 * mc.d_inner + 2 * mc.n_groups * mc.d_state + mc.n_heads)
                per_period += mc.d_inner * D + mc.conv_kernel * mc.conv_dim
            if ffn == "dense":
                per_period += D * F * (3 if self.mlp_gated else 2)
            elif ffn == "moe":
                per_period += experts * D * F * (3 if self.mlp_gated else 2)
                per_period += D * self.n_experts
        return self.vocab_size * D + per_period * self.n_groups

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + stacked blocks)."""
        return self._params(self.n_experts)

    def active_param_count(self) -> int:
        """Per-token active params (MoE counts top_k experts only)."""
        return self._params(self.top_k)


@dataclass(frozen=True)
class ShardCtx:
    """How the model parallelizes.  ``group=None``: one device."""
    group: Any = None

    @property
    def ep_shards(self) -> int:
        return 1 if self.group is None else self.group.size

    def single_device(self, what: str) -> None:
        """Raise for a mesh branch that is not ported yet."""
        if self.group is not None:
            raise NotImplementedError(
                f"{what} on a process group is not ported yet (ROADMAP Queue 1 item 9b, "
                "the mesh branches of the model stack); "
                "pass ShardCtx() to run on one device"
            )


def embed_tokens(p_embed: Params, tokens: torch.Tensor, cfg: ModelConfig,
                 ctx: Optional[ShardCtx]) -> torch.Tensor:
    """Token embedding lookup (the vocab-parallel form under a group waits)."""
    if ctx is not None:
        ctx.single_device("the vocab-parallel embedding")
    return embed(p_embed, tokens, cfg.compute_dtype)


# ------------------------------------------------------------------ init ---
def _block_init(gen, cfg: ModelConfig, kind: str, ffn: Optional[str], ep_shards: int,
                device) -> Params:
    dt = cfg.param_dtype
    p: Params = {"norm1": rmsnorm_init(cfg.d_model, dt, device)}
    if kind.startswith("attn"):
        p["attn"] = attn_init(gen, cfg.attn_cfg(kind), dt, device)
    else:
        p["mamba"] = mamba_init(gen, cfg.mamba_cfg(), dt, device)
    if ffn is not None:
        p["norm2"] = rmsnorm_init(cfg.d_model, dt, device)
        if ffn == "dense":
            p["ffn"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dt, gated=cfg.mlp_gated, device=device)
        else:
            p["moe"] = moe_init(gen, cfg.moe_cfg(), dt, ep_shards=ep_shards, device=device)
    return p


def padded_vocab(cfg: ModelConfig, ep_shards: int) -> int:
    """Vocab rows padded to the EP-shard multiple (vocab-parallel table)."""
    return math.ceil(cfg.vocab_size / ep_shards) * ep_shards


def _stack(trees: list):
    """A list of equal-structure param trees as one tree of stacked tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def model_init(gen: torch.Generator, cfg: ModelConfig, *, ep_shards: int = 1,
               device="cuda") -> Params:
    """Random parameter tree from ``gen`` on ``device``; block params
    stacked over the group axis.  The draws are not the reference's: parity
    tests carry its params across instead."""
    device = check_device(device)
    groups = []
    for _ in range(cfg.n_groups):
        groups.append({
            f"pos{i}": _block_init(gen, cfg, kind, ffn, ep_shards, device)
            for i, (kind, ffn) in enumerate(zip(cfg.pattern, cfg.ffn_pattern))
        })
    blocks = _stack(groups)
    del groups  # free the per-group copies before the embedding is drawn
    return {
        "embed": embed_init(gen, padded_vocab(cfg, ep_shards), cfg.d_model, cfg.param_dtype,
                            device),
        "blocks": blocks,
        "final_norm": rmsnorm_init(cfg.d_model, cfg.param_dtype, device),
    }


def group_params(blocks, g: int):
    """Group ``g``'s slice of stacked block params (or caches)."""
    return tree_map(lambda t: t[g], blocks)


# --------------------------------------------------------------- forward ---
def _apply_ffn(p: Params, cfg: ModelConfig, x: torch.Tensor, ctx: ShardCtx, stats: dict, *,
               moe_capacity: Optional[int] = None, moe_stats: bool = False):
    """Pre-norm FFN residual; an MoE FFN adds its aux loss and overflow flag
    to ``stats``.  ``moe_capacity`` overrides the per-(sender, expert) token
    capacity (the train loop's capacity controller passes the learned
    value); ``moe_stats=True`` adds ``moe_dropped`` (summed over layers) and
    ``moe_peak`` (maxed over layers), what the between-step learner and
    ``AnomalyMonitor`` read.  The expert-parallel branches under a group
    wait for the mesh slice."""
    h = rmsnorm(p["norm2"], x)
    if "ffn" in p:
        return x + mlp(p["ffn"], h), stats
    ctx.single_device("the expert-parallel MoE FFN")
    B, S, D = h.shape
    res = moe_apply_ep_replicated(p["moe"], cfg.moe_cfg(), h.reshape(B * S, D),
                                  capacity=moe_capacity, with_stats=moe_stats)
    if moe_stats:
        y, aux, dropped, _, peak, overflow = res
    else:
        y, aux, overflow = res
    stats = dict(stats)
    stats["moe_aux"] = stats.get("moe_aux", 0.0) + aux
    stats["moe_overflow"] = torch.logical_or(
        torch.as_tensor(stats.get("moe_overflow", False), device=overflow.device), overflow
    )
    if moe_stats:
        prev_peak = torch.as_tensor(stats.get("moe_peak", 0), dtype=peak.dtype, device=peak.device)
        stats["moe_dropped"] = stats.get("moe_dropped", 0) + dropped
        stats["moe_peak"] = torch.maximum(prev_peak, peak)
    return x + y.reshape(B, S, D), stats


def _apply_block(p: Params, cfg: ModelConfig, kind: str, ffn, x, ctx, stats, *,
                 moe_capacity: Optional[int] = None, moe_stats: bool = False):
    h = rmsnorm(p["norm1"], x)
    if kind.startswith("attn"):
        x = x + attention_train(p["attn"], cfg.attn_cfg(kind), h)
    else:
        x = x + mamba_train(p["mamba"], cfg.mamba_cfg(), h)
    if ffn is not None:
        x, stats = _apply_ffn(p, cfg, x, ctx, stats, moe_capacity=moe_capacity,
                              moe_stats=moe_stats)
    return x, stats


def _with_frontend(x: torch.Tensor, frontend_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """The first F positions replaced by the modality frontend's embeddings."""
    if frontend_embeds is None:
        return x
    F = frontend_embeds.shape[1]
    return torch.cat([frontend_embeds.to(x.dtype), x[:, F:]], dim=1)


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    ctx: ShardCtx = ShardCtx(),
    frontend_embeds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, dict]:
    """tokens (B, S) -> (logits (B, S, V) float32, stats).  Full-sequence pass."""
    x = _with_frontend(embed_tokens(params["embed"], tokens, cfg, ctx), frontend_embeds)
    stats = {"moe_aux": torch.zeros((), dtype=torch.float32, device=x.device),
             "moe_overflow": torch.zeros((), dtype=torch.bool, device=x.device)}
    for g in range(cfg.n_groups):
        gp = group_params(params["blocks"], g)
        for i, (kind, ffn) in enumerate(zip(cfg.pattern, cfg.ffn_pattern)):
            x, stats = _apply_block(gp[f"pos{i}"], cfg, kind, ffn, x, ctx, stats)
    x = rmsnorm(params["final_norm"], x)
    logits = unembed(params["embed"], x, cfg.vocab_size)
    return logits, {"moe_aux": stats["moe_aux"] / max(cfg.n_layers, 1),
                    "moe_overflow": stats["moe_overflow"]}


# ---------------------------------------------------------------- decode ---
def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Per-group stacked caches on ``device``: each leaf has a leading
    ``n_groups`` axis."""
    device = check_device(device)

    def one(kind: str):
        if kind.startswith("attn"):
            c = init_kv_cache(cfg.attn_cfg(kind), batch, max_len, cfg.compute_dtype, device)
        else:
            c = init_mamba_cache(cfg.mamba_cfg(), batch, cfg.compute_dtype, device)
        return type(c)(*(t.expand((cfg.n_groups,) + t.shape).clone() for t in c))

    return {f"pos{i}": one(kind) for i, kind in enumerate(cfg.pattern)}


def stack_caches(per_group: list) -> dict:
    """Per-group cache dicts as one dict of stacked caches."""
    return {
        name: type(c)(*(torch.stack(ts) for ts in zip(*(pg[name] for pg in per_group))))
        for name, c in per_group[0].items()
    }


def decode_step(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,     # (B, 1) next-token ids
    cache,
    *,
    ctx: ShardCtx = ShardCtx(),
):
    """One decode step through the whole stack.  Returns (logits (B, 1, V),
    new_cache); the cache passed in is not modified."""
    x = embed_tokens(params["embed"], tokens, cfg, ctx)
    new_groups = []
    for g in range(cfg.n_groups):
        gp = group_params(params["blocks"], g)
        gcache = {name: type(c)(*(t[g] for t in c)) for name, c in cache.items()}
        new_gcache = {}
        for i, (kind, ffn) in enumerate(zip(cfg.pattern, cfg.ffn_pattern)):
            p = gp[f"pos{i}"]
            h = rmsnorm(p["norm1"], x)
            if kind.startswith("attn"):
                out, nc = attention_decode(p["attn"], cfg.attn_cfg(kind), h, gcache[f"pos{i}"])
            else:
                out, nc = mamba_decode(p["mamba"], cfg.mamba_cfg(), h, gcache[f"pos{i}"])
            x = x + out
            new_gcache[f"pos{i}"] = nc
            if ffn is not None:
                x, _ = _apply_ffn(p, cfg, x, ctx, {})
        new_groups.append(new_gcache)
    x = rmsnorm(params["final_norm"], x)
    return unembed(params["embed"], x, cfg.vocab_size), stack_caches(new_groups)
