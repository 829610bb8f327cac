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

``ShardCtx`` names a mesh (``repro_torch.launch.mesh.Mesh``) for the
stack's mesh branches, run as explicit SPMD: every rank a process, its
batch rows split over the batch axes (every axis but ``ep_axis``) and the
residual stream replicated over ``ep_axis``.  Params come in the compute
layout (``distributed.sharding.compute_specs``), the reference's
parallelism profile: the embedding table vocab-sharded over ``ep_axis``
(the vocab-parallel embedding and logits), every expert stack
expert-sharded over it, and Megatron tensor parallelism in the dense
layers: attention heads, dense FFN hidden units and Mamba-2's SSM heads
split over it (``copy_to`` before the column-parallel products,
``reduce_from`` after the row-parallel one; a Mamba rank reads ``B`` /
``C`` whole and its gated norm sums squares over the group).  Where the
heads do not divide ``ep_axis`` (qwen2's 28 at 16, the case the reference
pins apart) every rank of a model group runs every head; likewise a
Mamba-2 block whose SSM heads do not (``ShardCtx.mamba_group``).
Decoding keeps each rank's rows, its ``S / model`` positions of every
attention cache (split-K, ``attention_decode``), where they divide
``ep_axis`` (``ShardCtx.seq_group``), and its heads' Mamba state and conv
channels; an attention cache whose length does not divide is replicated
over it, as the reference's is.  An MoE FFN takes each model rank's
contiguous share of the data shard's tokens into ``moe_apply_local``
(model D's all_to_all) and gathers the outputs back, for train and
prefill; decode replicates the tokens over the group and sums each rank's
experts' outputs.  The reference's sharding pins (``constrain_batch``,
``constrain_spec``) are placement hints with no numeric effect,
identities here.  ``model_init`` and ``init_cache`` place their tensors on
``device``, the card by default.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_map

from repro_torch.carry import check_device
from repro_torch.distributed.sharding import splits_positions, tp_layout
from repro_torch.exchange.group import gather_from, reduce_from, split_to

from .attention import (
    AttnConfig,
    SplitKVCache,
    TPHeads,
    attention_decode,
    attention_train,
    attn_init,
    cache_size,
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
from .moe import MoEConfig, moe_apply_ep_replicated, moe_apply_local, moe_init

__all__ = [
    "ModelConfig",
    "ShardCtx",
    "embed_tokens",
    "logits_of",
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
    """How the model parallelizes.  ``mesh=None``: one device."""
    mesh: Any = None
    axes: Tuple[str, ...] = ()      # the mesh axes; the batch shards over all but ep_axis
    ep_axis: str = "model"

    @property
    def ep_shards(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape[self.ep_axis]

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axes if a != self.ep_axis)

    def pick_batch_axes(self, n: int) -> Tuple[str, ...]:
        """Largest prefix of batch axes whose sizes divide ``n`` (small decode
        batches cannot use every axis)."""
        axes, rem = [], n
        for a in self.batch_axes:
            sz = self.mesh.shape[a]
            if rem % sz == 0:
                axes.append(a)
                rem //= sz
        return tuple(axes)

    def group(self, axes):
        """The ``AxisGroup`` over ``axes`` (``None`` for none)."""
        return self.mesh.group(axes)

    @property
    def ep_group(self):
        return self.mesh.group(self.ep_axis)

    def tp_heads(self, cfg: "ModelConfig") -> Optional[TPHeads]:
        """Attention heads split over ``ep_axis`` where they divide it
        (``None``: every head on every rank)."""
        if self.mesh is None or self.ep_shards == 1:
            return None
        layout = tp_layout(cfg, self.ep_shards)
        return TPHeads(self.ep_group, layout.kv_heads) if layout.heads else None

    def mamba_group(self, cfg: "ModelConfig"):
        """The group a Mamba-2 block's SSM heads split over (``None``: every
        head on every rank)."""
        if self.mesh is None or self.ep_shards == 1 or not tp_layout(cfg, self.ep_shards).mamba:
            return None
        return self.ep_group

    def ffn_group(self, cfg: "ModelConfig"):
        """The group a dense FFN's hidden units split over (``None``: whole)."""
        if self.mesh is None or self.ep_shards == 1 or not tp_layout(cfg, self.ep_shards).ffn:
            return None
        return self.ep_group

    def seq_group(self, size: int):
        """The group an attention cache of ``size`` positions splits them
        over (``None``: whole on each rank)."""
        if self.mesh is None or not splits_positions(size, self.mesh, self.ep_axis):
            return None
        return self.ep_group

    def constrain_batch(self, x: torch.Tensor) -> torch.Tensor:
        """The reference pins dim 0 of an activation to the batch axes; the
        port's ranks hold their rows already, so this is the identity."""
        return x

    def constrain_spec(self, x: torch.Tensor, *axes, allow_uneven: bool = False) -> torch.Tensor:
        """The reference's activation pin (a placement hint): the identity."""
        return x


def embed_tokens(p_embed: Params, tokens: torch.Tensor, cfg: ModelConfig,
                 ctx: Optional[ShardCtx]) -> torch.Tensor:
    """Token embedding lookup.  On a mesh it is vocab-parallel: each rank
    of the ``ep_axis`` group looks up the tokens in its rows of the table,
    zeros elsewhere, and the results are summed over the group."""
    if ctx is None or ctx.mesh is None:
        return embed(p_embed, tokens, cfg.compute_dtype)
    group = ctx.ep_group
    tbl = p_embed["table"]
    vloc = tbl.shape[0]
    rel = tokens.long() - group.rank * vloc
    ok = (rel >= 0) & (rel < vloc)
    out = F.embedding(torch.clamp(rel, 0, vloc - 1), tbl.to(cfg.compute_dtype))
    out = torch.where(ok[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    return reduce_from(group, out)


def logits_of(p_embed: Params, x: torch.Tensor, cfg: ModelConfig,
              ctx: Optional[ShardCtx]) -> torch.Tensor:
    """The tied head's float32 logits (padding rows ``-inf``).  On a mesh
    each rank projects onto its rows of the table and the logits are
    gathered over the ``ep_axis`` group."""
    if ctx is None or ctx.mesh is None:
        return unembed(p_embed, x, cfg.vocab_size)
    full = gather_from(ctx.ep_group, unembed(p_embed, x), x.dim() - 1)
    v_pad = full.shape[-1]
    if v_pad != cfg.vocab_size:
        keep = torch.arange(v_pad, device=full.device) < cfg.vocab_size
        full = torch.where(keep, full, float("-inf"))
    return full


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
               decode: bool = False, moe_capacity: Optional[int] = None,
               moe_stats: bool = False):
    """Pre-norm FFN residual; an MoE FFN adds its aux loss and overflow flag
    to ``stats``.  ``moe_capacity`` overrides the per-(sender, expert) token
    capacity (the train loop's capacity controller passes the learned
    value); ``moe_stats=True`` adds ``moe_dropped`` (summed over layers) and
    ``moe_peak`` (maxed over layers), what the between-step learner and
    ``AnomalyMonitor`` read; on a mesh both cover every rank.

    On a mesh, train and prefill (``decode=False``) hand each model rank
    its contiguous share of the data shard's flattened tokens (the
    reference's token sharding over every mesh axis) for model D's
    dispatch, and gather the outputs back; decode replicates the tokens
    over the model group and sums the ranks' experts."""
    h = rmsnorm(p["norm2"], x)
    if "ffn" in p:
        return x + mlp(p["ffn"], h, ctx.ffn_group(cfg)), stats
    B, S, D = h.shape
    flat = h.reshape(B * S, D)
    mcfg = cfg.moe_cfg()
    dropped = peak = None
    if ctx.mesh is None:
        res = moe_apply_ep_replicated(p["moe"], mcfg, flat, capacity=moe_capacity,
                                      with_stats=moe_stats)
        if moe_stats:
            y, aux, dropped, _, peak, overflow = res
        else:
            y, aux, overflow = res
    elif decode:
        y, aux, overflow = moe_apply_ep_replicated(p["moe"], mcfg, flat, ctx.ep_group,
                                                   ctx.group(ctx.axes))
    else:
        ep = ctx.ep_group
        res = moe_apply_local(p["moe"], mcfg, split_to(ep, flat, 0), ep, ctx.group(ctx.axes),
                              capacity=moe_capacity, with_stats=moe_stats)
        if moe_stats:
            y, aux, dropped, _, peak, overflow = res
            rest = ctx.group(ctx.batch_axes)
            if rest is not None:  # the stats are EP-group-wide; fold in the other axes
                dropped, peak = rest.psum(dropped), rest.pmax(peak)
        else:
            y, aux, overflow = res
        y = gather_from(ep, y, 0)
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
    pin = ctx.constrain_spec if ctx.mesh is not None else None
    if kind.startswith("attn"):
        # the reference pins heads only where they do not divide the model axis
        attn_pin = pin if (pin and cfg.n_heads % ctx.ep_shards) else None
        x = x + attention_train(p["attn"], cfg.attn_cfg(kind), h, constrain=attn_pin,
                                tp=ctx.tp_heads(cfg))
    else:
        x = x + mamba_train(p["mamba"], cfg.mamba_cfg(), h, constrain=pin,
                            group=ctx.mamba_group(cfg))
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
        x = ctx.constrain_batch(x)
        for i, (kind, ffn) in enumerate(zip(cfg.pattern, cfg.ffn_pattern)):
            x, stats = _apply_block(gp[f"pos{i}"], cfg, kind, ffn, x, ctx, stats)
    x = rmsnorm(params["final_norm"], x)
    logits = logits_of(params["embed"], x, cfg, ctx)
    return logits, {"moe_aux": stats["moe_aux"] / max(cfg.n_layers, 1),
                    "moe_overflow": stats["moe_overflow"]}


# ---------------------------------------------------------------- decode ---
def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda", *,
               ctx: ShardCtx = ShardCtx()):
    """Per-group stacked caches on ``device``: each leaf has a leading
    ``n_groups`` axis.  On a mesh ``batch`` is this rank's rows, each
    attention cache holds this rank's block of positions where they split
    over ``ctx.ep_axis`` (``ShardCtx.seq_group``), and each Mamba cache
    this rank's heads where they split (``ShardCtx.mamba_group``)."""
    device = check_device(device)

    def one(kind: str):
        if kind.startswith("attn"):
            acfg = cfg.attn_cfg(kind)
            seq = ctx.seq_group(cache_size(acfg, max_len))
            c = init_kv_cache(acfg, batch, max_len, cfg.compute_dtype, device,
                              splits=1 if seq is None else seq.size)
        else:
            heads = ctx.mamba_group(cfg)
            c = init_mamba_cache(cfg.mamba_cfg(), batch, cfg.compute_dtype, device,
                                 splits=1 if heads is None else heads.size)
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
                c = gcache[f"pos{i}"]
                seq = ctx.ep_group if isinstance(c, SplitKVCache) else None
                out, nc = attention_decode(p["attn"], cfg.attn_cfg(kind), h, c,
                                           tp=ctx.tp_heads(cfg), seq=seq)
            else:
                out, nc = mamba_decode(p["mamba"], cfg.mamba_cfg(), h, gcache[f"pos{i}"],
                                       group=ctx.mamba_group(cfg))
            x = x + out
            new_gcache[f"pos{i}"] = nc
            if ffn is not None:
                x, _ = _apply_ffn(p, cfg, x, ctx, {}, decode=True)
        new_groups.append(new_gcache)
    x = rmsnorm(params["final_norm"], x)
    return logits_of(params["embed"], x, cfg, ctx), stack_caches(new_groups)
