"""Architecture registry, the assignment's input shapes, and the smoke-test
reduction (torch).

Counterpart of ``repro/configs/base.py``: the same ten ``ARCHS`` with the
same numbers and names, ``SHAPES``, ``SUBQUADRATIC``, ``cell_applicable``,
``all_cells``, ``reduced`` and the abstract shapes ``input_specs`` /
``cache_specs``, with torch dtypes.  An abstract shape is a tensor on the
``meta`` device, the port's ``jax.ShapeDtypeStruct``: shape and dtype, no
storage.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict

import torch

from repro_torch.models.transformer import ModelConfig

from .command_r_35b import CONFIG as _command_r
from .dbrx_132b import CONFIG as _dbrx
from .gemma3_12b import CONFIG as _gemma3
from .granite_moe_3b_a800m import CONFIG as _granite
from .internvl2_2b import CONFIG as _internvl2
from .jamba_1_5_large_398b import CONFIG as _jamba
from .mamba2_1_3b import CONFIG as _mamba2
from .musicgen_medium import CONFIG as _musicgen
from .qwen2_7b import CONFIG as _qwen2
from .qwen3_0_6b import CONFIG as _qwen3

__all__ = ["ARCHS", "SHAPES", "SUBQUADRATIC", "cell_applicable", "all_cells", "reduced",
           "input_specs", "cache_specs"]

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in [
        _dbrx,
        _granite,
        _internvl2,
        _qwen3,
        _command_r,
        _qwen2,
        _gemma3,
        _musicgen,
        _mamba2,
        _jamba,
    ]
}

# assignment shape table: name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}

# archs with a sub-quadratic serving path (SSM / hybrid / 5:1 local window)
SUBQUADRATIC = {"mamba2-1.3b", "jamba-1.5-large-398b", "gemma3-12b"}


def cell_applicable(arch: str, shape: str) -> bool:
    """long_500k is skipped for pure full-attention archs.

    >>> cell_applicable("qwen3-0.6b", "long_500k"), cell_applicable("gemma3-12b", "long_500k")
    (False, True)
    """
    if shape == "long_500k":
        return arch in SUBQUADRATIC
    return True


def all_cells():
    return [(a, s) for a in ARCHS for s in SHAPES if cell_applicable(a, s)]


def input_specs(cfg: ModelConfig, shape: str) -> dict:
    """``meta`` stand-ins for every model input of this cell.

    train   -> {tokens (B, S), labels (B, S) [, frontend_embeds (B, F, D)]}
    prefill -> {tokens (B, S) [, frontend_embeds]}
    decode  -> {tokens (B, 1)} (the cache comes from ``cache_specs``)

    >>> input_specs(ARCHS["qwen3-0.6b"], "decode_32k")["tokens"].shape
    torch.Size([128, 1])
    """
    S, B, kind = SHAPES[shape]

    def tok(*dims):
        return torch.empty(dims, dtype=torch.int32, device="meta")

    if kind == "train":
        specs = {"tokens": tok(B, S), "labels": tok(B, S)}
    elif kind == "prefill":
        specs = {"tokens": tok(B, S)}
    else:  # decode: one new token against a cache of length S
        specs = {"tokens": tok(B, 1)}
    if cfg.frontend != "none" and kind != "decode":
        specs["frontend_embeds"] = torch.empty((B, cfg.n_frontend_tokens, cfg.d_model),
                                               dtype=cfg.compute_dtype, device="meta")
    return specs


def cache_specs(cfg: ModelConfig, shape: str) -> dict:
    """``meta`` stand-ins of the decode cache for this cell (no storage)."""
    from repro_torch.models.transformer import init_cache

    S, B, kind = SHAPES[shape]
    if kind != "decode":
        raise ValueError(f"{shape} is a {kind} cell: only decode cells have a cache")
    return init_cache(cfg, B, S, device="meta")


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Same-family tiny config for CPU smoke tests (one pattern group).

    >>> r = reduced(ARCHS["qwen3-0.6b"])
    >>> r.name, r.n_layers, r.d_model, r.vocab_size, r.param_dtype
    ('qwen3-0.6b-smoke', 1, 64, 128, torch.float32)
    """
    is_attn = any(k.startswith("attn") for k in cfg.pattern)
    return replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=len(cfg.pattern),
        d_model=64,
        n_heads=4 if is_attn else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if is_attn else 0,
        head_dim=16 if is_attn else 0,
        d_ff=0 if cfg.d_ff == 0 else 96,
        vocab_size=128,
        n_experts=min(cfg.n_experts, 5) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        capacity_factor=4.0,  # tiny batches + fresh routers overflow cf=2
        sliding_window=8 if cfg.sliding_window else 0,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_chunk=8,
        n_frontend_tokens=4 if cfg.frontend != "none" else 0,
        kv_chunk=16,
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
    )
