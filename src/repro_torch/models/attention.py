"""GQA attention (torch): training/prefill (chunked online softmax), sliding
window, and one-token decode over a KV cache.

Counterpart of ``repro/models/attention.py``, in plain torch ops that repeat
the reference's chunked arithmetic: grouped KV heads, qk-norm, QKV bias,
per-kind RoPE theta.  Scores and the value sums accumulate in float32 (the
reference's ``preferred_element_type``), on upcast operands.  Global layers
scan KV chunks with the online-softmax recurrence, never building the
(S, S) score matrix; local (sliding-window) layers attend to their own and
the previous key block only.  ``constrain`` takes the reference's head
pins (``ShardCtx.constrain_spec``), placement hints that are identities in
the port: on a mesh every rank of a model group runs whole heads.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.carry import check_device

from .layers import Params, apply_rope, linear, linear_init, rmsnorm, rmsnorm_init, rope_angles

__all__ = [
    "AttnConfig",
    "attn_init",
    "KVCache",
    "init_kv_cache",
    "attention_train",
    "attention_decode",
]


class AttnConfig(NamedTuple):
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0        # 0 = full/global attention
    kv_chunk: int = 1024           # online-softmax chunk (global layers)


def attn_init(gen, cfg: AttnConfig, dtype, device="cuda") -> Params:
    device = check_device(device)
    H, Hk, hd, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    p = {
        "wq": linear_init(gen, D, H * hd, dtype, bias=cfg.qkv_bias, device=device),
        "wk": linear_init(gen, D, Hk * hd, dtype, bias=cfg.qkv_bias, device=device),
        "wv": linear_init(gen, D, Hk * hd, dtype, bias=cfg.qkv_bias, device=device),
        "wo": linear_init(gen, H * hd, D, dtype, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, device)
        p["k_norm"] = rmsnorm_init(hd, dtype, device)
    return p


def _project_qkv(p: Params, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor):
    B, S, _ = x.shape
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = linear(p["wq"], x).reshape(B, S, H, hd)
    k = linear(p["wk"], x).reshape(B, S, Hk, hd)
    v = linear(p["wv"], x).reshape(B, S, Hk, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _f32_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An einsum accumulated in float32 (``preferred_element_type=float32``)."""
    return torch.einsum(eq, a.float(), b.float())


def _flash_causal(q, k, v, cfg: AttnConfig):
    """Chunked causal attention with online softmax, grouped-KV form.
    q (B, S, H, hd); k, v (B, S, Hk, hd) -> (B, S, H, hd) in q's dtype.

    The chunk is the largest divisor of S not above ``kv_chunk``.  Fully
    masked rows keep ``m = -inf`` and ``l = 0``: the guards make their
    ``exp`` terms 0 rather than NaN, as the reference's do.
    """
    B, S, H, hd = q.shape
    Hk = k.shape[2]
    G = H // Hk
    C = min(cfg.kv_chunk, S)
    while S % C:
        C -= 1
    scale = hd ** -0.5
    device = q.device
    qh = (q * scale).reshape(B, S, Hk, G, hd)
    q_pos = torch.arange(S, device=device)
    m = torch.full((B, S, Hk, G), float("-inf"), dtype=torch.float32, device=device)
    l = torch.zeros((B, S, Hk, G), dtype=torch.float32, device=device)
    acc = torch.zeros((B, S, Hk, G, hd), dtype=torch.float32, device=device)
    for ci in range(S // C):
        k_blk, v_blk = k[:, ci * C:(ci + 1) * C], v[:, ci * C:(ci + 1) * C]
        k_pos = ci * C + torch.arange(C, device=device)
        mask = q_pos[:, None] >= k_pos[None, :]  # causal
        if cfg.sliding_window:
            mask &= q_pos[:, None] - k_pos[None, :] < cfg.sliding_window
        mb = mask[None, :, None, None, :]
        s = _f32_einsum("bsxgd,bcxd->bsxgc", qh, k_blk)
        s = torch.where(mb, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mb, p, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(dim=-1)
        pv = _f32_einsum("bsxgc,bcxd->bsxgd", p.to(v_blk.dtype), v_blk)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(B, S, H, hd).to(q.dtype)


def _blocked_local(q, k, v, cfg: AttnConfig):
    """Sliding-window attention over (previous, current) key blocks: O(S * 2w)."""
    B, S, H, hd = q.shape
    Hk = k.shape[2]
    G = H // Hk
    w = cfg.sliding_window
    S0 = S
    if S % w:  # pad to a block multiple; the causal mask keeps pads invisible
        pad = w - S % w
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        S = S + pad
    nb = S // w
    scale = hd ** -0.5
    qb = (q * scale).reshape(B, nb, w, H, hd)
    kb = torch.repeat_interleave(k, G, dim=2).reshape(B, nb, w, H, hd)
    vb = torch.repeat_interleave(v, G, dim=2).reshape(B, nb, w, H, hd)
    # previous block (block 0's "previous" is zeros, fully masked)
    k_prev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    v_prev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    k2 = torch.cat([k_prev, kb], dim=2)  # (B, nb, 2w, H, hd)
    v2 = torch.cat([v_prev, vb], dim=2)

    s = _f32_einsum("bnqhd,bnkhd->bnhqk", qb, k2)
    device = q.device
    q_pos = torch.arange(w, device=device)[:, None]
    k_pos = torch.arange(2 * w, device=device)[None, :] - w  # relative to the block start
    rel = q_pos - k_pos
    mask = (rel >= 0) & (rel < w)
    first = (torch.arange(nb, device=device) == 0)[:, None, None]
    full_mask = torch.where(first, mask & (k_pos >= 0), mask)  # (nb, w, 2w)
    s = torch.where(full_mask[None, :, None, :, :], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = _f32_einsum("bnhqk,bnkhd->bnqhd", p.to(v2.dtype), v2).to(v2.dtype)
    return out.reshape(B, S, H, hd)[:, :S0].to(q.dtype)


def _pin_heads(q, k, v, constrain):
    """The reference's head pins on q, k, v (batch, -, heads over "model", -)."""
    if constrain is None:
        return q, k, v
    return tuple(constrain(t, "batch", None, "model", None, allow_uneven=True) for t in (q, k, v))


def attention_train(p: Params, cfg: AttnConfig, x: torch.Tensor, constrain=None) -> torch.Tensor:
    """Causal self-attention over the full sequence (training / prefill)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _pin_heads(*_project_qkv(p, cfg, x, positions), constrain)
    if cfg.sliding_window and S > cfg.sliding_window:
        out = _blocked_local(q, k, v, cfg)
    else:
        out = _flash_causal(q, k, v, cfg)
    return linear(p["wo"], out.reshape(B, S, -1))


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_max, Hk, hd): a ring buffer for local layers
    v: torch.Tensor
    length: torch.Tensor     # 0-d int32: tokens written so far


def init_kv_cache(cfg: AttnConfig, batch: int, max_len: int, dtype, device="cuda") -> KVCache:
    device = check_device(device)
    size = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))


def attention_decode(p: Params, cfg: AttnConfig, x: torch.Tensor, cache: KVCache):
    """One-token decode step.  x (B, 1, D) -> (out, new_cache); the cache
    passed in is not modified.  The position stays on the device: no host
    read a step."""
    B = x.shape[0]
    pos = cache.length
    q, k_new, v_new = _project_qkv(p, cfg, x, pos.expand(B, 1))
    size = cache.k.shape[1]
    slot = (pos % size) if cfg.sliding_window else pos
    k = cache.k.index_copy(1, slot.reshape(1).long(), k_new.to(cache.k.dtype))
    v = cache.v.index_copy(1, slot.reshape(1).long(), v_new.to(cache.v.dtype))

    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // Hk
    qh = (q * hd ** -0.5).reshape(B, 1, Hk, G, hd)
    s = _f32_einsum("bsxgd,btxd->bxgst", qh, k)
    t = torch.arange(size, device=x.device)
    if cfg.sliding_window:
        age = (slot - t) % size  # age of each ring slot
        valid = age < torch.clamp(pos + 1, max=size)
    else:
        valid = t <= pos
    s = torch.where(valid[None, None, None, None, :], s, float("-inf"))
    prob = torch.softmax(s, dim=-1)
    out = _f32_einsum("bxgst,btxd->bsxgd", prob.to(v.dtype), v).to(v.dtype)
    out = linear(p["wo"], out.reshape(B, 1, H * hd))
    return out, KVCache(k, v, pos + 1)
