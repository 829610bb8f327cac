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
the port.

On a mesh (``distributed.sharding`` names the layout) the heads split over
the "model" group, Megatron's way, when ``tp`` (a ``TPHeads``) is given:
each rank projects its ``n_heads / model`` query heads and the KV heads
they read (its own share of ``wk`` / ``wv``, or its slice of the whole
ones where the KV heads do not divide the group), attends, and its rows
of ``wo`` give a partial output summed over the group.  Decoding splits
the cache's positions over the group instead (split-K, ``seq``): every
rank holds every KV head for its ``S / model`` positions, computes the
float32 partial softmax (max, sum, weighted values) of every query head
over them, and the partials combine over the group (flash-decoding);
``wo`` stays row-parallel.  A cache whose length does not divide the group
is replicated over it instead (``sharding.splits_positions``), and every
rank attends over all of it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.carry import check_device
from repro_torch.exchange.group import copy_to, gather_from, reduce_from

from .layers import Params, apply_rope, linear, linear_init, rmsnorm, rmsnorm_init, rope_angles

__all__ = [
    "AttnConfig",
    "TPHeads",
    "attn_init",
    "KVCache",
    "SplitKVCache",
    "cache_size",
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


class TPHeads(NamedTuple):
    """The heads of an attention layer split over ``group`` (an
    ``AxisGroup``): ``wq`` / ``wo`` hold this rank's heads' columns / rows;
    ``wk`` / ``wv`` too when ``kv_split``, else they are whole."""
    group: object
    kv_split: bool

    def query_heads(self, cfg: "AttnConfig") -> tuple:
        """(first, count) of this rank's query heads."""
        n = cfg.n_heads // self.group.size
        return self.group.rank * n, n


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


def _kv_heads_read(tp: TPHeads, cfg: AttnConfig):
    """The KV heads this rank's query heads read, from whole ``wk`` / ``wv``:
    ``(lo, hi, index)``: heads ``lo .. hi - 1`` are projected; ``index``
    (or ``None``) picks one for each query head where the grouped form
    does not hold (a query block straddling KV groups)."""
    q0, n = tp.query_heads(cfg)
    G = cfg.n_heads // cfg.n_kv_heads
    lo, hi = q0 // G, (q0 + n - 1) // G + 1
    if n % G == 0 or G % n == 0:
        return lo, hi, None
    return lo, hi, [(q0 + j) // G - lo for j in range(n)]


def _columns(p: Params, lo: int, hi: int) -> Params:
    """Columns ``lo .. hi - 1`` of a linear (and of its bias)."""
    out = {"w": p["w"][:, lo:hi]}
    if "b" in p:
        out["b"] = p["b"][lo:hi]
    return out


def _norm_rope(p: Params, cfg: AttnConfig, t: torch.Tensor, positions: torch.Tensor,
               norm: str) -> torch.Tensor:
    """qk-norm (``p[norm]``) and RoPE of q or k (B, S, heads, hd)."""
    if cfg.qk_norm:
        t = rmsnorm(p[norm], t)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    return apply_rope(t, cos, sin)


def _kv(p: Params, cfg: AttnConfig, x, positions, pk: Params, pv: Params):
    B, S, _ = x.shape
    k = linear(pk, x).reshape(B, S, -1, cfg.head_dim)
    v = linear(pv, x).reshape(B, S, -1, cfg.head_dim)
    return _norm_rope(p, cfg, k, positions, "k_norm"), v


def _project_qkv(p: Params, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
                 tp: TPHeads = None):
    """q (B, S, H', hd), k, v (B, S, Hk', hd): every head, or with ``tp``
    this rank's query heads and the KV heads they read, in the grouped
    order ``_flash_causal`` takes (query head j reads KV head j // G')."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = linear(p["wq"], x).reshape(B, S, -1, hd)
    index = None
    if tp is None or tp.kv_split:
        pk, pv = p["wk"], p["wv"]
    else:
        lo, hi, index = _kv_heads_read(tp, cfg)
        pk, pv = _columns(p["wk"], lo * hd, hi * hd), _columns(p["wv"], lo * hd, hi * hd)
    k, v = _kv(p, cfg, x, positions, pk, pv)
    if index is not None:
        k, v = k[:, :, index], v[:, :, index]
    return _norm_rope(p, cfg, q, positions, "q_norm"), k, v


def kv_rows(p: Params, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
            tp: TPHeads = None):
    """k, v (B, S, Hk, hd) of every KV head at the rows ``x`` (B, S, D) at
    ``positions``: what a cache holds.  Split ``wk`` / ``wv`` are gathered
    over ``tp``'s group first (prefill: no gradient flows here)."""
    pk, pv = p["wk"], p["wv"]
    if tp is not None and tp.kv_split:
        pk, pv = ({n: gather_from(tp.group, t, t.dim() - 1) for n, t in w.items()}
                  for w in (pk, pv))
    return _kv(p, cfg, x, positions, pk, pv)


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


def attention_train(p: Params, cfg: AttnConfig, x: torch.Tensor, constrain=None,
                    tp: TPHeads = None) -> torch.Tensor:
    """Causal self-attention over the full sequence (training / prefill);
    with ``tp`` over this rank's heads, the output summed over its group."""
    B, S, _ = x.shape
    if tp is not None:
        x = copy_to(tp.group, x)
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _pin_heads(*_project_qkv(p, cfg, x, positions, tp), constrain)
    out = linear(p["wo"], attend(q, k, v, cfg).reshape(B, S, -1))
    return out if tp is None else reduce_from(tp.group, out)


def attend(q, k, v, cfg: AttnConfig) -> torch.Tensor:
    """The causal core over a whole sequence: sliding-window blocks for a
    local layer longer than its window, else the chunked flash form."""
    if cfg.sliding_window and q.shape[1] > cfg.sliding_window:
        return _blocked_local(q, k, v, cfg)
    return _flash_causal(q, k, v, cfg)


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_max, Hk, hd): a ring buffer for local layers
    v: torch.Tensor
    length: torch.Tensor     # 0-d int32: tokens written so far


class SplitKVCache(KVCache):
    """A ``KVCache`` that holds one rank's block of its positions, every KV
    head (split-K).  A rank's block alone does not tell the whole length,
    so the type carries the layout from the cache's making to its decode."""
    __slots__ = ()


def cache_size(cfg: AttnConfig, max_len: int) -> int:
    """The positions an empty cache holds: a local layer's ring of its
    window, else ``max_len``."""
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def init_kv_cache(cfg: AttnConfig, batch: int, max_len: int, dtype, device="cuda", *,
                  splits: int = 1) -> KVCache:
    """An empty cache of ``cache_size`` positions; with ``splits`` > 1 one
    rank's block of them (a ``SplitKVCache``)."""
    device = check_device(device)
    shape = (batch, cache_size(cfg, max_len) // splits, cfg.n_kv_heads, cfg.head_dim)
    return (SplitKVCache if splits > 1 else KVCache)(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros((), dtype=torch.int32, device=device))


def attention_decode(p: Params, cfg: AttnConfig, x: torch.Tensor, cache: KVCache,
                     tp: TPHeads = None, seq=None):
    """One-token decode step.  x (B, 1, D) -> (out, new_cache); the cache
    passed in is not modified.  The position stays on the device: no host
    read a step.

    With ``seq`` (an ``AxisGroup``) the cache is a ``SplitKVCache``, this
    rank's block of positions (ring slots for a local layer): the new
    token's K/V goes to the rank that owns its slot, and the partial
    softmaxes combine over ``seq`` (module docstring).  ``tp`` splits the
    projections' heads over its group."""
    B = x.shape[0]
    pos = cache.length
    if tp is not None:
        x = copy_to(tp.group, x)
    positions = pos.expand(B, 1)
    if tp is None:
        q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    else:  # every head on every rank: the cache's positions are split, not its heads
        q = gather_from(tp.group, linear(p["wq"], x).reshape(B, 1, -1, cfg.head_dim), 2)
        q = _norm_rope(p, cfg, q, positions, "q_norm")
        if tp.kv_split:  # gather the new token's heads, not the weights
            k_new, v_new = (gather_from(tp.group, t, 2)
                            for t in _kv(p, cfg, x, positions, p["wk"], p["wv"]))
        else:
            k_new, v_new = kv_rows(p, cfg, x, positions)
    local = cache.k.shape[1]
    size = local * (seq.size if seq is not None else 1)
    slot = (pos % size) if cfg.sliding_window else pos
    if seq is None:
        k = cache.k.index_copy(1, slot.reshape(1).long(), k_new.to(cache.k.dtype))
        v = cache.v.index_copy(1, slot.reshape(1).long(), v_new.to(cache.v.dtype))
        t = torch.arange(size, device=x.device)
    else:  # the owner of the slot writes it; no host read of which rank that is
        t = seq.rank * local + torch.arange(local, device=x.device)
        mine = (t == slot)[None, :, None, None]
        k = torch.where(mine, k_new.to(cache.k.dtype), cache.k)
        v = torch.where(mine, v_new.to(cache.v.dtype), cache.v)

    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // Hk
    qh = (q * hd ** -0.5).reshape(B, 1, Hk, G, hd)
    s = _f32_einsum("bsxgd,btxd->bxgst", qh, k)
    if cfg.sliding_window:
        age = (slot - t) % size  # age of each ring slot
        valid = age < torch.clamp(pos + 1, max=size)
    else:
        valid = t <= pos
    s = torch.where(valid[None, None, None, None, :], s, float("-inf"))
    if seq is None:
        prob = torch.softmax(s, dim=-1)
        out = _f32_einsum("bxgst,btxd->bsxgd", prob.to(v.dtype), v).to(v.dtype)
    else:  # flash-decoding: this rank's partial softmax, combined over seq
        m = seq.pmax(s.amax(dim=-1, keepdim=True))  # finite: position 0 is valid somewhere
        e = torch.exp(s - m)
        total = seq.psum(e.sum(dim=-1))             # (B, Hk, G, 1)
        acc = seq.psum(_f32_einsum("bxgst,btxd->bsxgd", e.to(v.dtype), v))
        out = (acc / total.permute(0, 3, 1, 2)[..., None]).to(v.dtype)
    out = out.reshape(B, 1, H * hd)
    new = type(cache)(k, v, pos + 1)
    if tp is None:
        return linear(p["wo"], out), new
    q0, n = tp.query_heads(cfg)
    out = linear(p["wo"], out[..., q0 * hd:(q0 + n) * hd])
    return reduce_from(tp.group, out), new

