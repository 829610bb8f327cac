"""Mamba-2 (SSD, arXiv:2405.21060) layer (torch): chunked scan + O(1) decode.

Counterpart of ``repro/models/mamba2.py``.  Within a chunk the recurrence
is a (Q x Q) masked product; across chunks a short loop carries the
(nh, ds, hp) state.  All state math runs in float32.

  h_t = exp(a_t) * h_{t-1} + B_t (dt_t x_t),   a_t = -exp(A_log) * dt_t
  y_t = C_t . h_t + D_skip * x_t
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.carry import check_device

from .layers import Params, linear, linear_init, normal, rmsnorm, rmsnorm_init

__all__ = [
    "MambaConfig",
    "mamba_init",
    "MambaCache",
    "init_mamba_cache",
    "mamba_train",
    "mamba_decode",
    "mamba_scan",
    "softplus",
]


class MambaConfig(NamedTuple):
    d_model: int
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_kernel: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba_init(gen, cfg: MambaConfig, dtype, device="cuda") -> Params:
    device = check_device(device)
    di, nh = cfg.d_inner, cfg.n_heads
    proj_out = 2 * di + 2 * cfg.n_groups * cfg.d_state + nh
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": linear_init(gen, cfg.d_model, proj_out, dtype, device=device),
        "conv_w": (normal(gen, (cfg.conv_kernel, cfg.conv_dim), device) * 0.2).to(dtype),
        "conv_b": torch.zeros((cfg.conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "D_skip": torch.ones((nh,), **f32),
        "dt_bias": torch.log(torch.expm1(torch.full((nh,), 0.01, **f32))),
        "norm": rmsnorm_init(di, dtype, device),
        "out_proj": linear_init(gen, di, cfg.d_model, dtype, device=device),
    }


def _split_proj(cfg: MambaConfig, zxbcdt: torch.Tensor):
    di, gs = cfg.d_inner, cfg.n_groups * cfg.d_state
    return zxbcdt[..., :di], zxbcdt[..., di: 2 * di + 2 * gs], zxbcdt[..., 2 * di + 2 * gs:]


def _causal_conv(p: Params, cfg: MambaConfig, xbc: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence (train / prefill path)."""
    k = cfg.conv_kernel
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    w = p["conv_w"].to(xbc.dtype)
    S = xbc.shape[1]
    out = 0
    for i in range(k):
        out = out + pad[:, i: i + S, :] * w[i]
    return F.silu(out + p["conv_b"].to(xbc.dtype))


def _ssd_chunked(cfg: MambaConfig, x, dt, B_, C_, A, h0: Optional[torch.Tensor] = None):
    """x (B, S, nh, hp); dt (B, S, nh); B_, C_ (B, S, ng, ds); A (nh,) negative.

    Returns (y (B, S, nh, hp), h_final (B, nh, ds, hp)), float32.  The chunk
    is the largest divisor of S not above ``cfg.chunk``.
    """
    Bb, S, nh, hp = x.shape
    ds = B_.shape[3]
    Q = min(cfg.chunk, S)
    while S % Q:
        Q -= 1
    nc = S // Q
    rep = nh // B_.shape[2]

    xf = (x * dt[..., None]).float()                             # dt-scaled input
    a = dt.float() * A                                           # (B, S, nh), <= 0
    Bg = torch.repeat_interleave(B_.float(), rep, dim=2)         # (B, S, nh, ds)
    Cg = torch.repeat_interleave(C_.float(), rep, dim=2)

    def chunked(t):
        return t.reshape((Bb, nc, Q) + t.shape[2:])

    xc, ac, Bc, Cc = map(chunked, (xf, a, Bg, Cg))
    cum = torch.cumsum(ac, dim=2)                                # (B, nc, Q, nh)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # (B, nc, Q, Q, nh) i, j
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    # mask before the exp: above the diagonal seg > 0 can overflow, and
    # where(causal, exp(seg), 0) would then backpropagate 0 * inf = NaN
    L = torch.exp(torch.where(causal[None, None, :, :, None], seg, float("-inf")))

    # intra-chunk: y[i] = sum_j (C_i . B_j) L[i, j] x[j]
    cb = torch.einsum("bnihd,bnjhd->bnijh", Cc, Bc)
    y_intra = torch.einsum("bnijh,bnijh,bnjhp->bnihp", cb, L, xc)

    # chunk states: S_n = sum_j exp(cum_last - cum_j) B_j (x) x_j
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)
    s_n = torch.einsum("bnjh,bnjhd,bnjhp->bnhdp", decay_end, Bc, xc)

    # inter-chunk recurrence: h_{n+1} = h_n * exp(cum_last_n) + S_n
    chunk_decay = torch.exp(cum[:, :, -1, :])                    # (B, nc, nh)
    h = torch.zeros((Bb, nh, ds, hp), dtype=torch.float32, device=x.device) if h0 is None \
        else h0.float()
    h_in = []
    for n in range(nc):
        h_in.append(h)  # the state entering chunk n
        h = h * chunk_decay[:, n, :, None, None] + s_n[:, n]
    h_in = torch.stack(h_in, dim=1)                              # (B, nc, nh, ds, hp)

    y_inter = torch.einsum("bnihd,bnhdp->bnihp", Cc, h_in) * torch.exp(cum)[..., None]
    return (y_intra + y_inter).reshape(Bb, S, nh, hp), h


class MambaCache(NamedTuple):
    conv: torch.Tensor   # (B, k-1, conv_dim) last inputs to the causal conv
    ssm: torch.Tensor    # (B, nh, ds, hp) float32 state


def init_mamba_cache(cfg: MambaConfig, batch: int, dtype, device="cuda") -> MambaCache:
    device = check_device(device)
    return MambaCache(
        conv=torch.zeros((batch, cfg.conv_kernel - 1, cfg.conv_dim), dtype=dtype, device=device),
        ssm=torch.zeros((batch, cfg.n_heads, cfg.d_state, cfg.head_dim), dtype=torch.float32,
                        device=device),
    )


def _heads_from_conv(cfg: MambaConfig, xbc: torch.Tensor):
    """Split the conv output (..., conv_dim) into x heads, B and C groups."""
    nh, hp, ds, ng = cfg.n_heads, cfg.head_dim, cfg.d_state, cfg.n_groups
    lead = xbc.shape[:-1]
    xs = xbc[..., : cfg.d_inner].reshape(*lead, nh, hp)
    B_ = xbc[..., cfg.d_inner: cfg.d_inner + ng * ds].reshape(*lead, ng, ds)
    C_ = xbc[..., cfg.d_inner + ng * ds:].reshape(*lead, ng, ds)
    return xs, B_, C_


def mamba_scan(p: Params, cfg: MambaConfig, x: torch.Tensor, constrain=None):
    """Full-sequence forward x (B, S, D) -> (y (B, S, D), the pre-conv xbc,
    the final SSM state): ``mamba_train`` and prefill share it.
    ``constrain`` takes the reference's pins (heads and channels over
    "model"), identities in the port."""
    B, S, _ = x.shape
    pin = constrain or (lambda t, *axes: t)
    z, xbc, dt = _split_proj(cfg, pin(linear(p["in_proj"], x), "batch", None, "model"))
    xs, B_, C_ = _heads_from_conv(cfg, pin(_causal_conv(p, cfg, xbc), "batch", None, "model"))
    xs = pin(xs, "batch", None, "model", None)
    dt = softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, h_last = _ssd_chunked(cfg, xs, dt, B_, C_, A)
    y = y + p["D_skip"][:, None] * xs.float()
    y = y.reshape(B, S, cfg.d_inner).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z))
    return linear(p["out_proj"], y), xbc, h_last


def mamba_train(p: Params, cfg: MambaConfig, x: torch.Tensor, constrain=None) -> torch.Tensor:
    """Full-sequence forward (train / prefill). x (B, S, D) -> (B, S, D)."""
    return mamba_scan(p, cfg, x, constrain)[0]


def mamba_decode(p: Params, cfg: MambaConfig, x: torch.Tensor, cache: MambaCache):
    """One-token step. x (B, 1, D) -> (y (B, 1, D), new_cache). O(1) in context."""
    B = x.shape[0]
    nh, ng = cfg.n_heads, cfg.n_groups
    z, xbc, dt = _split_proj(cfg, linear(p["in_proj"], x))
    xbc = xbc[:, 0]                                              # (B, conv_dim)
    window = torch.cat([cache.conv, xbc[:, None]], dim=1)       # (B, k, conv_dim)
    w = p["conv_w"].to(xbc.dtype)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, w) + p["conv_b"].to(xbc.dtype))
    xs, B_, C_ = _heads_from_conv(cfg, conv_out)
    rep = nh // ng
    Bg = torch.repeat_interleave(B_.float(), rep, dim=1)        # (B, nh, ds)
    Cg = torch.repeat_interleave(C_.float(), rep, dim=1)
    dtv = softplus(dt[:, 0].float() + p["dt_bias"])             # (B, nh)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dtv * A)
    xdt = xs.float() * dtv[..., None]                           # (B, nh, hp)
    h = cache.ssm * decay[..., None, None] + torch.einsum("bhd,bhp->bhdp", Bg, xdt)
    y = torch.einsum("bhd,bhdp->bhp", Cg, h) + p["D_skip"][:, None] * xs.float()
    y = y.reshape(B, 1, cfg.d_inner).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z))
    return linear(p["out_proj"], y), MambaCache(window[:, 1:], h)
