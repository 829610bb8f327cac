"""Mamba-2 (SSD, arXiv:2405.21060) layer (torch): chunked scan + O(1) decode.

Counterpart of ``repro/models/mamba2.py``.  Within a chunk the recurrence
is a (Q x Q) masked product; across chunks a short loop carries the
(nh, ds, hp) state.  All state math runs in float32.

  h_t = exp(a_t) * h_{t-1} + B_t (dt_t x_t),   a_t = -exp(A_log) * dt_t
  y_t = C_t . h_t + D_skip * x_t

On a mesh the SSM heads split over a "model" group (``group=``, an
``AxisGroup``; ``distributed.sharding`` lays the params out): rank ``r``
holds heads ``[r nh/M, (r+1) nh/M)``: their columns of ``in_proj``'s ``z``,
``x`` and ``dt`` and all of its ``B`` / ``C`` columns (each rank's heads
read them whole), the matching conv channels, its slices of ``A_log``,
``D_skip``, ``dt_bias`` and the norm's scale, and its rows of
``out_proj``.  The input enters through ``copy_to``; the gated norm sums
its squares over the group (the reference normalizes over all of
``d_inner``); ``out_proj``'s partial outputs are summed by
``reduce_from``.  A rank's cache holds its heads' SSM state and a conv
window of its ``x`` channels and all of ``B`` / ``C``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.carry import check_device
from repro_torch.exchange.group import copy_to, reduce_from

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


def _heads(cfg: MambaConfig, group) -> tuple:
    """``(heads, d_inner)`` this rank computes: all of them with no group,
    else its ``1 / group.size`` share.  A split reads ``B`` / ``C`` as one
    group every head shares (``n_groups`` is 1 in every config)."""
    if group is None:
        return cfg.n_heads, cfg.d_inner
    if cfg.n_groups != 1:
        raise NotImplementedError(f"SSM heads split over a group with n_groups={cfg.n_groups}")
    nh = cfg.n_heads // group.size
    return nh, nh * cfg.head_dim


def _split_proj(cfg: MambaConfig, zxbcdt: torch.Tensor, di: int):
    """``(z, xBC, dt)`` of ``in_proj``'s output, ``di`` channels of ``z``
    and ``x`` (this rank's heads')."""
    gs = cfg.n_groups * cfg.d_state
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


def init_mamba_cache(cfg: MambaConfig, batch: int, dtype, device="cuda", *,
                     splits: int = 1) -> MambaCache:
    """Zero caches; ``splits`` ranks share the heads (each holds its own
    heads' state and ``x`` channels, and all of ``B`` / ``C``)."""
    device = check_device(device)
    nh = cfg.n_heads // splits
    conv_dim = nh * cfg.head_dim + 2 * cfg.n_groups * cfg.d_state
    return MambaCache(
        conv=torch.zeros((batch, cfg.conv_kernel - 1, conv_dim), dtype=dtype, device=device),
        ssm=torch.zeros((batch, nh, cfg.d_state, cfg.head_dim), dtype=torch.float32,
                        device=device),
    )


def _heads_from_conv(cfg: MambaConfig, xbc: torch.Tensor, nh: int):
    """Split the conv output (..., nh * head_dim + 2 gs) into ``nh`` x heads
    and the B and C groups."""
    hp, ds, ng = cfg.head_dim, cfg.d_state, cfg.n_groups
    lead, di = xbc.shape[:-1], nh * hp
    xs = xbc[..., :di].reshape(*lead, nh, hp)
    B_ = xbc[..., di: di + ng * ds].reshape(*lead, ng, ds)
    C_ = xbc[..., di + ng * ds:].reshape(*lead, ng, ds)
    return xs, B_, C_


def _out(p: Params, y: torch.Tensor, group) -> torch.Tensor:
    out = linear(p["out_proj"], y)
    return out if group is None else reduce_from(group, out)


def mamba_scan(p: Params, cfg: MambaConfig, x: torch.Tensor, constrain=None, group=None):
    """Full-sequence forward x (B, S, D) -> (y (B, S, D), the pre-conv xbc,
    the final SSM state): ``mamba_train`` and prefill share it.
    ``constrain`` takes the reference's pins (heads and channels over
    "model"), identities in the port; ``group`` splits the heads (module
    docstring), and xbc and the state are then this rank's."""
    B, S, _ = x.shape
    pin = constrain or (lambda t, *axes: t)
    nh, di = _heads(cfg, group)
    if group is not None:
        x = copy_to(group, x)
    z, xbc, dt = _split_proj(cfg, pin(linear(p["in_proj"], x), "batch", None, "model"), di)
    xs, B_, C_ = _heads_from_conv(cfg, pin(_causal_conv(p, cfg, xbc), "batch", None, "model"), nh)
    xs = pin(xs, "batch", None, "model", None)
    dt = softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, h_last = _ssd_chunked(cfg, xs, dt, B_, C_, A)
    y = y + p["D_skip"][:, None] * xs.float()
    y = y.reshape(B, S, di).to(x.dtype)
    return _out(p, rmsnorm(p["norm"], y * F.silu(z), group=group), group), xbc, h_last


def mamba_train(p: Params, cfg: MambaConfig, x: torch.Tensor, constrain=None,
                group=None) -> torch.Tensor:
    """Full-sequence forward (train / prefill). x (B, S, D) -> (B, S, D)."""
    return mamba_scan(p, cfg, x, constrain, group)[0]


def mamba_decode(p: Params, cfg: MambaConfig, x: torch.Tensor, cache: MambaCache, group=None):
    """One-token step. x (B, 1, D) -> (y (B, 1, D), new_cache). O(1) in context.
    With ``group`` the heads split as in ``mamba_scan`` and ``cache`` is
    this rank's."""
    B = x.shape[0]
    nh, di = _heads(cfg, group)
    z, xbc, dt = _split_proj(cfg, linear(p["in_proj"], x), di)
    xbc = xbc[:, 0]                                              # (B, conv channels)
    window = torch.cat([cache.conv, xbc[:, None]], dim=1)       # (B, k, conv channels)
    w = p["conv_w"].to(xbc.dtype)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, w) + p["conv_b"].to(xbc.dtype))
    xs, B_, C_ = _heads_from_conv(cfg, conv_out, nh)
    rep = nh // B_.shape[1]
    Bg = torch.repeat_interleave(B_.float(), rep, dim=1)        # (B, nh, ds)
    Cg = torch.repeat_interleave(C_.float(), rep, dim=1)
    dtv = softplus(dt[:, 0].float() + p["dt_bias"])             # (B, nh)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dtv * A)
    xdt = xs.float() * dtv[..., None]                           # (B, nh, hp)
    h = cache.ssm * decay[..., None, None] + torch.einsum("bhd,bhp->bhdp", Bg, xdt)
    y = torch.einsum("bhd,bhdp->bhp", Cg, h) + p["D_skip"][:, None] * xs.float()
    y = y.reshape(B, 1, di).to(x.dtype)
    return _out(p, rmsnorm(p["norm"], y * F.silu(z), group=group), group), \
        MambaCache(window[:, 1:], h)
