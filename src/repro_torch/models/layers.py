"""Common model layers (torch): plain functions on tensors, params as dicts.

Counterpart of ``repro/models/layers.py``.  Every ``*_init`` draws from an
explicit ``torch.Generator`` where the reference draws from ``jax.random``,
and places its tensors on ``device`` (default the card: with no card an
init raises rather than running on the CPU); the draws differ from the reference's,
so parity tests carry the reference's params across
(``repro_torch.carry.params_from_reference``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.carry import check_device
from repro_torch.exchange.group import copy_to, reduce_from

__all__ = [
    "Params",
    "rmsnorm_init",
    "rmsnorm",
    "rope_angles",
    "apply_rope",
    "linear_init",
    "linear",
    "mlp_init",
    "mlp",
    "gelu",
    "embed_init",
    "embed",
    "unembed",
    "normal",
]

Params = dict


def normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal float32 draws of ``shape`` from ``gen`` on ``device``
    (``jax.random.normal``'s role)."""
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


# ---------------------------------------------------------------- RMSNorm ---
def rmsnorm_init(dim: int, dtype, device="cuda") -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=check_device(device))}


def rmsnorm(p: Params, x: torch.Tensor, *, eps: float = 1e-6, group=None) -> torch.Tensor:
    """Variance in float32; the normalize and scale multiplies stay in the
    residual dtype (the reference's choice, which keeps bf16 activations
    bf16).  With ``group`` (an ``AxisGroup``) ``x`` and ``p`` are this
    rank's equal share of the normalized dim: the sum of squares is summed
    over the group, forward and backward.

    >>> rmsnorm({"scale": torch.ones(2)}, torch.tensor([[3.0, 4.0]])).tolist()
    [[0.8485280275344849, 1.1313706636428833]]
    """
    xf = x.float()
    if group is None:
        var = (xf * xf).mean(dim=-1, keepdim=True)
    else:
        ss = copy_to(group, reduce_from(group, (xf * xf).sum(dim=-1, keepdim=True)))
        var = ss / (x.shape[-1] * group.size)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * p["scale"].to(x.dtype)


# ------------------------------------------------------------------- RoPE ---
def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """positions (...,) -> cos/sin tables (..., head_dim/2), float32."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device), exponent)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd); cos/sin (..., S, hd/2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]  # add the head axis
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ----------------------------------------------------------------- Linear ---
def linear_init(gen, d_in: int, d_out: int, dtype, *, bias: bool = False, device="cuda") -> Params:
    device = check_device(device)
    scale = d_in ** -0.5
    p = {"w": (normal(gen, (d_in, d_out), device) * scale).to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    out = x @ p["w"].to(x.dtype)
    if "b" in p:
        out = out + p["b"].to(x.dtype)
    return out


# -------------------------------------------------------------------- MLP ---
def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_init(gen, d_model: int, d_ff: int, dtype, *, gated: bool = True, device="cuda") -> Params:
    device = check_device(device)
    p = {
        "w_in": linear_init(gen, d_model, d_ff, dtype, device=device),
        "w_out": linear_init(gen, d_ff, d_model, dtype, device=device),
    }
    if gated:
        p["w_gate"] = linear_init(gen, d_model, d_ff, dtype, device=device)
    return p


def mlp(p: Params, x: torch.Tensor, group=None) -> torch.Tensor:
    """SwiGLU (or GELU) FFN.  With ``group`` (an ``AxisGroup``) the hidden
    units are split over it, Megatron's way: ``w_in`` / ``w_gate`` hold
    this rank's columns, ``w_out`` its rows; the partial outputs are summed
    over the group and the input's gradient too."""
    if group is not None:
        x = copy_to(group, x)
    h = linear(p["w_in"], x)
    if "w_gate" in p:
        h = F.silu(linear(p["w_gate"], x)) * h  # SwiGLU
    else:
        h = gelu(h)
    out = linear(p["w_out"], h)
    return out if group is None else reduce_from(group, out)


# -------------------------------------------------------------- Embedding ---
def embed_init(gen, vocab: int, d_model: int, dtype, device="cuda") -> Params:
    return {"table": normal(gen, (vocab, d_model), check_device(device)).to(dtype)}


def embed(p: Params, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Rows of the table in ``compute_dtype``.  ``F.embedding``, whose
    backward on the card sums the gradients of repeated tokens in a fixed
    (sorted) order, so a training step repeats bit for bit."""
    return F.embedding(tokens.long(), p["table"].to(compute_dtype))


def unembed(p: Params, x: torch.Tensor, vocab_size: Optional[int] = None) -> torch.Tensor:
    """Tied logits head: x (..., D) @ table.T -> (..., V_pad) in float32.

    Rows past ``vocab_size`` are padding of the table and get ``-inf``
    logits, so sampling never selects them.

    >>> unembed({"table": torch.eye(3)}, torch.tensor([[1.0, 2.0, 3.0]]), 2).tolist()
    [[1.0, 2.0, -inf]]
    """
    logits = x.float() @ p["table"].float().T
    v_pad = p["table"].shape[0]
    if vocab_size is not None and v_pad != vocab_size:
        keep = torch.arange(v_pad, device=logits.device) < vocab_size
        logits = torch.where(keep, logits, float("-inf"))
    return logits
