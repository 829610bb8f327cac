"""AdamW with distributed-scale options (torch).

Counterpart of ``repro/optim/adamw.py``:

* cosine schedule with linear warmup, global-norm clipping;
* ``state_dtype='int8'``: row-wise absmax int8 moments, ``v`` stored in the
  fourth-root domain (linear int8 on ``v`` zeroes small entries of a row
  and ``1/sqrt(v)`` explodes);
* ``compress_grads``: the int8 gradient wire format (quantize, dequantize)
  with an error-feedback accumulator ``err`` that keeps the update
  unbiased over steps.

All state is a plain tree of tensors (nested dicts, like the params), so
checkpoints treat it like params.  A quantized moment is ``{"q": int8 in the
param's shape, "scale": float32 (shape[:-1])}``.  The update is computed in
float32 and cast back to the param's dtype, as the reference's is; rounding
is half to even in both (``torch.round``, ``jnp.round``).

On a mesh (``apply_updates(..., specs=, mesh=)``) every rank updates its
blocks of the params and the state (``distributed.sharding``), and every
reduction covers the whole leaf: ``global_norm`` sums squares over the
blocks, counting each element once however many ranks hold it, and the
row-wise int8 scales take the maximum over the axis that shards a leaf's
last dim.  ``compress_grads`` quantizes the reduced gradient.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.distributed.sharding import replication, spec_axes
from repro_torch.tree import at_path, from_paths, map_leaves, paths

__all__ = [
    "BLOCK",
    "OptConfig",
    "lr_at",
    "quantize_blockwise",
    "dequantize_blockwise",
    "init_opt_state",
    "global_norm",
    "apply_updates",
]

BLOCK = 128


@dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "f32"        # "f32" | "int8"
    compress_grads: bool = False    # int8 gradient exchange with error feedback


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), as a float32
    tensor on the step's device.

    >>> cfg = OptConfig(peak_lr=1.0, warmup_steps=10, total_steps=100)
    >>> float(lr_at(cfg, 5)), round(float(lr_at(cfg, 100)), 6)
    (0.5, 0.1)
    """
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, cos)


# ---------------------------------------------------- row-wise quantization ---
# int8 moments keep the param's own shape with one absmax scale per last-axis
# row, so a moment is laid out (and later sharded) exactly like its param.


def quantize_blockwise(x: torch.Tensor, row_group=None) -> dict:
    """float tensor -> ``{"q": int8 (x.shape), "scale": float32
    (x.shape[:-1])}``, row-wise absmax.  ``row_group`` (an ``AxisGroup``)
    holds the rest of each row when the last dim is sharded: the absmax is
    taken over it.

    >>> qs = quantize_blockwise(torch.tensor([[1.0, -2.0, 0.5]]))
    >>> qs["q"].tolist(), round(float(qs["scale"][0]), 6)
    ([[64, -127, 32]], 0.015748)
    """
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    if row_group is not None:
        absmax = row_group.pmax(absmax)
    scale = absmax / 127.0
    q = torch.round(xf / torch.clamp(scale[..., None], min=1e-12)).to(torch.int8)
    return {"q": q, "scale": scale}


def dequantize_blockwise(qs: dict, like: torch.Tensor) -> torch.Tensor:
    return (qs["q"].float() * qs["scale"][..., None]).reshape(like.shape)


# ----------------------------------------------------------------- states ---
def _device_of(tree) -> torch.device:
    return next(leaf for _, leaf in paths(tree)).device


def init_opt_state(params, cfg: OptConfig) -> dict:
    """Zero moments (float32, or int8 ``{"q", "scale"}``) on the params'
    device, a zero step count, and under ``compress_grads`` a zero
    error-feedback accumulator ``err``."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    if cfg.state_dtype == "int8":
        def qzero(p):
            return {"q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                    "scale": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)}

        m, v = map_leaves(qzero, params), map_leaves(qzero, params)
    else:
        m, v = map_leaves(zeros, params), map_leaves(zeros, params)
    state = {"m": m, "v": v,
             "count": torch.zeros((), dtype=torch.int32, device=_device_of(params))}
    if cfg.compress_grads:
        state["err"] = map_leaves(zeros, params)
    return state


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """The L2 norm of every leaf together, accumulated in float32.  On a
    mesh ``tree`` holds blocks under ``specs``: each block's sum of squares
    is divided by the number of ranks holding it, and the sum is summed
    over the mesh."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float())) for _, x in paths(tree)))
    total = sum(torch.sum(torch.square(x.float())) / replication(at_path(specs, path), mesh)
                for path, x in paths(tree))
    return torch.sqrt(mesh.world.psum(total))


def _row_group(spec, mesh):
    """The group over the axes that shard a leaf's last dim (None if none)."""
    if not spec:
        return None
    axes = [a for a in spec_axes(spec[-1]) if mesh.shape[a] > 1]
    return mesh.group(axes) if axes else None


@torch.no_grad()
def apply_updates(params, grads, state, cfg: OptConfig, *, specs=None, mesh=None):
    """One AdamW step.  Returns ``(new_params, new_state, {"grad_norm", "lr"})``.
    On a mesh, ``params``, ``grads`` and ``state`` are this rank's blocks
    and ``specs`` the params' fitted specs."""
    count = state["count"] + 1
    gnorm = global_norm(grads, specs, mesh)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)

    lr = lr_at(cfg, count)
    bc1 = 1 - cfg.b1 ** count.float()
    bc2 = 1 - cfg.b2 ** count.float()

    def upd(p, g, m, v, err, rows):
        g = g.float() * scale
        new_err = None
        if cfg.compress_grads:
            corrected = g + err
            g = dequantize_blockwise(quantize_blockwise(corrected, rows), corrected)
            new_err = corrected - g
        if cfg.state_dtype == "int8":
            m_f = dequantize_blockwise(m, p)
            v_f = dequantize_blockwise(v, p) ** 4
        else:
            m_f, v_f = m, v
        m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
        v_f = cfg.b2 * v_f + (1 - cfg.b2) * g * g
        step = (m_f / bc1) / (torch.sqrt(v_f / bc2) + cfg.eps)
        pf = p.float()
        new_p = pf - lr * (step + cfg.weight_decay * pf)
        if cfg.state_dtype == "int8":
            m_f = quantize_blockwise(m_f, rows)
            v_f = quantize_blockwise(v_f ** 0.25, rows)
        return new_p.to(p.dtype), m_f, v_f, new_err

    out = []
    for path, p in paths(params):
        err = at_path(state["err"], path) if cfg.compress_grads else None
        rows = None if mesh is None else _row_group(at_path(specs, path), mesh)
        out.append((path, upd(p, at_path(grads, path), at_path(state["m"], path),
                              at_path(state["v"], path), err, rows)))
    new_state = {
        "m": from_paths((path, o[1]) for path, o in out),
        "v": from_paths((path, o[2]) for path, o in out),
        "count": count,
    }
    if cfg.compress_grads:
        new_state["err"] = from_paths((path, o[3]) for path, o in out)
    return from_paths((path, o[0]) for path, o in out), new_state, {"grad_norm": gnorm, "lr": lr}
