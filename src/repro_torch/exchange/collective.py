"""The exchange wire: one fixed-capacity ``all_to_all`` each way (torch).

Counterpart of ``repro/exchange/collective.py``.  ``partition_exchange``
ships every element to the rank owning its bucket; ``combine_exchange`` is
the exact inverse (MoE's return trip).  MPI's variable-length messages
become fixed-capacity slabs of ``capacity`` elements per (sender, bucket),
padded with sentinels.  Overflow is detected collectively and surfaced;
capacity policy lives one layer up (``retry.py`` doubles and retries).

Each function runs on every rank of ``group`` (an ``AxisGroup``), on that
rank's shard, as the reference's runs inside ``shard_map``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch.utils._pytree import tree_map

from .group import AxisGroup
from .partition import radix_bucket_ids, sample_partition_ids
from .slabs import sentinel_for

__all__ = ["ExchangeResult", "combine_exchange", "partition_exchange"]


@dataclass
class ExchangeResult:
    """Everything ``partition_exchange`` learned while scattering one batch.

    ``recv_*`` are what this rank received (slab layout, sentinel/zero
    padded); ``send_slot``/``counts``/``overflow`` describe what this rank
    sent — ``counts`` and ``overflow`` are the telemetry the capacity loop
    feeds on.

    >>> ex = ExchangeResult(recv_keys=torch.zeros(4), recv_values=None,
    ...                     recv_src_slot=torch.full((4,), -1), send_slot=None,
    ...                     counts=torch.tensor([3, 1]), overflow=torch.tensor(False))
    >>> int(ex.counts.max()), bool(ex.overflow)
    (3, False)
    """

    recv_keys: torch.Tensor      # (P, C) keys received, sentinel-padded
    recv_values: Any             # pytree of (P, C, ...) or None
    recv_src_slot: torch.Tensor  # (P, C) flat slot id in the *sender's* slab
    send_slot: torch.Tensor      # (m,) my element's slab slot, -1 if dropped
    counts: torch.Tensor         # (n_buckets,) my element count per bucket
    overflow: torch.Tensor       # 0-d bool: any (src, dst) bucket overflowed


def _quantize_rows(v: torch.Tensor):
    """float (N, ...) -> (int8 payload, float32 per-row scale) for the wire."""
    vf = v.to(torch.float32)
    flat = vf.reshape(v.shape[0], -1)
    # the reference divides by 127.0, which XLA turns into a multiply by the
    # float32 reciprocal; the port multiplies by it too, bit for bit
    scale = flat.abs().amax(dim=-1) * torch.tensor(1 / 127.0, dtype=torch.float32, device=v.device)
    floor = torch.tensor(1e-12, dtype=torch.float32, device=v.device)
    q = torch.round(vf / torch.maximum(scale, floor).reshape((-1,) + (1,) * (v.dim() - 1)))
    return q.to(torch.int8), scale


def _dequantize_rows(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale.reshape((-1,) + (1,) * (q.dim() - 1))).to(dtype)


class _CompressedAllToAll(torch.autograd.Function):
    """int8-on-the-wire ``all_to_all`` of a flat (P * row, ...) slab, with a
    straight-through backward.

    Forward ships (int8 payload, float32 per-row scale).  ``round`` has zero
    gradient, so the backward carries the cotangent through the plain
    (self-transpose) ``all_to_all``, uncompressed.
    """

    @staticmethod
    def forward(ctx, v: torch.Tensor, group: AxisGroup, row: int) -> torch.Tensor:
        ctx.group, ctx.row = group, row
        P_ = group.size
        q, s = _quantize_rows(v)
        rq = group.all_to_all(q.reshape((P_, row) + v.shape[1:]))
        rs = group.all_to_all(s.reshape(P_, row))
        return _dequantize_rows(rq.reshape((P_ * row,) + v.shape[1:]), rs.reshape(-1), v.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        P_, row = ctx.group.size, ctx.row
        back = ctx.group.all_to_all(g.reshape((P_, row) + g.shape[1:]))
        return back.reshape((P_ * row,) + g.shape[1:]), None, None


def partition_exchange(
    keys: torch.Tensor,
    values: Any,
    bucket_ids: Optional[torch.Tensor],
    group: AxisGroup,
    *,
    capacity: int,
    n_buckets: Optional[int] = None,
    compress: bool = False,
    partition: Optional[str] = None,
    oversample: Optional[int] = None,
) -> ExchangeResult:
    """Ship every element to the rank owning its bucket.

    keys: (m,); values: a nest of (m, ...) tensors moved alongside (or
    None); bucket_ids: (m,) int32 in [0, n_buckets).  ``n_buckets`` defaults
    to the group size P and must be a multiple of it; buckets map to ranks
    contiguously (rank = bucket * P // n_buckets), so bucket order is rank
    order.  ``capacity`` is per (sender, bucket).

    ``bucket_ids=None`` derives the ids from ``partition``: ``"radix"``
    auto-ranged equal-width buckets, ``"sample"`` balanced composite
    splitters (arrival-order tie ids whenever ``values`` travel).

    ``compress=True`` ships float value payloads as int8 with a float32
    scale per slot, straight-through for autograd.  Integer leaves always
    travel uncompressed.

    Returns slabs of shape (P, B_loc * capacity): row j = what rank j sent
    me, laid out as (B_loc, capacity) for my local buckets.
    """
    P_ = group.size
    m = keys.shape[-1]
    C = capacity
    B = P_ if n_buckets is None else n_buckets
    if B % P_:
        raise ValueError(f"n_buckets={B} must be a multiple of the group size {P_}")
    if bucket_ids is None:
        if partition == "radix":
            bucket_ids = radix_bucket_ids(keys, B, group)
        elif partition == "sample":
            kw = {} if oversample is None else {"oversample": oversample}
            bucket_ids = sample_partition_ids(keys, B, group, stable=values is not None, **kw)
        else:
            raise ValueError(
                f"bucket_ids=None needs partition in ('radix', 'sample'), got {partition!r}"
            )
    device = keys.device
    sent = sentinel_for(keys.dtype, largest=True).item()

    # --- group by bucket (stable: preserves arrival order per bucket) ---
    order = torch.argsort(bucket_ids, stable=True)
    sorted_bkt = bucket_ids[order].to(torch.int32)
    # the reference's bincount, read off the sorted ids: B + 1 binary
    # searches, where a histogram of m ids into a few bins contends on them
    starts = torch.searchsorted(sorted_bkt, torch.arange(B + 1, dtype=torch.int32, device=device))
    offsets = starts[:-1].to(torch.int32)
    counts = (starts[1:] - starts[:-1]).to(torch.int32)
    pos_in_bucket = torch.arange(m, dtype=torch.int32, device=device) - offsets[sorted_bkt.long()]
    valid = pos_in_bucket < C
    # slot B*C is the drop slot: torch has no scatter that drops out-of-range
    # indices (on the card one is a device-side assert), so every slab has
    # one slot more and loses it after the scatter
    slot_sorted = torch.where(valid, sorted_bkt * C + pos_in_bucket, B * C).long()

    # --- build the fixed-capacity send slab ---
    slab_keys = torch.full((B * C + 1,), sent, dtype=keys.dtype, device=device)
    slab_keys = slab_keys.index_put((slot_sorted,), keys[order])[: B * C]

    def to_slab(v):
        buf = torch.zeros((B * C + 1,) + v.shape[1:], dtype=v.dtype, device=device)
        return buf.index_put((slot_sorted,), v[order])[: B * C]

    slab_values = None if values is None else tree_map(to_slab, values)

    # remember where each original element went (for combine_exchange)
    send_slot = torch.full((m,), -1, dtype=torch.int32, device=device)
    send_slot[order] = torch.where(valid, slot_sorted, -1).to(torch.int32)
    # receiver-side validity rides along as slot ids (-1 = padding)
    slab_src_slot = torch.full((B * C + 1,), -1, dtype=torch.int32, device=device)
    slab_src_slot = slab_src_slot.index_put((slot_sorted,), slot_sorted.to(torch.int32))[: B * C]

    # --- the one MSD-radix all_to_all (paper Fig 4 arrow: master -> nodes) ---
    row = (B // P_) * C

    def a2a(v):
        return group.all_to_all(v.reshape((P_, row) + v.shape[1:]))

    recv_keys = a2a(slab_keys)
    recv_src_slot = a2a(slab_src_slot)
    if values is None:
        recv_values = None
    elif compress:
        # int8 quantization is lossy and only meaningful for float payloads;
        # integer leaves (indices, ids) ship uncompressed to stay exact
        recv_values = tree_map(
            lambda v: (
                _CompressedAllToAll.apply(v, group, row).reshape((P_, row) + v.shape[1:])
                if v.dtype.is_floating_point
                else a2a(v)
            ),
            slab_values,
        )
    else:
        recv_values = tree_map(a2a, slab_values)

    overflow = group.pmax((counts.max() > C).to(torch.int32)).bool()
    return ExchangeResult(
        recv_keys=recv_keys,
        recv_values=recv_values,
        recv_src_slot=recv_src_slot,
        send_slot=send_slot,
        counts=counts,
        overflow=overflow,
    )


def combine_exchange(processed: Any, ex: ExchangeResult, group: AxisGroup, *, fill=0) -> Any:
    """Inverse exchange: return processed (P, C, ...) slabs to their senders
    and restore the original element order.  Dropped (overflowed) elements
    get ``fill``."""
    returned = tree_map(group.all_to_all, processed)  # back in sender layout
    m = ex.send_slot.shape[0]

    def gather(v):
        flat = v.reshape((v.shape[0] * v.shape[1],) + v.shape[2:])
        safe = ex.send_slot.clamp(0, flat.shape[0] - 1).long()
        out = flat[safe]
        mask = (ex.send_slot >= 0).reshape((m,) + (1,) * (out.dim() - 1))
        return torch.where(mask, out, torch.tensor(fill, dtype=out.dtype, device=out.device))

    return tree_map(gather, returned)
