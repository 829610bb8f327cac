"""Layout rules: specs for params, optimizer state, caches and batches, and
the per-rank blocks they describe.

Counterpart of ``repro/distributed/sharding.py``.  The parallelism profile
is the reference's: batch over ("pod", "data"); the vocabulary and the
experts over "model"; parameters FSDP x TP over ("data", "model").  A spec
is a tuple with one entry per dim: ``None`` (replicated), an axis name, or
a tuple of axis names (the first the major one), as ``PartitionSpec`` is.
Rules are by name on the param tree's paths; every leaf gets a spec.

The reference hands its specs to XLA, which places the data and inserts
the gathers.  Here every rank is a process that holds its own block:

* ``shard_tree`` cuts this rank's block of every leaf (``fit_spec`` drops
  the axes that do not divide a dim, as the reference's does), and
  ``unshard_tree`` puts the whole leaves back together (a collective);
* ``compute_specs`` is the layout the model stack computes in: the stored
  spec without its batch axes, which FSDP gathers.  "model" stays where
  the stored spec has it: the embedding table vocab-sharded, the expert
  stacks expert-sharded, and Megatron tensor parallelism in the dense
  layers: ``wq`` / ``wk`` / ``wv`` / ``w_in`` / ``w_gate`` (and their
  biases) column-parallel, ``wo`` / ``w_out`` row-parallel; in Mamba-2
  blocks ``in_proj`` and the conv column-parallel by heads, ``out_proj``
  row-parallel, and the per-head vectors (``A_log``, ``D_skip``,
  ``dt_bias``) and the gated norm's scale split by heads too.  Two
  exceptions where a split does not divide (``tp_layout``): where the
  heads do not divide "model" (qwen2-7b's 28 at 16, the case the
  reference pins apart, ``repro/models/transformer.py:439``) the
  attention weights are gathered whole and every rank of a model group
  runs every head, and where the KV heads do not divide it (GQA with
  fewer KV heads than ranks) ``wk`` / ``wv`` are gathered whole and each
  rank slices the KV heads its query heads read; a Mamba-2 block whose
  SSM heads (or ``B`` / ``C`` width) do not divide "model" is gathered
  whole, every rank running every head;
* a Mamba-2 block's ``in_proj`` columns are ``(z, x, B, C, dt)`` and its
  conv channels ``(x, B, C)``: a rank's heads are not a contiguous block
  of either.  Their "model" entry is a ``SegmentedAxis``: rank ``r``
  stores the ``r``-th piece of every segment (its heads' ``z``, ``x``
  and ``dt`` columns and ``1/model`` of ``B`` and ``C``), so every leaf
  stays evenly split, and computes with ``B`` / ``C`` whole (all-gathered
  over "model", their gradient reduce-scattered back).  Whole leaves
  (``unshard_tree``, checkpoints, the reference's arrays) stay in the
  reference's column order; ``take_block`` cuts a block of one;
* ``gather_leaf`` takes a leaf from its stored block to its compute
  layout (an all-gather over the axes it is stored over but not computed
  over), and in the backward reduces the gradient back to the block: a
  reduce-scatter over a batch axis the leaf is stored over, a sum over a
  batch axis it is replicated over.  A leaf computed split over "model"
  gets its own block's gradient there, and one stored whole but computed
  split (the Mamba per-head vectors) gets every rank's slice gathered
  back.  A leaf gathered whole over "model" whose every rank computes the
  same thing (the whole-heads attention and Mamba blocks) holds the whole
  gradient on each rank and keeps its slice; one whose ranks each compute
  their own share (the router, on each rank's own tokens; under split
  heads the qk-norm scales and whole ``wk`` / ``wv``, on each rank's
  heads; Mamba's ``B`` / ``C`` columns) is summed over "model" and
  reduce-scattered back.
"""
from __future__ import annotations

import math
from functools import lru_cache, partial
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "SegmentedAxis",
    "batch_specs",
    "block_index",
    "cache_specs",
    "compute_specs",
    "fit_spec",
    "fit_tree",
    "gather_leaf",
    "gather_tree",
    "map_with_path",
    "opt_state_specs",
    "param_specs",
    "replication",
    "shard_tree",
    "spec_axes",
    "splits_positions",
    "take_block",
    "tp_layout",
    "unshard_tree",
    "TPLayout",
]


# ------------------------------------------------------------ tree walking ---
def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def map_with_path(fn, tree, *others, path=()):
    """``tree``'s structure (nested dicts and namedtuples) with each leaf
    replaced by ``fn(path, leaf, *others_at_path)``; ``others`` are walked
    along ``tree``'s structure, so their leaves may be tuples (specs)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(o[k] for o in others), path=path + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, v, *(o[i] for o in others), path=path + (f,))
                            for i, (f, v) in enumerate(zip(tree._fields, tree))))
    return fn(path, tree, *others)


def _ndim(leaf) -> int:
    return len(leaf.shape) if hasattr(leaf, "shape") else 0


def spec_axes(entry) -> tuple:
    """The axis names of one spec entry (``None``, a name or a tuple)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


# ------------------------------------------------------- segmented dims ---
class SegmentedAxis(str):
    """A mesh axis name on a dim made of segments of ``sizes``, each split
    evenly over the axis: rank ``r``'s block is the ``r``-th piece of every
    segment, in order, and all of each segment listed in ``whole``.  The
    segments in ``shared`` are read whole in the compute layout
    (``compute_specs``).

    It compares and hashes as the axis name, so every rule that reads a
    spec reads it as that axis.  It ``fits`` an axis of ``n`` ranks when
    ``n`` divides every size and every count in ``align``; where it does
    not, ``fit_spec`` puts ``fallback`` in its place (the plain axis name,
    a contiguous split, or ``None``).  Mamba-2's ``in_proj`` columns are
    ``(z, x, B, C, dt)``:

    >>> a = SegmentedAxis("model", (4, 4, 2, 2, 2))
    >>> a == "model", a.index(2, 1), a.with_whole((2, 3)).index(2, 1)
    (True, [2, 3, 6, 7, 9, 11, 13], [2, 3, 6, 7, 8, 9, 10, 11, 13])
    """

    def __new__(cls, name: str, sizes, whole=(), align=(), fallback: Optional[str] = "model",
                shared=()):
        self = super().__new__(cls, name)
        self.sizes, self.whole, self.align = tuple(sizes), tuple(whole), tuple(align)
        self.fallback, self.shared = fallback, tuple(shared)
        return self

    def __reduce__(self):
        return SegmentedAxis, (str(self), self.sizes, self.whole, self.align, self.fallback,
                               self.shared)

    def fits(self, n: int) -> bool:
        return all(s % n == 0 for s in self.sizes + self.align)

    def with_whole(self, whole) -> "SegmentedAxis":
        return SegmentedAxis(str(self), self.sizes, whole, self.align, self.fallback, self.shared)

    def index(self, n: int, r: int) -> list:
        """The positions in the whole dim of rank ``r``'s block of ``n``."""
        out, start = [], 0
        for i, s in enumerate(self.sizes):
            lo, hi = (0, s) if i in self.whole else (r * s // n, (r + 1) * s // n)
            out.extend(range(start + lo, start + hi))
            start += s
        return out


def _mamba_widths(tree) -> Optional[tuple]:
    """``(d_inner, n_groups * d_state, n_heads)`` of the Mamba-2 blocks in
    a param tree (read off their leaves' shapes), ``None`` if it has none."""
    if not isinstance(tree, dict):
        return None
    m = tree.get("mamba")
    if isinstance(m, dict):
        di, nh = m["norm"]["scale"].shape[-1], m["A_log"].shape[-1]
        return di, (m["conv_w"].shape[-1] - di) // 2, nh
    for v in tree.values():
        found = _mamba_widths(v)
        if found:
            return found
    return None


def _mamba_axis(names: tuple, widths: tuple) -> Optional[SegmentedAxis]:
    """The "model" entry of a Mamba-2 leaf split by heads: ``in_proj``'s
    columns ``(z, x, B, C, dt)``, the conv's channels ``(x, B, C)``."""
    di, gs, nh = widths
    if names[-1] in ("w", "b") and names[-2] == "in_proj":
        return SegmentedAxis("model", (di, di, gs, gs, nh), shared=(2, 3))
    if names[-1] in ("conv_w", "conv_b"):
        return SegmentedAxis("model", (di, gs, gs), align=(nh,), shared=(1, 2))
    return None


# ------------------------------------------------------------------ rules ---
def _param_spec(names: tuple, leaf, mamba: Optional[tuple] = None) -> tuple:
    spec = _reference_spec(names, leaf)
    axis = _mamba_axis(names, mamba) if mamba and "mamba" in names else None
    return spec if axis is None else tuple(axis if e == "model" else e for e in spec)


def _reference_spec(names: tuple, leaf) -> tuple:
    nd = _ndim(leaf)
    grouped = bool(names) and names[0] == "blocks"  # stacked (G, ...) leaves
    lead = (None,) if grouped else ()
    n = set(names)

    def spec(*axes):
        full = lead + tuple(axes)
        if len(full) != nd:
            raise ValueError(f"{names}: a spec of {len(full)} dims for a leaf of {nd}")
        return full

    if "table" in n:  # embedding (V, D): vocab-parallel, D replicated
        return spec("model", None)
    if "router" in n:  # (D, E) small, replicated
        return spec(*([None] * (nd - len(lead))))
    # MoE expert stacks: (E, D, F) / (E, F, D)
    if nd - len(lead) == 3 and ("w_in" in n or "w_gate" in n):
        return spec("model", "data", None)
    if nd - len(lead) == 3 and "w_out" in n:
        return spec("model", None, "data")
    if names[-1] == "w":
        parent = names[-2]
        if parent in ("wq", "wk", "wv", "w_in", "w_gate", "in_proj"):
            return spec("data", "model")
        if parent in ("wo", "w_out", "out_proj"):
            return spec("model", "data")
    if names[-1] == "b":
        parent = names[-2]
        if parent in ("wq", "wk", "wv", "w_in", "w_gate", "in_proj"):
            return spec("model")
        return spec(None)
    if "conv_w" in n:
        return spec(None, "model")
    if "conv_b" in n:
        return spec("model")
    # norms / scalars / small vectors (A_log, D_skip, dt_bias, scale)
    return spec(*((None,) * (nd - len(lead))))


def param_specs(params) -> Any:
    """A spec for every leaf of ``params`` (tensors of any device, ``meta``
    included, or arrays): the reference's, with the "model" entry of a
    Mamba-2 block's ``in_proj`` and conv a ``SegmentedAxis`` (module
    docstring)."""
    return map_with_path(partial(_param_spec, mamba=_mamba_widths(params)), params)


def _is_q(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def opt_state_specs(state: dict, pspecs) -> dict:
    """Specs of the AdamW state given the params': float32 moments and the
    error-feedback buffer follow their param; an int8 moment's ``q``
    follows its param and its row ``scale`` drops the last axis; ``count``
    is replicated."""
    def moment(tree, specs):
        if _is_q(tree):
            return {"q": specs, "scale": specs[:-1]}
        if isinstance(tree, dict):
            return {k: moment(v, specs[k]) for k, v in tree.items()}
        return specs

    out = {}
    for key, val in state.items():
        if key == "count":
            out[key] = ()
        elif key in ("m", "v"):
            out[key] = moment(val, pspecs)
        else:  # err buffers
            out[key] = pspecs
    return out


def cache_specs(cache, cfg) -> Any:
    """Specs of the decode cache: batch over ("pod", "data"); the sequence
    dim of attention caches over "model" (split-K decoding); Mamba states
    shard heads over "model", and the conv window its ``x`` channels by
    heads with the ``B`` / ``C`` channels whole on every rank (a
    ``SegmentedAxis``; the reference splits the channels contiguously).
    Where the heads do not split, the Mamba caches are whole."""
    bt = ("pod", "data")
    mc = cfg.mamba_cfg()
    di, gs, nh = mc.d_inner, mc.n_groups * mc.d_state, mc.n_heads
    conv = SegmentedAxis("model", (di, gs, gs), whole=(1, 2), align=(nh,), fallback=None)
    heads = SegmentedAxis("model", (nh,), align=(gs,), fallback=None)

    def one(path, leaf):
        kind = cfg.pattern[int(path[0][3:])]  # "posN"
        nd = _ndim(leaf)
        if kind.startswith("attn"):
            if nd == 5:  # (G, B, S, Hk, hd) k or v
                return (None, bt, "model", None, None)
            return (None,)  # (G,) length
        if nd == 4:  # (G, B, k-1, conv_dim)
            return (None, bt, None, conv)
        return (None, bt, heads, None, None)  # (G, B, nh, ds, hp)

    return map_with_path(one, cache)


def splits_positions(size: int, mesh, ep_axis: str = "model") -> bool:
    """Whether an attention cache of ``size`` positions holds one block of
    them on each rank of ``ep_axis`` (split-K): ``cache_specs``'s sequence
    entry fitted to ``size``.  Where the axis does not divide ``size`` the
    fitted spec drops it and the cache is replicated over it, as the
    reference's is."""
    return mesh.shape.get(ep_axis, 1) > 1 and ep_axis in spec_axes(
        fit_spec((size,), (ep_axis,), mesh)[0])


def batch_specs(batch: dict) -> Any:
    """Input batch: the leading (global batch) dim over ("pod", "data")."""
    return map_with_path(lambda _, leaf: (("pod", "data"),) + (None,) * (_ndim(leaf) - 1), batch)


def fit_spec(shape, spec: tuple, mesh) -> tuple:
    """``spec`` without the mesh axes that do not exist or do not divide
    their dim (B = 1 decode).

    >>> class M: axis_names = ("pod", "data"); shape = {"pod": 2, "data": 16}
    >>> fit_spec((2, 5), (("pod", "data"), None), M())
    ('pod', None)
    """
    valid = set(mesh.axis_names)
    out = []
    for dim, entry in enumerate(spec):
        kept, rem = [], shape[dim]
        for ax in spec_axes(entry):
            if isinstance(ax, SegmentedAxis) and ax in valid and not ax.fits(mesh.shape[ax]):
                ax = ax.fallback
            if ax in valid and rem % mesh.shape[ax] == 0:
                kept.append(ax)
                rem //= mesh.shape[ax]
        out.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    return tuple(out)


def fit_tree(specs, tree, mesh) -> Any:
    """Every spec fitted to its leaf's (whole) shape."""
    return map_with_path(lambda _, leaf, s: fit_spec(tuple(leaf.shape), s, mesh), tree, specs)


class TPLayout(NamedTuple):
    """What a layer splits over "model" (module docstring)."""
    heads: bool       # attention heads: wq / wo column / row-parallel
    kv_heads: bool    # wk / wv too (else gathered whole)
    ffn: bool         # the dense FFN's hidden units
    mamba: bool = False  # Mamba-2's SSM heads (B / C whole on every rank)


def tp_layout(cfg, model: int) -> TPLayout:
    """The tensor-parallel layout of ``cfg`` over a "model" axis of
    ``model`` ranks: a split wherever it divides (Mamba-2: the SSM heads
    and the ``B`` / ``C`` width, ``SegmentedAxis.fits``).

    >>> from repro_torch.configs.base import ARCHS
    >>> tp_layout(ARCHS["qwen3-0.6b"], 16), tp_layout(ARCHS["qwen2-7b"], 16).heads
    (TPLayout(heads=True, kv_heads=False, ffn=True, mamba=False), False)
    >>> tp_layout(ARCHS["jamba-1.5-large-398b"], 16).mamba
    True
    """
    heads = cfg.n_heads > 0 and cfg.n_heads % model == 0
    mc = cfg.mamba_cfg()
    mamba = "mamba" in cfg.pattern and mc.n_heads % model == 0 \
        and (mc.n_groups * mc.d_state) % model == 0
    return TPLayout(heads, heads and cfg.n_kv_heads % model == 0,
                    cfg.d_ff > 0 and cfg.d_ff % model == 0, mamba)


def _layer(path) -> str:
    """The linear a leaf belongs to (``wq`` for ``.../wq/w``), else its name."""
    return path[-2] if path[-1] in ("w", "b") and len(path) > 1 else path[-1]


_MAMBA_SPLIT = ("in_proj", "out_proj", "conv_w", "conv_b")  # stored over "model" too
_MAMBA_HEADS = ("A_log", "D_skip", "dt_bias", "scale")    # stored whole, computed split


def _split_over_model(path, tp: TPLayout) -> bool:
    if "table" in path or ("moe" in path and path[-1] in ("w_in", "w_gate", "w_out")):
        return True
    if "mamba" in path:
        return tp.mamba and _layer(path) in _MAMBA_SPLIT
    if "attn" in path:
        return tp.heads and (_layer(path) in ("wq", "wo")
                             or (tp.kv_heads and _layer(path) in ("wk", "wv")))
    return "ffn" in path and tp.ffn


def _sums_over_model(path, tp: TPLayout) -> bool:
    """Leaves held whole over "model" whose ranks each compute their own
    share, so their gradient sums there: the router; under split heads the
    qk-norms and whole wk / wv."""
    if "router" in path:
        return True
    if "attn" not in path or not tp.heads:
        return False
    return "q_norm" in path or "k_norm" in path or (not tp.kv_heads
                                                    and _layer(path) in ("wk", "wv"))


def compute_specs(specs, cfg, model: int, ep_axis: str = "model") -> Any:
    """The layout the model stack computes in (module docstring): ``specs``
    without their batch axes, ``ep_axis`` kept on the leaves that
    ``tp_layout(cfg, model)`` splits over it."""
    tp = tp_layout(cfg, model)

    def one(path, spec):
        if tp.mamba and "mamba" in path and _layer(path) in _MAMBA_HEADS:
            return (None,) * (len(spec) - 1) + (ep_axis,)  # this rank's heads
        keep = _split_over_model(path, tp)
        out = tuple(e if keep and spec_axes(e) == (ep_axis,) else None for e in spec)
        # a Mamba rank reads B and C whole
        return tuple(e.with_whole(e.shared) if isinstance(e, SegmentedAxis) else e for e in out)

    return map_with_path(one, specs)


# ---------------------------------------------------------------- blocks ---
def block_index(shape, spec: tuple, mesh) -> tuple:
    """What cuts this rank's block from a whole leaf of ``shape`` under the
    fitted ``spec``, a dim at a time: a slice (an entry's first axis the
    major one), or for a ``SegmentedAxis`` the list of positions it
    takes."""
    out = []
    for dim, entry in enumerate(spec):
        if isinstance(entry, SegmentedAxis):
            out.append(entry.index(mesh.shape[entry], mesh.coords[entry]))
            continue
        idx, count = 0, 1
        for ax in spec_axes(entry):
            idx = idx * mesh.shape[ax] + mesh.coords[ax]
            count *= mesh.shape[ax]
        size = shape[dim] // count
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def take_block(a, spec: tuple, mesh):
    """This rank's block of ``a`` (a whole tensor or numpy array) under the
    fitted ``spec``; a copy where it takes segments, else a view."""
    for dim, ix in enumerate(block_index(a.shape, spec, mesh)):
        if isinstance(ix, slice):
            a = a[(slice(None),) * dim + (ix,)]
        elif isinstance(a, torch.Tensor):
            a = a.index_select(dim, torch.tensor(ix, device=a.device))
        else:
            a = np.take(a, ix, axis=dim)
    return a


def shard_tree(tree, specs, mesh) -> Any:
    """This rank's block of every leaf of ``tree`` (whole leaves), each
    spec fitted to its leaf's shape first.  Blocks are copies, so the whole
    leaves can be freed."""
    def one(_, leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return take_block(leaf, fit_spec(tuple(leaf.shape), spec, mesh), mesh).clone()

    return map_with_path(one, tree, specs)


def _gather(t: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    for ax in reversed(axes):  # the minor axis first
        t = mesh.group(ax).gather(t, dim)
    return t


def _segments_source(entry: SegmentedAxis, n: int) -> list:
    """For each position of the whole dim, its position among the ``n``
    ranks' blocks laid end to end (rank 0's first where several hold it)."""
    src = {}
    for r in reversed(range(n)):
        idx = entry.index(n, r)
        for j, w in enumerate(idx):
            src[w] = r * len(idx) + j
    return [src[w] for w in range(sum(entry.sizes))]


@torch.no_grad()
def unshard_tree(tree, specs, mesh) -> Any:
    """The whole leaves from every rank's blocks: an all-gather of each
    leaf over the axes of its (fitted) spec, on every rank; the positions
    of a ``SegmentedAxis`` dim put back in the whole dim's order."""
    def one(_, leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        for dim, entry in enumerate(spec):
            axes = [a for a in spec_axes(entry) if mesh.shape[a] > 1]
            if axes:
                leaf = _gather(leaf.contiguous(), dim, axes, mesh)
            if axes and isinstance(entry, SegmentedAxis):
                src = _segments_source(entry, mesh.shape[entry])
                leaf = leaf.index_select(dim, torch.tensor(src, device=leaf.device))
        return leaf

    return map_with_path(one, tree, specs)


# -------------------------------------------------- gathers for the step ---
class _Segments:
    """The all-gather over "model" of the segments a rank stores a piece of
    and computes with whole (``stored`` -> ``compute``, two layouts of one
    dim), and the reduce-scatter of their gradient back.  Each layout is
    cut from the other as runs of positions (narrowed views, one ``cat``:
    a step copies no index from the host); a gathered piece's gradient is
    every rank's sum."""

    def __init__(self, dim: int, stored: SegmentedAxis, compute: SegmentedAxis, group):
        self.dim, self.group = dim, group
        self.sel, self.fwd, self.rs, self.back = _segment_maps(
            stored.sizes, stored.whole, compute.whole, group.size, group.rank)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        d = self.dim
        pieces = self.group.gather(_take(t, d, self.sel), d)
        return _take(torch.cat([t, pieces], d), d, self.fwd)

    def backward(self, g: torch.Tensor) -> torch.Tensor:
        d = self.dim
        summed = self.group.reduce_scatter(_take(g, d, self.rs), d)
        return _take(torch.cat([g, summed], d), d, self.back)


def _take(t: torch.Tensor, dim: int, runs: tuple) -> torch.Tensor:
    """The positions ``runs`` (``(start, length)`` pairs) of ``t``'s
    ``dim``, in order."""
    return torch.cat([t.narrow(dim, a, n) for a, n in runs], dim)


def _runs(ix: list) -> tuple:
    """``ix`` as runs of consecutive positions: ``((start, length), ...)``."""
    out = []
    for w in ix:
        if out and out[-1][0] + out[-1][1] == w:
            out[-1][1] += 1
        else:
            out.append([w, 1])
    return tuple((a, n) for a, n in out)


@lru_cache(maxsize=None)
def _segment_maps(sizes: tuple, stored_whole: tuple, compute_whole: tuple, n: int, r: int):
    """``_Segments``' runs: the stored block's positions it sends
    (``sel``); the compute block from the stored block and the gathered
    pieces (``fwd``); the compute block's positions of every rank's pieces
    (``rs``); the stored block from the compute block and the summed
    pieces (``back``)."""
    stored = SegmentedAxis("", sizes, stored_whole)
    mine = stored.index(n, r)
    want = stored.with_whole(compute_whole).index(n, r)
    starts = np.cumsum((0,) + sizes)
    shared = np.zeros(starts[-1], bool)
    for i in set(compute_whole) - set(stored_whole):
        shared[starts[i]:starts[i + 1]] = True
    sel = [j for j, w in enumerate(mine) if shared[w]]
    gathered = [w for q in range(n) for w in stored.index(n, q) if shared[w]]
    src = {w: len(mine) + j for j, w in enumerate(gathered)}
    src.update({w: j for j, w in enumerate(mine)})
    pos = {w: j for j, w in enumerate(want)}
    own = {mine[j]: k for k, j in enumerate(sel)}
    return tuple(map(_runs, (sel, [src[w] for w in want], [pos[w] for w in gathered],
                             [len(want) + own[w] if w in own else pos[w] for w in mine])))


class _Plan:
    """How one leaf goes from its stored block to its compute layout and
    how its gradient comes back."""

    def __init__(self, stored: tuple, compute: tuple, mesh, ep_axis: str, sum_ep: bool):
        self.mesh = mesh
        self.gather = []       # (dim, axes) to all-gather, major axis first
        self.narrow = []       # dims stored whole over ep_axis and computed split
        self.segments = None   # a _Segments over ep_axis
        gathered = {}
        ep_size = mesh.shape.get(ep_axis, 1)
        for dim, (s, c) in enumerate(zip(stored, compute)):
            axes = [a for a in spec_axes(s) if a not in spec_axes(c) and mesh.shape[a] > 1]
            if axes:
                self.gather.append((dim, axes))
                gathered.update({a: dim for a in axes})
            if ep_size > 1 and ep_axis in spec_axes(c) and ep_axis not in spec_axes(s):
                self.narrow.append(dim)
            if ep_size > 1 and isinstance(c, SegmentedAxis) and set(c.whole) - set(s.whole):
                self.segments = _Segments(dim, s, c, mesh.group(ep_axis))
        batch = [a for a in mesh.axis_names if a != ep_axis and mesh.shape[a] > 1]
        self.scatter = [(gathered[a], a) for a in batch if a in gathered]
        self.psum = tuple(a for a in batch if a not in gathered)
        if ep_axis in mesh.shape and mesh.shape[ep_axis] > 1 and sum_ep and ep_axis not in gathered:
            self.psum += (ep_axis,)
        self.ep_psum_then_split = sum_ep and ep_axis in gathered
        self.ep_axis = ep_axis
        self.split = gathered.get(ep_axis)

    @property
    def trivial(self) -> bool:
        return not (self.gather or self.psum or self.narrow or self.segments)

    def forward(self, block: torch.Tensor) -> torch.Tensor:
        t = block
        for dim, axes in self.gather:
            t = _gather(t.contiguous(), dim, axes, self.mesh)
        if self.segments is not None:
            t = self.segments.forward(t)
        for dim in self.narrow:
            t = self.mesh.group(self.ep_axis).split(t, dim).clone()
        return t

    def backward(self, g: torch.Tensor) -> torch.Tensor:
        dtype = g.dtype
        g = g.float()
        for dim in self.narrow:  # every rank's slice of a leaf stored whole
            g = self.mesh.group(self.ep_axis).gather(g.contiguous(), dim)
        if self.segments is not None:
            g = self.segments.backward(g)
        for dim, ax in self.scatter:
            g = self.mesh.group(ax).reduce_scatter(g, dim)
        if self.psum:
            g = self.mesh.group(self.psum).psum(g)
        if self.split is not None:
            group = self.mesh.group(self.ep_axis)
            if self.ep_psum_then_split:
                g = group.reduce_scatter(g, self.split)
            else:
                g = group.split(g, self.split)
        return g.to(dtype).contiguous()


class _GatherLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, plan):
        ctx.plan = plan
        return plan.forward(block)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan.backward(g), None


def gather_leaf(block: torch.Tensor, stored: tuple, compute: tuple, mesh, *,
                ep_axis: str = "model", sum_ep: bool = False) -> torch.Tensor:
    """``block`` (stored under the fitted spec ``stored``) in the layout
    ``compute``; differentiable, the gradient reduced back to the block
    (module docstring).  ``sum_ep`` sums the gradient over ``ep_axis``: for
    a leaf replicated there that computes on each rank's own tokens (the
    router)."""
    plan = _Plan(stored, compute, mesh, ep_axis, sum_ep)
    if plan.trivial and plan.split is None:
        return block
    return _GatherLeaf.apply(block, plan)


def gather_tree(tree, stored_specs, mesh, cfg, *, ep_axis: str = "model") -> Any:
    """Every leaf of ``tree`` (stored blocks) in the compute layout of
    ``cfg``, through ``gather_leaf``; the gradients of the leaves whose
    ranks each compute their own share sum over ``ep_axis`` (module
    docstring)."""
    model = mesh.shape.get(ep_axis, 1)
    cspecs = compute_specs(stored_specs, cfg, model, ep_axis)
    tp = tp_layout(cfg, model)

    def one(path, leaf, stored, compute):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return gather_leaf(leaf, stored, compute, mesh, ep_axis=ep_axis,
                           sum_ep=_sums_over_model(path, tp))

    return map_with_path(one, tree, stored_specs, cspecs)


def replication(spec: tuple, mesh) -> int:
    """How many ranks hold each element of a leaf stored under ``spec``."""
    held = {a for e in spec for a in spec_axes(e)}
    return math.prod(s for a, s in mesh.shape.items() if a not in held)

