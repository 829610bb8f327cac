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
  biases) column-parallel, ``wo`` / ``w_out`` row-parallel.  Three
  exceptions (``tp_layout``): where the heads do not divide "model"
  (qwen2-7b's 28 at 16, the case the reference pins apart,
  ``repro/models/transformer.py:439``) the attention weights are gathered
  whole and every rank of a model group runs every head; where the KV
  heads do not divide it (GQA with fewer KV heads than ranks) ``wk`` /
  ``wv`` are gathered whole and each rank slices the KV heads its query
  heads read; Mamba-2 blocks are gathered whole (their split over "model"
  is queued);
* ``gather_leaf`` takes a leaf from its stored block to its compute
  layout (an all-gather over the axes it is stored over but not computed
  over), and in the backward reduces the gradient back to the block: a
  reduce-scatter over a batch axis the leaf is stored over, a sum over a
  batch axis it is replicated over.  A leaf computed split over "model"
  gets its own block's gradient there.  A leaf gathered whole over
  "model" whose every rank computes the same thing (the whole-heads
  attention, Mamba) holds the whole gradient on each rank and keeps its
  slice; one whose ranks each compute their own share (the router, on
  each rank's own tokens; under split heads the qk-norm scales and whole
  ``wk`` / ``wv``, on each rank's heads) is summed over "model" and
  reduce-scattered back.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

__all__ = [
    "batch_specs",
    "block_slices",
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


# ------------------------------------------------------------------ rules ---
def _param_spec(names: tuple, leaf) -> tuple:
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
    included)."""
    return map_with_path(_param_spec, params)


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
    shard heads and channels over "model"."""
    bt = ("pod", "data")

    def one(path, leaf):
        kind = cfg.pattern[int(path[0][3:])]  # "posN"
        nd = _ndim(leaf)
        if kind.startswith("attn"):
            if nd == 5:  # (G, B, S, Hk, hd) k or v
                return (None, bt, "model", None, None)
            return (None,)  # (G,) length
        if nd == 4:  # (G, B, k-1, conv_dim)
            return (None, bt, None, "model")
        return (None, bt, "model", None, None)  # (G, B, nh, ds, hp)

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
            if ax in valid and rem % mesh.shape[ax] == 0:
                kept.append(ax)
                rem //= mesh.shape[ax]
        out.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    return tuple(out)


def fit_tree(specs, tree, mesh) -> Any:
    """Every spec fitted to its leaf's (whole) shape."""
    return map_with_path(lambda _, leaf, s: fit_spec(tuple(leaf.shape), s, mesh), tree, specs)


class TPLayout(NamedTuple):
    """What a dense layer splits over "model" (module docstring)."""
    heads: bool       # attention heads: wq / wo column / row-parallel
    kv_heads: bool    # wk / wv too (else gathered whole)
    ffn: bool         # the dense FFN's hidden units


def tp_layout(cfg, model: int) -> TPLayout:
    """The tensor-parallel layout of ``cfg`` over a "model" axis of
    ``model`` ranks: a split wherever it divides.

    >>> from repro_torch.configs.base import ARCHS
    >>> tp_layout(ARCHS["qwen3-0.6b"], 16), tp_layout(ARCHS["qwen2-7b"], 16).heads
    (TPLayout(heads=True, kv_heads=False, ffn=True), False)
    """
    heads = cfg.n_heads > 0 and cfg.n_heads % model == 0
    return TPLayout(heads, heads and cfg.n_kv_heads % model == 0,
                    cfg.d_ff > 0 and cfg.d_ff % model == 0)


def _layer(path) -> str:
    """The linear a leaf belongs to (``wq`` for ``.../wq/w``), else its name."""
    return path[-2] if path[-1] in ("w", "b") and len(path) > 1 else path[-1]


def _split_over_model(path, tp: TPLayout) -> bool:
    if "table" in path or ("moe" in path and path[-1] in ("w_in", "w_gate", "w_out")):
        return True
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
        keep = _split_over_model(path, tp)
        return tuple(e if keep and spec_axes(e) == (ep_axis,) else None for e in spec)

    return map_with_path(one, specs)


# ---------------------------------------------------------------- blocks ---
def block_slices(shape, spec: tuple, mesh) -> tuple:
    """The slices that cut this rank's block from a whole leaf of ``shape``
    under the fitted ``spec`` (an entry's first axis the major one)."""
    out = []
    for dim, entry in enumerate(spec):
        idx, count = 0, 1
        for ax in spec_axes(entry):
            idx = idx * mesh.shape[ax] + mesh.coords[ax]
            count *= mesh.shape[ax]
        size = shape[dim] // count
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def shard_tree(tree, specs, mesh) -> Any:
    """This rank's block of every leaf of ``tree`` (whole leaves), each
    spec fitted to its leaf's shape first.  Blocks are copies, so the whole
    leaves can be freed."""
    def one(_, leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return leaf[block_slices(leaf.shape, fit_spec(tuple(leaf.shape), spec, mesh), mesh)].clone()

    return map_with_path(one, tree, specs)


def _gather(t: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    for ax in reversed(axes):  # the minor axis first
        t = mesh.group(ax).gather(t, dim)
    return t


@torch.no_grad()
def unshard_tree(tree, specs, mesh) -> Any:
    """The whole leaves from every rank's blocks: an all-gather of each
    leaf over the axes of its (fitted) spec, on every rank."""
    def one(_, leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        for dim, entry in enumerate(spec):
            axes = [a for a in spec_axes(entry) if mesh.shape[a] > 1]
            if axes:
                leaf = _gather(leaf.contiguous(), dim, axes, mesh)
        return leaf

    return map_with_path(one, tree, specs)


# -------------------------------------------------- gathers for the step ---
class _Plan:
    """How one leaf goes from its stored block to its compute layout and
    how its gradient comes back."""

    def __init__(self, stored: tuple, compute: tuple, mesh, ep_axis: str, sum_ep: bool):
        self.mesh = mesh
        self.gather = []       # (dim, axes) to all-gather, major axis first
        gathered = {}
        for dim, (s, c) in enumerate(zip(stored, compute)):
            axes = [a for a in spec_axes(s) if a not in spec_axes(c) and mesh.shape[a] > 1]
            if axes:
                self.gather.append((dim, axes))
                gathered.update({a: dim for a in axes})
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
        return not (self.gather or self.psum)

    def forward(self, block: torch.Tensor) -> torch.Tensor:
        t = block
        for dim, axes in self.gather:
            t = _gather(t.contiguous(), dim, axes, self.mesh)
        return t

    def backward(self, g: torch.Tensor) -> torch.Tensor:
        dtype = g.dtype
        g = g.float()
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

