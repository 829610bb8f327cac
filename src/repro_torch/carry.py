"""Carrying the reference's state across: data, weights, caches and plans.

What crosses between ``repro`` (JAX) and ``repro_torch`` is the data, as
numpy arrays; the model's parameter tree, its optimizer state and its
decode caches (the
reference draws its random weights from ``jax.random``, which the port
cannot repeat, so parity tests carry them over); the sort plan, as the dict
``SortPlan.to_dict()`` gives; and the plan-cache file (tuned plans and
learned capacity factors), the state a serving process carries across
restarts.  The dtype is kept exactly, bfloat16 included
(numpy holds it as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
refuses, so it travels as its 16-bit pattern).

``as_tensor`` is how the front doors place numpy arrays and lists: on
``device``, which defaults to the card, and with no card that raises rather
than running on the CPU.
"""
from __future__ import annotations

import json
import os
from dataclasses import replace

import numpy as np
import torch

__all__ = [
    "as_tensor",
    "cache_from_reference",
    "check_device",
    "opt_state_from_reference",
    "params_from_reference",
    "plan_from_reference",
    "planner_from_reference",
    "shard_from_reference",
    "tensor_from_reference",
    "tensor_to_reference",
]

# local-sort names that differ between the packages: the reference's Pallas
# kernel is the port's hand-written CUDA kernel
_IMPL_NAMES = {"pallas": "kernel"}


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device with no card raises
    rather than running on the CPU.  A bare ``"cuda"`` gets the current
    card's index, so threads that enter it reach the same card.

    >>> check_device("cpu")
    device(type='cpu')
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def tensor_from_reference(a: np.ndarray, device="cuda") -> torch.Tensor:
    """A numpy array as a tensor of the same dtype and bits on ``device``.

    >>> t = tensor_from_reference(np.array([1.5, -0.0], np.float32), "cpu")
    >>> t.dtype, t.tolist()
    (torch.float32, [1.5, -0.0])
    """
    device = check_device(device)
    a = np.require(a, requirements=["C", "W"])  # torch needs writable memory
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def tensor_to_reference(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array of the same dtype and bits (host copy).

    >>> tensor_to_reference(torch.tensor([2, 1], dtype=torch.int32)).tolist()
    [2, 1]
    """
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16 type; needed only for this dtype

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def as_tensor(x, device="cuda") -> torch.Tensor:
    """``x`` itself if it is a tensor (it runs where it lives), else ``x`` as
    an array placed on ``device``.

    >>> as_tensor([3, 1], "cpu").tolist()
    [3, 1]
    """
    if isinstance(x, torch.Tensor):
        return x
    return tensor_from_reference(np.asarray(x), device)


def params_from_reference(tree, device="cuda"):
    """The reference's parameter tree (nested dicts of arrays: numpy, or
    anything ``np.asarray`` reads) as the port's, the same keys and layout,
    every leaf as ``tensor_from_reference`` places it.

    >>> p = params_from_reference({"embed": {"table": np.ones((2, 3), np.float32)}}, "cpu")
    >>> p["embed"]["table"].shape
    torch.Size([2, 3])
    """
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    return tensor_from_reference(np.asarray(tree), device)


def opt_state_from_reference(state: dict, device="cuda") -> dict:
    """The reference's AdamW state (``{"m", "v", "count"}`` and, under
    ``compress_grads``, ``"err"``) as the port's: float32 moments, or int8
    ``{"q", "scale"}`` moments, in the params' layout, every leaf as
    ``tensor_from_reference`` places it.

    >>> s = opt_state_from_reference({"m": {"w": {"q": np.zeros((2, 3), np.int8),
    ...                                            "scale": np.ones(2, np.float32)}},
    ...                               "v": {"w": {"q": np.zeros((2, 3), np.int8),
    ...                                           "scale": np.ones(2, np.float32)}},
    ...                               "count": np.int32(4)}, "cpu")
    >>> s["m"]["w"]["q"].dtype, int(s["count"])
    (torch.int8, 4)
    """
    unknown = set(state) - {"m", "v", "count", "err"}
    if unknown or not {"m", "v", "count"} <= set(state):
        raise ValueError(f"not an AdamW state: keys {sorted(state)}")
    return params_from_reference(state, device)


def shard_from_reference(tree, specs, mesh, device="cuda"):
    """This rank's block of the reference's params or optimizer state
    (nested dicts of arrays) under ``specs`` (``distributed.sharding``),
    each spec fitted to its whole leaf, placed as ``tensor_from_reference``
    places it; only the block is copied to ``device``.  The reference's
    whole leaves are in its own order: a Mamba-2 leaf's block is cut
    through its ``SegmentedAxis`` (``sharding.take_block``)."""
    from repro_torch.distributed.sharding import fit_spec, take_block

    if isinstance(tree, dict):
        return {k: shard_from_reference(v, specs[k], mesh, device) for k, v in tree.items()}
    a = np.asarray(tree)
    return tensor_from_reference(take_block(a, fit_spec(a.shape, specs, mesh), mesh), device)


def cache_from_reference(cache: dict, device="cuda") -> dict:
    """The reference's decode caches (``{"pos<i>": KVCache | MambaCache}``,
    stacked over the group axis) as the port's namedtuples of tensors."""
    from repro_torch.models.attention import KVCache
    from repro_torch.models.mamba2 import MambaCache

    out = {}
    for name, c in cache.items():
        kind = KVCache if c._fields == KVCache._fields else MambaCache
        if c._fields != kind._fields:
            raise TypeError(f"{name}: unknown cache fields {c._fields}")
        out[name] = kind(*(tensor_from_reference(np.asarray(t), device) for t in c))
    return out


def plan_from_reference(d: dict):
    """The port's ``SortPlan`` for a reference ``SortPlan.to_dict()``.

    >>> plan_from_reference({"strategy": "shared", "local_impl": "pallas"}).local_impl
    'kernel'
    """
    from repro_torch.engine.planner import SortPlan  # engine imports this module

    plan = SortPlan.from_dict(d)
    return replace(plan, local_impl=_IMPL_NAMES.get(plan.local_impl, plan.local_impl))


def planner_from_reference(doc_or_path, *, device=None):
    """A reference plan-cache document (schema v1, v2 or v3; a dict or the
    path of its JSON file) as the port's ``Planner``: plans mapped through
    ``plan_from_reference`` (``'pallas'`` -> ``'kernel'``), the learned
    capacity section unchanged.  ``device`` is the planner's device.

    >>> doc = {"version": 3,
    ...        "plans": {"4096|int32|local/cpu": {"strategy": "shared",
    ...                                          "local_impl": "pallas", "block_n": 512}},
    ...        "learned": {"1024|int32|cpu/x=4": {"capacity_factor": 3.75,
    ...                                          "observations": 7}}}
    >>> p = planner_from_reference(doc, device="cpu")
    >>> p.plans["4096|int32|local/cpu"].local_impl, p.plans["4096|int32|local/cpu"].block_n
    ('kernel', 512)
    >>> p.learned["1024|int32|cpu/x=4"].capacity_factor
    3.75
    """
    from repro_torch.engine.planner import Planner  # engine imports this module

    if isinstance(doc_or_path, (str, os.PathLike)):
        with open(doc_or_path) as f:
            doc_or_path = json.load(f)
    plans, learned = Planner._parse_doc(doc_or_path)
    planner = Planner(device=device)
    planner.plans, planner.learned = plans, learned
    return planner
