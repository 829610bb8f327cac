"""Checkpointing (torch): atomic, async-capable, in the reference's layout.

Counterpart of ``repro/checkpoint/manager.py``:

* **atomic**: a save writes ``step_NNNNNNNN.tmp`` and then ``os.replace``s
  it to ``step_NNNNNNNN``, so a crash mid-save never corrupts the latest
  checkpoint;
* **async**: ``save(..., blocking=False)`` copies every leaf to host memory
  on the caller's thread and writes the files on a background thread;
* **keep-last-k**: older checkpoints are deleted after each save;
* **bit-exact resume**: the data pipeline's (seed, step) is part of the
  payload.

The on-disk layout is the reference's: ``leaves.npz`` (the leaves as
``arr_0 .. arr_{n-1}``, bfloat16 stored losslessly as float32) and
``treedef.json``.  Leaves are flattened in ``jax.tree_util``'s order (dict
keys sorted, sequences in order, ``None`` no leaf), so a checkpoint written
by either package restores into the other's tree.  ``restore(like)`` gives
each tensor leaf ``like``'s dtype and device; a Python or numpy scalar leaf
comes back as a 0-d numpy array of its dtype.

On a mesh (``shardings=`` the tree's specs, ``mesh=`` its
``launch.mesh.Mesh``) checkpoints stay whole, as the reference stores
them: ``save`` gathers every leaf from the ranks' blocks, a collective
that every rank enters before any thread starts, and rank 0 alone writes.
``restore`` cuts each rank's block of each whole leaf (``fit_spec``,
``take_block``), so a checkpoint restores onto any mesh, or onto one
device, whatever mesh saved it.  A Mamba-2 leaf's block holds its heads'
columns (a ``SegmentedAxis``), and its whole leaf on disk is in the
reference's column order either way.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.carry import tensor_from_reference
from repro_torch.distributed.sharding import fit_spec, take_block, unshard_tree

__all__ = ["CheckpointManager"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree) -> list:
    """Leaves in ``jax.tree_util.tree_flatten``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _flatten(t)]
    return [tree]


def _leaf_specs(tree, specs) -> list:
    """The specs of ``tree``'s leaves, in ``_flatten``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _leaf_specs(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [s for t, sp in zip(tree, specs) for s in _leaf_specs(t, sp)]
    return [specs]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}  # the caller's key order
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(t, leaves) for t in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(t, leaves) for t in like)
    return next(leaves)


def _structure(tree) -> str:
    """The tree's shape in the style of ``repr(jax.tree_util.tree_structure)``
    (informational: restore reads only ``n_leaves``)."""
    def node(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}" for k in sorted(t)) + "}"
        if _is_namedtuple(t):
            return f"{type(t).__name__}(" + ", ".join(
                f"{f}={node(v)}" for f, v in zip(t._fields, t)) + ")"
        if isinstance(t, list):
            return "[" + ", ".join(node(v) for v in t) + "]"
        if isinstance(t, tuple):
            return "(" + ", ".join(node(v) for v in t) + ("," if len(t) == 1 else "") + ")"
        return "*"

    return f"PyTreeDef({node(tree)})"


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()  # npz cannot store bfloat16; float32 holds it exactly
        return x.cpu().numpy()
    h = np.asarray(x)
    if h.dtype.kind == "V" or h.dtype.name == "bfloat16":
        h = h.astype(np.float32)
    return h


def _restore_leaf(h: np.ndarray, like):
    if isinstance(like, torch.Tensor):
        if like.dtype == torch.bfloat16:
            return torch.from_numpy(np.ascontiguousarray(h, np.float32)).to(
                device=like.device, dtype=torch.bfloat16)
        return tensor_from_reference(h, like.device).to(like.dtype)
    return np.asarray(h, np.asarray(like).dtype)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- paths ---
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _steps(self) -> list:
        return sorted(
            int(d.split("_")[1])
            for d in os.listdir(self.dir)
            if d.startswith("step_") and not d.endswith(".tmp")
        )

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    # -------------------------------------------------------------- save ---
    def save(self, step: int, tree: Any, *, blocking: bool = True, shardings: Any = None,
             mesh=None) -> None:
        """Save ``tree`` as step ``step``.  With ``shardings`` (the fitted
        specs of ``tree``'s blocks) and ``mesh``, every rank must call it:
        the leaves are gathered whole on the caller's thread, then rank 0
        writes them."""
        self.wait()  # one in-flight async save at a time
        if shardings is not None:
            host = []
            for x, spec in zip(_flatten(tree), _leaf_specs(tree, shardings)):
                if isinstance(x, torch.Tensor):  # one leaf whole at a time
                    x = unshard_tree(x, spec, mesh)
                host.append(_to_host(x) if mesh.rank == 0 else None)
            if mesh.rank != 0:
                return
        else:
            host = [_to_host(x) for x in _flatten(tree)]
        structure = json.dumps(_structure(tree))

        def write():
            tmp = self._step_dir(step) + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "leaves.npz"), *host)
            with open(os.path.join(tmp, "treedef.json"), "w") as f:
                json.dump({"repr": structure, "n_leaves": len(host), "step": step}, f)
            final = self._step_dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for s in self._steps()[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------ restore ---
    def restore(self, like: Any, *, step: Optional[int] = None, shardings: Any = None,
                mesh=None):
        """Restore into the structure of ``like`` (which supplies dtypes and
        devices); returns ``(tree, step)``.  The latest step counts a save
        of this manager still in flight.  With ``shardings`` (specs of
        ``like``'s leaves, fitted or not) and ``mesh`` every rank must call
        it, and each gets its block of every leaf, cut by the spec fitted
        to the whole leaf's shape."""
        self.wait()  # this manager's save in flight lands first
        if shardings is not None:  # rank 0's save in flight lands before anyone reads
            torch.distributed.barrier(group=mesh.world.group)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        with np.load(os.path.join(self._step_dir(step), "leaves.npz")) as z:
            host = [z[f"arr_{i}"] for i in range(len(z.files))]
        flat_like = _flatten(like)
        if len(host) != len(flat_like):
            raise ValueError(f"checkpoint has {len(host)} leaves, expected {len(flat_like)}")
        if shardings is not None:
            host = [h if np.ndim(h) == 0 else take_block(h, fit_spec(h.shape, spec, mesh), mesh)
                    for h, spec in zip(host, _leaf_specs(like, shardings))]
        leaves = iter([_restore_leaf(h, l) for h, l in zip(host, flat_like)])
        return _unflatten(like, leaves), step
