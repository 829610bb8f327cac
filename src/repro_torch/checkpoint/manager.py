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
    def save(self, step: int, tree: Any, *, blocking: bool = True) -> None:
        self.wait()  # one in-flight async save at a time
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
    def restore(self, like: Any, *, step: Optional[int] = None, shardings: Any = None):
        """Restore into the structure of ``like`` (which supplies dtypes and
        devices); returns ``(tree, step)``.  The latest step counts a save
        of this manager still in flight.  ``shardings`` (placing each leaf
        on a mesh) waits for the mesh slice and raises."""
        if shardings is not None:
            raise NotImplementedError(
                "restore(shardings=) is not ported yet (ROADMAP Queue 1 item 9b, "
                "distributed/sharding.py); restore onto one device and place the leaves"
            )
        self.wait()  # this manager's save in flight lands first
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        with np.load(os.path.join(self._step_dir(step), "leaves.npz")) as z:
            host = [z[f"arr_{i}"] for i in range(len(z.files))]
        flat_like = _flatten(like)
        if len(host) != len(flat_like):
            raise ValueError(f"checkpoint has {len(host)} leaves, expected {len(flat_like)}")
        leaves = iter([_restore_leaf(h, l) for h, l in zip(host, flat_like)])
        return _unflatten(like, leaves), step
