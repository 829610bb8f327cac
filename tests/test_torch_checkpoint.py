"""The port's checkpoint manager (``repro_torch.checkpoint.manager``).

The reference's checkpoint cases on the port, and the two packages'
checkpoints restored into each other's trees bit for bit: the layout is
the reference's (``leaves.npz`` + ``treedef.json``, bfloat16 stored as
float32) and the leaves are flattened in ``jax.tree_util``'s sorted-key
order.
"""
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro_torch.carry import params_from_reference, tensor_from_reference, tensor_to_reference
from repro_torch.checkpoint import manager as manager_mod
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.attention import KVCache


def _tree():
    gen = torch.Generator().manual_seed(0)
    # keys deliberately out of sorted order: flattening must sort them
    return {
        "nested": {"c": torch.zeros(3, dtype=torch.bfloat16), "b": torch.arange(10, dtype=torch.int32)},
        "count": torch.tensor(7, dtype=torch.int32),
        "a": torch.randn(16, 8, generator=gen),
    }


def _leaves_equal(a, b):
    for (x, y) in zip(manager_mod._flatten(a), manager_mod._flatten(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_roundtrip_blocking(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(3, t)
    restored, step = mgr.restore(t)
    assert step == 3 and list(restored) == list(t)
    _leaves_equal(restored, t)


def test_async_save_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(1, t, blocking=False)
    mgr.save(2, t, blocking=False)  # waits for the first automatically
    mgr.wait()
    assert mgr.latest_step() == 2


def test_restore_sees_a_save_still_in_flight(tmp_path, monkeypatch):
    release = threading.Event()
    real = np.savez

    def slow_savez(*a, **k):
        release.wait(10)
        return real(*a, **k)

    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(1, t)
    monkeypatch.setattr(manager_mod.np, "savez", slow_savez)
    mgr.save(2, t, blocking=False)
    assert mgr.latest_step() == 1  # step 2 is still being written
    threading.Timer(0.05, release.set).start()
    _, step = mgr.restore(t)
    assert step == 2


def test_gc_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, t)
    assert sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)) == [3, 4]


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore(_tree())


def test_restore_with_shardings_waits_for_the_mesh_slice(tmp_path):
    """restore(shardings=) onto a one-rank (data=1, model=1) mesh returns
    the saved leaves bit for bit (the name is from when it raised here)."""
    from _torch_ranks import one_rank_mesh

    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _tree())
    specs = {"nested": {"c": ("model",), "b": (("data", "model"),)}, "count": (), "a": ("data", None)}
    with one_rank_mesh() as mesh:
        restored, step = mgr.restore(_tree(), shardings=specs, mesh=mesh)
    assert step == 5
    _leaves_equal(restored, _tree())


def test_restore_places_leaves_like_the_template(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(1, t)
    like = {**t, "a": torch.zeros(16, 8, dtype=torch.bfloat16)}
    restored, _ = mgr.restore(like)
    assert restored["a"].dtype == torch.bfloat16
    assert torch.equal(restored["a"], t["a"].to(torch.bfloat16))


def test_pipeline_state_and_scalar_leaves_resume(tmp_path):
    """Python ints (the pipeline's seed and step) restore too; the reference's
    restore raises AttributeError on them (``int`` has no ``dtype``)."""
    pipe = SyntheticLM(vocab=101, batch=2, seq=8, seed=3)
    it = iter(pipe)
    for _ in range(4):
        next(it)
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": torch.ones(2), "pipeline": pipe.checkpoint_state()}
    mgr.save(4, tree)
    restored, _ = mgr.restore(tree)
    other = SyntheticLM(vocab=101, batch=2, seq=8, seed=0)
    other.restore_state(restored["pipeline"])
    np.testing.assert_array_equal(next(iter(other))["tokens"], next(iter(pipe))["tokens"])
    ref_tree = {"w": jnp.ones(2), "pipeline": {"seed": 3, "step": 4}}
    RefManager(str(tmp_path / "ref")).save(4, ref_tree)
    with pytest.raises(AttributeError):
        RefManager(str(tmp_path / "ref")).restore(ref_tree)


def _ref_tree():
    k = jax.random.PRNGKey(0)
    return {
        "a": jax.random.normal(k, (16, 8)),
        "nested": {"b": jnp.arange(10, dtype=jnp.int32),
                   "c": (jax.random.normal(k, (3,)) * 7).astype(jnp.bfloat16),
                   "q": jnp.arange(-5, 7, dtype=jnp.int8).reshape(3, 4)},
        "count": jnp.asarray(7, jnp.int32),
        "cache": KVCache(jnp.ones((2, 3)), jnp.zeros((2, 3)), jnp.asarray(5, jnp.int32)),
    }


def _port_tree(ref_tree):
    """The reference tree as the port's, keys in another order."""
    np_tree = jax.tree.map(np.asarray, ref_tree)
    out = params_from_reference({k: v for k, v in np_tree.items() if k != "cache"}, "cpu")
    out["cache"] = KVCache(*(tensor_from_reference(x, "cpu") for x in np_tree["cache"]))
    return {k: out[k] for k in ("cache", "count", "nested", "a")}


def _same_bits(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8),
                                  np.atleast_1d(np.ascontiguousarray(want)).view(np.uint8))


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    ref_tree = _ref_tree()
    RefManager(str(tmp_path)).save(9, ref_tree)
    like = _port_tree(jax.tree.map(jnp.zeros_like, ref_tree))
    restored, step = CheckpointManager(str(tmp_path)).restore(like)
    assert step == 9 and isinstance(restored["cache"], KVCache)
    assert list(restored) == list(like)
    for got, want in zip(manager_mod._flatten(restored), jax.tree.leaves(ref_tree)):
        _same_bits(tensor_to_reference(got), np.asarray(want))


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    ref_tree = _ref_tree()
    CheckpointManager(str(tmp_path)).save(11, _port_tree(ref_tree))
    restored, step = RefManager(str(tmp_path)).restore(jax.tree.map(jnp.zeros_like, ref_tree))
    assert step == 11
    for got, want in zip(jax.tree.leaves(restored), jax.tree.leaves(ref_tree)):
        _same_bits(np.asarray(got), np.asarray(want))
