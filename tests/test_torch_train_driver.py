"""The port's training driver (``repro_torch.launch.train``) on the CPU.

* It trains a reduced qwen3 and checkpoints, as the reference's system test
  does; handed the reference's initial params (``train.model_init``
  patched), its per-step losses equal the reference driver's within 1e-3
  relative.
* A restart replays bit for bit: an injected ``TrainingAnomaly`` restores
  the last checkpoint, and the losses and final params equal an
  uninterrupted run's.
* The single-device MoE capacity loop: reduced granite at capacity factor
  1.0 with a collapsed router (``--moe-skew``) and ``--lr 0``, which keeps
  the router collapsed, as the reference's capacity-loop test keeps its
  params (any update breaks the router's ties and spreads the tokens, and
  the learned factor then rightly decays).  Drops on step 0 only, the
  capacity rises once and holds, equal to the reference driver's step by
  step, and the factor persists into a fresh ``Planner``.
"""
import dataclasses
import re

import jax
import numpy as np
import pytest

from repro.configs import base as ref_base
from repro.launch import train as ref_train
from repro.models import transformer as ref_tf
from repro_torch.carry import params_from_reference
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import base
from repro_torch.distributed.fault_tolerance import TrainingAnomaly
from repro_torch.engine.planner import Planner
from repro_torch.launch import train

LOSS_RTOL = 1e-3
FLAGS = ["--arch", "qwen3-0.6b", "--reduced", "--steps", "12", "--batch", "4", "--seq", "32",
         "--lr", "5e-3", "--log-every", "100"]


def hand_over(monkeypatch, rcfg):
    """The port's driver starts from the reference's params for ``rcfg``."""
    tree = jax.tree.map(np.asarray, ref_tf.model_init(jax.random.PRNGKey(0), rcfg))
    monkeypatch.setattr(train, "model_init",
                        lambda gen, cfg, ep_shards, device: params_from_reference(tree, device))


def test_driver_trains_and_checkpoints(tmp_path):
    losses = train.main(FLAGS + ["--device", "cpu", "--ckpt-dir", str(tmp_path),
                                 "--ckpt-every", "6"])
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert CheckpointManager(str(tmp_path)).latest_step() == 12


def test_losses_equal_the_reference_driver(monkeypatch, capsys):
    want = ref_train.main(FLAGS)
    hand_over(monkeypatch, ref_base.reduced(ref_base.ARCHS["qwen3-0.6b"]))
    got = train.main(FLAGS + ["--device", "cpu"])
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert "params=0.04M" in capsys.readouterr().out


def test_a_restart_replays_bit_for_bit(tmp_path, monkeypatch):
    flags = ["--arch", "qwen3-0.6b", "--reduced", "--steps", "8", "--batch", "2", "--seq", "16",
             "--lr", "5e-3", "--log-every", "100", "--device", "cpu", "--ckpt-every", "2"]
    clean = train.main(flags + ["--ckpt-dir", str(tmp_path / "clean")])
    real, calls = train.train_step, []

    def failing_once(*a, **k):
        calls.append(len(calls))
        if len(calls) == 6:  # step 5, once: after the checkpoint at step 4
            raise TrainingAnomaly("injected")
        return real(*a, **k)

    monkeypatch.setattr(train, "train_step", failing_once)
    replayed = train.main(flags + ["--ckpt-dir", str(tmp_path / "replayed")])
    assert replayed == clean[:5] + clean[4:]  # step 4 ran twice, bit for bit
    ends = [np.load(tmp_path / run / "step_00000008" / "leaves.npz") for run in ("clean", "replayed")]
    assert ends[0].files == ends[1].files
    for k in ends[0].files:
        np.testing.assert_array_equal(ends[0][k], ends[1][k])


def _granite_cf1(monkeypatch):
    name = "granite-moe-3b-a800m-cf1"
    rcfg = dataclasses.replace(ref_base.reduced(ref_base.ARCHS["granite-moe-3b-a800m"]), name=name,
                               capacity_factor=1.0)
    tcfg = dataclasses.replace(base.reduced(base.ARCHS["granite-moe-3b-a800m"]), name=name,
                               capacity_factor=1.0)
    monkeypatch.setitem(ref_base.ARCHS, name, rcfg)
    monkeypatch.setitem(base.ARCHS, name, tcfg)
    return name, rcfg


def _moe_log(out: str):
    steps = [tuple(map(int, m)) for m in re.findall(r"moe\[cap (\d+) drop (\d+) peak (\d+)\]", out)]
    return steps, re.search(r"cell=(\S+)", out).group(1)


def test_capacity_loop_equals_the_reference_driver(tmp_path, monkeypatch, capsys):
    name, rcfg = _granite_cf1(monkeypatch)
    flags = ["--arch", name, "--steps", "4", "--batch", "4", "--seq", "32", "--lr", "0",
             "--moe-skew", "6.0", "--log-every", "1"]
    ref_train.main(flags + ["--plans", str(tmp_path / "ref.json")])
    want, want_cell = _moe_log(capsys.readouterr().out)
    hand_over(monkeypatch, rcfg)
    plans = str(tmp_path / "port.json")
    train.main(flags + ["--plans", plans, "--device", "cpu"])
    got, cell = _moe_log(capsys.readouterr().out)
    assert got == want and cell == want_cell == "moe/E5k2|128|float32|local/cpu"
    caps, drops = [c for c, _, _ in got], [d for _, d, _ in got]
    assert drops[0] > 0 and drops[1:] == [0, 0, 0], drops
    assert caps[0] < caps[1] and len(set(caps[1:])) == 1, caps
    learned = Planner(plans, device="cpu").capacity_factor_for(cell, default=1.0)
    assert learned > 1.0
    assert learned == Planner(str(tmp_path / "ref.json"), device="cpu").capacity_factor_for(cell)


def test_mesh_raises_rather_than_running_on_one_device():
    """--mesh data=1,model=1 --device cpu trains on a one-rank mesh and
    gives the single-device driver's losses (the name is from when --mesh
    raised here)."""
    import torch.distributed as dist

    flags = ["--reduced", "--steps", "3", "--batch", "2", "--seq", "16", "--device", "cpu",
             "--log-every", "100"]
    want = train.main(flags)
    got = train.main(flags + ["--mesh", "data=1,model=1"])
    assert got == want
    assert not dist.is_initialized()  # the driver took down the group it brought up
