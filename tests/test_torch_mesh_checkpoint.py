"""Checkpoints on a mesh: the elastic restore, a mesh save restored on one
device, and a recovery replay on two ranks.

* Elastic (the reference's ``test_elastic_rescale_checkpoint`` across
  packages): the reference trains the mesh tests' model 3 steps on one
  device and saves; four port ranks restore it onto a 2x2 (data, model)
  mesh with ``restore(shardings=, mesh=)``: every rank's blocks equal its
  cut of the saved leaves bit for bit, and 3 more steps train to finite
  losses.
* The 2x2 ranks then save (every rank gathers, rank 0 writes); a restore
  on one device gives the ranks' state put together, bit for bit.
* Recovery on 2 ranks (``--mesh data=1,model=2``, reduced granite):
  a ``TrainingAnomaly`` injected at step 5 on both ranks restores the
  checkpoint of step 4 on both, and the losses and the final checkpoint
  equal an uninterrupted run's bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.optim.adamw import OptConfig as RefOptConfig, init_opt_state as ref_init_opt
from repro.train.steps import train_step as ref_train_step

from _torch_mesh_lm import PORT_IMPORTS, ref_config, ref_params
from _torch_ranks import run_port, save_inputs

STEPS = 3
RECOVERY = ["--arch", "granite-moe-3b-a800m", "--reduced", "--steps", "6", "--batch", "4",
            "--seq", "16", "--lr", "5e-3", "--log-every", "100", "--device", "cpu",
            "--ckpt-every", "2", "--mesh", "data=1,model=2"]


def _batches(seed: int):
    rng = np.random.default_rng(seed)
    for _ in range(STEPS):
        t = (rng.integers(0, 32, size=(8, 17)) * 2).astype(np.int32) % 64
        yield {"tokens": t[:, :-1], "labels": t[:, 1:]}


PORT_BODY = """
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed.sharding import (fit_tree, opt_state_specs, param_specs, shard_tree,
                                              unshard_tree)
from repro_torch.models.transformer import model_init
from repro_torch.optim.adamw import OptConfig, init_opt_state
from repro_torch.train.steps import train_step
from repro_torch.tree import map_leaves
if WORLD == 4:
    cfg = config("m")
    mesh = Mesh((2, 2), ("data", "model"))
    ctx = ShardCtx(mesh=mesh, axes=mesh.axis_names)
    ocfg = OptConfig(peak_lr=5e-3, warmup_steps=2, total_steps=20)
    whole = model_init(torch.Generator().manual_seed(1), cfg, ep_shards=2, device="cpu")
    pspecs = fit_tree(param_specs(whole), whole, mesh)
    params = shard_tree(whole, pspecs, mesh)
    opt = init_opt_state(params, ocfg)
    ospecs = opt_state_specs(opt, pspecs)
    specs = {{"params": pspecs, "opt": ospecs}}
    state, step = CheckpointManager(CKPT).restore({{"params": params, "opt": opt}},
                                                  shardings=specs, mesh=mesh)
    out["restored_step"] = np.array(step)
    for prefix, tree in (("restored/params/", state["params"]), ("restored/opt/", state["opt"])):
        out.update({{prefix + "/".join(p): t.numpy() for p, t in paths(tree)}})
    params, opt = state["params"], state["opt"]
    rng = np.random.default_rng(1)
    losses = []
    for i in range({steps}):
        t = rows(torch.from_numpy((rng.integers(0, 32, size=(8, 17)) * 2).astype(np.int32) % 64),
                 mesh)
        batch = {{"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}}
        params, opt, m = train_step(params, opt, batch, cfg=cfg, opt_cfg=ocfg, ctx=ctx,
                                    loss_chunk=16, specs=pspecs)
        losses.append(float(m["loss"]))
    out["losses"] = np.array(losses)
    mgr = CheckpointManager(SAVE)
    mgr.save(2 * {steps}, {{"params": params, "opt": opt}}, blocking=False, shardings=specs,
             mesh=mesh)
    mgr.wait()
    whole = unshard_tree({{"params": params, "opt": opt}}, specs, mesh)
    if RANK == 0:
        out.update({{"whole/" + "/".join(p): t.numpy() for p, t in paths(whole)}})
else:
    import io, contextlib
    from repro_torch.distributed.fault_tolerance import TrainingAnomaly
    from repro_torch.launch import train
    real = train.train_step
    for label in ("clean", "replayed"):
        calls = []
        def step(*a, **k):
            calls.append(len(calls))
            if label == "replayed" and len(calls) == 6:  # step 5, after the save at step 4
                raise TrainingAnomaly("injected")
            return real(*a, **k)
        train.train_step = step
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out[label] = np.array(train.main({recovery!r} + ["--ckpt-dir", f"{{RECOVERY_DIR}}/{{label}}"]))
        out[label + "_log"] = np.array(buf.getvalue())
    train.train_step = real
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("mesh_ckpt")
    # the reference: 3 steps on one device, then a save
    cfg = ref_config("m")
    params = jax.tree.map(jnp.asarray, ref_params("m", 2))
    ocfg = RefOptConfig(peak_lr=5e-3, warmup_steps=2, total_steps=20)
    opt = ref_init_opt(params, ocfg)
    step = jax.jit(functools.partial(ref_train_step, cfg=cfg, opt_cfg=ocfg, loss_chunk=16))
    for b in _batches(0):
        params, opt, _ = step(params, opt, {k: jnp.asarray(v) for k, v in b.items()})
    RefManager(str(wd / "ref_ckpt")).save(STEPS, {"params": params, "opt": opt})
    save_inputs(wd, {"unused": np.zeros(1)})
    head = (PORT_IMPORTS + f"CKPT = {str(wd / 'ref_ckpt')!r}\nSAVE = {str(wd / 'mesh_ckpt')!r}\n"
            f"RECOVERY_DIR = {str(wd / 'recovery')!r}\n")
    body = head + PORT_BODY.format(steps=STEPS, recovery=RECOVERY)
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=2) as pool:
        ports = {w: pool.submit(run_port, body, w, wd, 420) for w in (2, 4)}
        ports = {w: f.result() for w, f in ports.items()}
    saved = jax.tree_util.tree_flatten_with_path({"params": params, "opt": opt})[0]
    ref = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v) for kp, v in saved}
    return ref, ports, wd


def test_a_reference_checkpoint_restores_onto_a_2x2_mesh(runs):
    from repro_torch.distributed.sharding import fit_spec, opt_state_specs, param_specs, take_block

    ref, ports, _ = runs
    tree = {}
    for k, v in ref.items():
        node = tree
        *head, leaf = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = v
    specs = {"params": param_specs(tree["params"])}
    specs["opt"] = opt_state_specs(tree["opt"], specs["params"])
    for rank, r in enumerate(ports[4]):
        assert int(r["restored_step"]) == STEPS
        mesh = type("M", (), {"axis_names": ("data", "model"), "shape": {"data": 2, "model": 2},
                              "coords": {"data": rank // 2, "model": rank % 2}})()
        for k, v in ref.items():
            node = specs
            for h in k.split("/"):
                node = node[h]
            want = take_block(v, fit_spec(v.shape, node, mesh), mesh)
            got = r["restored/" + k]
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), (rank, k)


def test_the_restored_mesh_trains(runs):
    losses = [r["losses"] for r in runs[1][4]]
    assert np.isfinite(losses[0]).all()
    for l in losses[1:]:
        np.testing.assert_array_equal(l, losses[0])


def test_a_mesh_save_restores_on_one_device_bit_for_bit(runs):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.tree import paths

    _, ports, wd = runs
    whole = {k[len("whole/"):]: v for k, v in ports[4][0].items() if k.startswith("whole/")}
    like = {}
    for k, v in whole.items():
        node = like
        *head, leaf = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = torch.from_numpy(np.zeros(v.shape, v.dtype))
    restored, step = CheckpointManager(str(wd / "mesh_ckpt")).restore(like)
    assert step == 2 * STEPS
    got = {"/".join(p): t.numpy() for p, t in paths(restored)}
    assert set(got) == set(whole)
    for k, v in whole.items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k


def test_a_recovery_on_two_ranks_replays_bit_for_bit(runs):
    _, ports, wd = runs
    for r in ports[2]:
        clean, replayed = list(r["clean"]), list(r["replayed"])
        assert replayed == clean[:5] + clean[4:]  # step 4 ran twice, bit for bit
    np.testing.assert_array_equal(ports[2][0]["clean"], ports[2][1]["clean"])
    assert "(1 restarts)" in str(ports[2][0]["replayed_log"])  # rank 0 alone prints
    ends = [np.load(wd / "recovery" / run / "step_00000006" / "leaves.npz")
            for run in ("clean", "replayed")]
    assert ends[0].files == ends[1].files
    for k in ends[0].files:
        assert ends[0][k].tobytes() == ends[1][k].tobytes(), k
