"""Training on a (data, model) mesh: ``train_step`` on 2 and 4 gloo ranks
against the reference, the per-rank storage, convergence, and
``launch/train.py --mesh``.

The reference mesh tests' model (``_torch_mesh_lm``: 4 experts top-2) on
every mesh (``data x model`` = 1x2, 2x1, 2x2, 1x4), and on 2x2 with int8
moments, ``compress_grads`` and both.  The port's ranks store their blocks
of the reference's params and of the AdamW state (``param_specs`` /
``opt_state_specs``, FSDP x TP) and their rows of the batch.  Held against
the reference's own mesh path (the oracle for a mesh's MoE semantics: the
per-sender capacity and ``aux`` averaged over the senders) at
``test_torch_train.py``'s tolerances (``_torch_mesh_lm.check_step``): loss
within 1e-5 relative, MoE drops and peak equal, gradients per leaf within
1e-4 relative L2 (gathered from the blocks, on 2x2), the update per leaf
within 1e-3, ``grad_norm`` and ``lr`` within 1e-5; every rank reports the
same metrics.  Also:

* each rank stores its blocks only: its param and moment bytes are the
  whole's share each leaf's spec gives (about 1/4 on 2x2, plus the
  replicated norms and router);
* 25 steps on 2x2 of the reference mesh test's batches: the loss falls by
  more than 1.0, as in the reference's ``test_moe_training_on_mesh``;
* ``launch/train.py --mesh data=2,model=2`` (reduced granite, 5 experts
  padded to 6) from the same params as the one-device driver: losses
  within the driver tests' 1e-3 relative (a mesh's ``aux`` is the senders'
  mean, which one device does not repeat exactly), the same on every
  rank, the learned capacity factor equal.

``test_torch_mesh_train_archs.py`` holds reduced granite, qwen3 and jamba.
"""
import numpy as np
import pytest

from _torch_mesh_lm import DRIVER, case_tree, check_grads, check_step, ranks_of, replicated_bytes, run_train

DRIVER_RTOL = 1e-3
CASES = {
    "m-1x2": ("m", (1, 2), "f32", False, "step"), "m-2x1": ("m", (2, 1), "f32", False, "step"),
    "m-2x2": ("m", (2, 2), "f32", False, "grads+step"),
    "m-1x4": ("m", (1, 4), "f32", False, "step"),
    "m-2x2-int8": ("m", (2, 2), "int8", False, "step"),
    "m-2x2-compress": ("m", (2, 2), "f32", True, "step"),
    "m-2x2-int8-compress": ("m", (2, 2), "int8", True, "step"),
    # the driver's params (reduced granite on a model axis of 2)
    "granite-2x2": ("granite-moe-3b-a800m", (2, 2), "f32", False, "params"),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_train(tmp_path_factory.mktemp("mesh_train"), CASES, (), (2, 4), extras=True)


def test_mesh_loss_and_gradients_match_the_reference_mesh(runs):
    check_grads(runs, CASES, "m-2x2")


@pytest.mark.parametrize("case", sorted(c for c, v in CASES.items() if "step" in v[4]))
def test_mesh_train_step_matches_the_reference_mesh(runs, case):
    check_step(runs, CASES, case)


@pytest.mark.parametrize("case", ["m-2x2", "m-2x2-int8"])
def test_each_rank_stores_only_its_blocks(runs, case):
    """A rank's param and moment bytes are the whole's share each leaf's
    spec gives it: 1/4 on 2x2 for leaves sharded over both axes, 1/2 for
    the table (vocab over "model"), all of a replicated norm or router."""
    ranks = ranks_of(runs, CASES, case)
    share = replicated_bytes(case_tree(runs, case), (2, 2), int8=CASES[case][2] == "int8")
    for r in ranks:
        assert int(r[f"{case}/bytes"]) == share
    assert share < 0.45 * int(ranks[0][f"{case}/whole_bytes"])


def test_mesh_training_converges(runs):
    losses = runs[1][4][0]["converge/losses"]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])


def test_train_driver_on_a_mesh_matches_one_device(runs, monkeypatch, tmp_path, capsys):
    from repro_torch.carry import params_from_reference
    from repro_torch.engine.planner import Planner
    from repro_torch.launch import train

    tree = case_tree(runs, "granite-2x2")
    monkeypatch.setattr(train, "model_init",
                        lambda gen, cfg, ep_shards, device: params_from_reference(tree, device))
    plans = str(tmp_path / "plans.json")
    want = train.main(DRIVER + ["--plans", plans])
    one = capsys.readouterr().out
    ranks = runs[1][4]
    for r in ranks:
        np.testing.assert_allclose(r["driver/losses"], want, rtol=DRIVER_RTOL)
        np.testing.assert_array_equal(r["driver/losses"], ranks[0]["driver/losses"])
    mesh_log = str(ranks[0]["driver/log"])
    factor = float(mesh_log.split("learned_cf=")[1].split()[0])
    assert factor == float(one.split("learned_cf=")[1].split()[0])
    assert "cell=moe/E5k2|64|float32|cpu/data=2,model=2/procs4x1" in mesh_log
    assert Planner(plans, device="cpu").capacity_factor_for(
        "moe/E5k2|64|float32|local/cpu", default=4.0) == factor
