"""Adaptive MoE dispatch and the MoE training capacity loop on real gloo ranks.

The counterparts of ``tests/multihost/test_multihost_moe.py``.

* ``moe_adaptive_body``: every rank runs the same skewed
  ``moe_apply_adaptive`` forward against one plan file, which must end up
  with the merged learned state; the result equals one rank's bit for bit,
  and its counts and learned factor equal the reference body's
  (``run_forced_mesh`` on one device), its output the reference's forward
  within the MoE tests' 1e-4.  The reference draws the params and tokens
  from ``jax.random`` (keys 0 and 1); the port gets them through an npz.
* ``moe_train_step_body``: the between-step capacity loop on a (data=2,
  model=2) mesh of four ranks.  The reference body itself fails on a
  default ``jax.make_mesh`` mesh (its Explicit axes, ROADMAP Queue 3), so
  the oracle is that body run unchanged in one process with 4 forced host
  devices and ``jax.make_mesh`` making ``AxisType.Auto`` axes, as the mesh
  LM tests build their reference meshes.  The integer (cap, dropped, peak)
  trace and the learned factor are held equal; the params it drew are
  carried across (and their digest checked).

The port's runs and the reference's start at once in the module fixture,
each with its own plan file.
"""
import hashlib
import json
import os
import textwrap
from dataclasses import replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_multihost as harness
from _torch_mesh_lm import flat_params
from conftest import run_with_devices
from multihost import harness as ref_harness
from repro.configs.base import ARCHS as REF_ARCHS
from repro.engine.planner import Planner as RefPlanner
from repro.models import moe as ref_moe
from repro.models.transformer import model_init as ref_model_init

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = dict(atol=1e-4, rtol=1e-4)  # the reference MoE tests' tolerance
# moe_adaptive_body's layer and tokens
ADAPTIVE_CFG = ref_moe.MoEConfig(d_model=8, d_ff=16, n_experts=4, top_k=2, capacity_factor=1.0,
                                 mlp_gated=False)
# moe_train_step_body's model
TRAIN_CFG = replace(
    REF_ARCHS["qwen3-0.6b"], name="moe-mh-tiny",
    n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
    d_ff=32, vocab_size=64, kv_chunk=16,
    pattern=("attn",), ffn_pattern=("moe",),
    n_experts=8, top_k=2, capacity_factor=1.0,
    param_dtype=jnp.float32, compute_dtype=jnp.float32,
)


def params_digest(tree) -> str:
    return hashlib.sha256(b"".join(np.asarray(v).tobytes()
                                   for v in jax.tree.leaves(tree))).hexdigest()


# the reference's moe_train_step_body, unchanged, on Auto axes; it records a
# digest of the params its model_init drew
ORACLE = """
import hashlib, json, sys
import jax, numpy as np
from jax.sharding import AxisType
sys.path.insert(0, {tests!r})
import repro.models.transformer as tf
DIGESTS = []
_init = tf.model_init
def recording_init(*a, **k):
    p = _init(*a, **k)
    DIGESTS.append(hashlib.sha256(b"".join(np.asarray(v).tobytes()
                                           for v in jax.tree.leaves(p))).hexdigest())
    return p
tf.model_init = recording_init
_make_mesh = jax.make_mesh
def auto_mesh(shape, names, **kw):
    kw.setdefault("axis_types", (AxisType.Auto,) * len(names))
    return _make_mesh(shape, names, **kw)
jax.make_mesh = auto_mesh
from multihost import bodies
class Ctx:
    rank, nprocs, args = 0, 1, {{"plans_path": {plans!r}}}
print(json.dumps({{"result": bodies.moe_train_step_body(Ctx()), "params_digest": DIGESTS[0]}}))
"""


def _oracle(plans_path):
    out = run_with_devices(ORACLE.format(tests=HERE, plans=plans_path), n=4)
    return json.loads(out.strip().splitlines()[-1])


def _adaptive_inputs(path):
    """The reference body's params (uncollapsed: the body collapses them)
    and tokens, and its forward on them."""
    p = ref_moe.moe_init(jax.random.PRNGKey(0), ADAPTIVE_CFG, jnp.float32, ep_shards=1)
    x = jax.random.normal(jax.random.PRNGKey(1), (64, ADAPTIVE_CFG.d_model), jnp.float32)
    np.savez(path, **flat_params(jax.tree.map(np.asarray, p), ""), x=np.asarray(x))
    y, _, _ = ref_moe.moe_apply_adaptive(ref_moe.collapse_router(p), ADAPTIVE_CFG, x,
                                         planner=RefPlanner())
    return np.asarray(y)


def _train_inputs(path):
    """moe_train_step_body's params, router collapsed as the body does; the
    digest of what ``model_init`` drew."""
    params = ref_model_init(jax.random.PRNGKey(0), TRAIN_CFG, ep_shards=2)
    digest = params_digest(params)
    params["blocks"] = {
        pos: ({**gp, "moe": ref_moe.collapse_router(gp["moe"], 6.0)} if "moe" in gp else gp)
        for pos, gp in params["blocks"].items()
    }
    np.savez(path, **flat_params(jax.tree.map(np.asarray, params), ""))
    return digest


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("multihost_moe")
    path = {name: str(wd / f"{name}.json") for name in ("multi", "single", "ref", "four", "oracle")}
    y_ref = _adaptive_inputs(wd / "adaptive.npz")
    digest = _train_inputs(wd / "train.npz")
    adaptive = partial(harness.run_multihost, "_torch_multihost_bodies.py:moe_adaptive_body")
    calls = {
        "multi": partial(adaptive, 2, args={"plans_path": path["multi"],
                                            "params_npz": str(wd / "adaptive.npz")}),
        "single": partial(adaptive, 1, args={"plans_path": path["single"],
                                             "params_npz": str(wd / "adaptive.npz")}),
        "ref": partial(ref_harness.run_forced_mesh, "bodies.py:moe_adaptive_body", 1,
                       args={"plans_path": path["ref"]}),
        "four": partial(harness.run_multihost, "_torch_multihost_bodies.py:moe_train_step_body", 4,
                        args={"plans_path": path["four"], "params_npz": str(wd / "train.npz")}),
        "oracle": partial(_oracle, path["oracle"]),
    }
    return path, y_ref, digest, harness.run_together(calls)


def test_moe_adaptive_learns_into_shared_plan_file(runs):
    path, _, _, runs = runs
    r0, r1 = runs["multi"].require_success().results()
    ref = runs["ref"].require_success().result()
    # replicated forward: both ranks computed the same thing and learned the
    # same factor for the same (global-scope) cell, the reference's
    assert r0["y_sha"] == r1["y_sha"]
    assert r0["counts"] == r1["counts"] == ref["counts"]
    assert r0["scoped_key"] == r1["scoped_key"] == r0["plan_key"]
    assert r0["learned_factor"] == r1["learned_factor"] == ref["learned_factor"] > 1.0

    with open(path["multi"]) as f:
        doc = json.load(f)
    assert doc["version"] == 3
    # one merged entry: two concurrent writers, zero clobbering
    assert sorted(doc["learned"]) == [r0["plan_key"]]
    entry = doc["learned"][r0["plan_key"]]
    assert entry["capacity_factor"] == r0["learned_factor"]
    assert entry["observations"] >= 1


def test_moe_adaptive_bit_identical_to_single_process(runs):
    _, y_ref, _, runs = runs
    m = runs["multi"].require_success().result()
    s = runs["single"].require_success().result()
    assert m["y_sha"] == s["y_sha"], "MoE forward must not depend on the rank count"
    assert m["counts"] == s["counts"]
    assert m["learned_factor"] == s["learned_factor"]
    np.testing.assert_allclose(np.asarray(m["y"], np.float32), y_ref, **OUT)
    # ...but the learned cells live under different topology fingerprints
    assert m["plan_key"] != s["plan_key"]
    assert m["plan_key"].endswith("/procs2x1")


# ------------------------------------------------- expert-parallel training ---
def _check_trained_cell(plans_path, report):
    """The body's learned factor must be durable in the shared file."""
    with open(plans_path) as f:
        doc = json.load(f)
    assert doc["version"] == 3
    entry = doc["learned"][report["plan_key"]]
    assert entry["capacity_factor"] == report["learned_factor"]
    assert entry["observations"] >= 1


def test_moe_train_step_learns_on_four_rank_mesh(runs):
    """The between-step capacity loop on a (data=2, model=2) mesh of four
    ranks: every rank sees the same integer dropped/peak trace, step 0 pays
    the overflow, step 1 runs drop-free at the learned capacity, and the
    factor lands in the shared plan file under the 4-rank mesh's cell."""
    path, _, _, runs = runs
    results = runs["four"].require_success().results()
    r0 = results[0]
    assert all(r["trace"] == r0["trace"] for r in results)
    assert all(r["learned_factor"] == r0["learned_factor"] for r in results)
    assert r0["learned_factor"] > 1.0
    assert all(r["plan_key"] == r0["plan_key"] for r in results)
    assert r0["plan_key"].endswith("|cpu/data=2,model=2/procs4x1"), r0["plan_key"]
    assert r0["trace"][0]["dropped"] > 0, "collapsed router must overflow step 0"
    assert all(t["dropped"] == 0 for t in r0["trace"][1:]), r0["trace"]
    assert r0["trace"][0]["cap"] < r0["trace"][1]["cap"]
    assert all(r["losses_finite"] for r in results)
    _check_trained_cell(path["four"], r0)


def test_moe_train_step_bit_identical_across_topologies(runs):
    """The same 4-device training job as four gloo ranks and as the
    reference's one process with 4 forced devices: the learned factor and
    the whole integer capacity trace are identical (only the plan cell's
    topology fingerprint differs)."""
    path, _, digest, runs = runs
    m = runs["four"].require_success().result()
    oracle = runs["oracle"]
    f = oracle["result"]
    assert oracle["params_digest"] == digest, "the port trained other params"
    assert m["trace"] == f["trace"], "integer capacity trace must not depend on the topology"
    assert m["learned_factor"] == f["learned_factor"]
    assert m["plan_key"] != f["plan_key"]
    assert m["plan_key"].replace("/procs4x1", "") == f["plan_key"]
    assert "procs" not in f["plan_key"]
    assert f["losses_finite"]
    _check_trained_cell(path["four"], m)
    _check_trained_cell(path["oracle"], f)
