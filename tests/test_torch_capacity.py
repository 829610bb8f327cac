"""The capacity-learning loop on a mesh, port against reference.

The reference runs on a forced host mesh of P devices, the port as P gloo
ranks (``tests/_torch_ranks.py``), for P = 2 and 4.  Each side calls its
mesh ``sort`` on zipf-skewed keys through its default planner, with
``REPRO_SORT_PLANS`` in the test's directory, and the learned tables are
compared entry for entry after every call (the fingerprints differ by
design: ``cpu/x=P`` against ``cpu/ranks=P/procsPx1``; the size bucket is the
global length on both).  The reference's mesh ``sort_kv`` raises in this
environment (``repro/engine/kv.py:279``), so the port's mesh ``sort_kv``
loop is held against the entries its own observations give through the
reference's ``Planner.observe_exchange``.  The port's rank-coordinated
autotune runs too: every rank must hold rank 0's plan, rank 0 alone writes
the file, and a candidate failing on one rank raises on every rank.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_ranks import mesh_keys, run_both, save_inputs
from repro.engine import ExchangeObservation, Planner
from repro.engine.planner import SortPlan, plan_key

WORLDS = (2, 4)
M = 256  # keys a rank
CALLS = 5
FIELDS = ("m", "part_buckets", "capacity", "peak", "overflowed", "retries", "dropped",
          "dropped_averted", "partition")

_COMMON = """
import json
N = WORLD * M
def reset_default_planner(path):
    os.environ["REPRO_SORT_PLANS"] = path
    PLANNER_MODULE._DEFAULT = None
    return PLANNER_MODULE.default_planner()
def entry(planner, key):
    e = planner.learned.get(key)
    return json.dumps(e.to_dict() if e is not None else None)
def observation(planner, key):
    o = planner.telemetry.last(key)
    return json.dumps({f: getattr(o, f) for f in FIELDS})
"""

REF_BODY = """
import os
import repro
import repro.engine.planner as PLANNER_MODULE
from repro.engine.planner import plan_key
""" + _COMMON + """
x = jnp.asarray(IN["zipf"][:N])
KEY = plan_key(N, jnp.int32, mesh)
for scenario, mode in (("explicit", "radix"), ("tuned", None)):
    planner = reset_default_planner(IN_DIR + f"/ref{WORLD}_{scenario}.json")
    for call in range(CALLS):
        kw = {} if mode is None else {"mode": mode}
        slab, valid = repro.sort(x, mesh=mesh, axis="x", **kw)
        out[f"{scenario}/{call}/keys"] = np.asarray(slab)[np.asarray(valid)]
        out[f"{scenario}/{call}/entry"] = np.array(entry(planner, KEY))
        out[f"{scenario}/{call}/obs"] = np.array(observation(planner, KEY))
"""

PORT_BODY = """
import repro_torch
import repro_torch.engine.planner as PLANNER_MODULE
from repro_torch.engine import sort_kv
from repro_torch.engine.planner import Planner, SortPlan, plan_key
""" + _COMMON + """
x = shard(IN["zipf"][:N])
KEY = plan_key(N, torch.int32, G, device="cpu")
out["key"] = np.array(KEY)
for scenario, mode in (("explicit", "radix"), ("tuned", None)):
    planner = reset_default_planner(IN_DIR + f"/port{WORLD}_{scenario}.json")
    for call in range(CALLS):
        kw = {} if mode is None else {"mode": mode}
        slab, valid = repro_torch.sort(x, mesh=G, **kw)
        out[f"{scenario}/{call}/keys"] = slab[valid].numpy()
        out[f"{scenario}/{call}/entry"] = np.array(entry(planner, KEY))
        out[f"{scenario}/{call}/obs"] = np.array(observation(planner, KEY))

# the mesh sort_kv closes the same loop (its own planner and file)
planner = reset_default_planner(IN_DIR + f"/port{WORLD}_kv.json")
iota = torch.arange(RANK * M, (RANK + 1) * M, dtype=torch.int32)
for call in range(CALLS):
    k, v = sort_kv(x, {"i": iota}, mesh=G)
    out[f"kv/{call}/keys"], out[f"kv/{call}/idx"] = k.numpy(), v["i"].numpy()
    out[f"kv/{call}/entry"] = np.array(entry(planner, KEY))
    out[f"kv/{call}/obs"] = np.array(observation(planner, KEY))

# a rank-coordinated autotune: rank 0's plan everywhere, rank 0 writes
tuner = Planner(IN_DIR + f"/auto{WORLD}.json", device="cpu")
best = tuner.autotune(N, mesh=G, candidates=[SortPlan("cluster", mode="splitters"),
                                             SortPlan("cluster", mode="sample")], reps=1)
out["auto/best"] = np.array(json.dumps(best.to_dict()))
out["auto/wrote"] = np.array(tuner.last_autotune_wrote)
out["auto/key"] = np.array(plan_key(N, torch.int32, G, device="cpu"))

# a candidate that fails on rank 1 only: every rank raises, none hangs
import repro_torch.core.seqsort as seqsort
if RANK == 1:
    def broken(*a, **k):
        raise RuntimeError("kernel launch failed on rank 1")
    seqsort.kernel_local_sort = broken
try:
    Planner(device="cpu").autotune(N, candidates=[
        SortPlan("shared"), SortPlan("shared", local_impl="kernel", block_n=256)], reps=1)
    out["fail"] = np.array("no error")
except RuntimeError as e:
    out["fail"] = np.array(str(e))
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("capacity")
    save_inputs(workdir, {"zipf": mesh_keys("zipf", "int32", max(WORLDS) * M, seed=3)})
    for world in WORLDS:  # the tuned scenario: a radix cluster plan for the cell
        n = world * M
        plan = SortPlan("cluster", local_impl="xla", mode="radix").to_dict()
        for name, key in ((f"ref{world}", plan_key(n, jnp.int32, fingerprint=f"cpu/x={world}")),
                          (f"port{world}", f"{n}|int32|cpu/ranks={world}/procs{world}x1")):
            (workdir / f"{name}_tuned.json").write_text(
                json.dumps({"version": 3, "plans": {key: plan}, "learned": {}}))
    params = f"M = {M}\nCALLS = {CALLS}\nFIELDS = {FIELDS!r}\nIN_DIR = {str(workdir)!r}\n"
    refs, ports = run_both(params + REF_BODY, params + PORT_BODY, WORLDS, workdir)
    return workdir, refs, ports


@pytest.mark.parametrize("scenario", ["explicit", "tuned"])
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_sort_learns_the_reference_table(results, world, scenario):
    workdir, refs, ports = results
    ref, ports = refs[world], ports[world]
    want_keys = np.sort(mesh_keys("zipf", "int32", max(WORLDS) * M, seed=3)[: world * M])
    for call in range(CALLS):
        tag = f"{scenario}/{call}"
        np.testing.assert_array_equal(np.concatenate([r[f"{tag}/keys"] for r in ports]), want_keys)
        np.testing.assert_array_equal(ref[f"{tag}/keys"], want_keys)
        for rank in ports:  # every rank learned the reference's entry
            assert json.loads(str(rank[f"{tag}/entry"])) == json.loads(str(ref[f"{tag}/entry"]))
            assert json.loads(str(rank[f"{tag}/obs"])) == json.loads(str(ref[f"{tag}/obs"]))
    assert json.loads(str(ref[f"{scenario}/0/obs"]))["partition"] == "radix"
    if world == 4:  # two buckets cannot pass the promotion ratio of 2; four can
        assert json.loads(str(ref[f"{scenario}/{CALLS - 1}/entry"]))["partition"] == "sample"
        # in the tuned cell the promotion took effect: the last call ran sample splitters
        last_obs = json.loads(str(ref[f"{scenario}/{CALLS - 1}/obs"]))["partition"]
        assert last_obs == ("sample" if scenario == "tuned" else "radix")
    # the file holds what the reference's holds (the same save decisions),
    # under the global length's bucket
    with open(workdir / f"port{world}_{scenario}.json") as f, \
            open(workdir / f"ref{world}_{scenario}.json") as g:
        doc, ref_doc = json.load(f), json.load(g)
    key = str(ports[0]["key"])
    assert key == f"{world * M}|int32|cpu/ranks={world}/procs{world}x1"
    assert doc["learned"] == {key: ref_doc["learned"][f"{world * M}|int32|cpu/x={world}"]}


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_sort_kv_learns_what_the_reference_learns_from_its_observations(results, world):
    ports = results[2][world]
    keys = mesh_keys("zipf", "int32", max(WORLDS) * M, seed=3)[: world * M]
    order = np.argsort(keys, kind="stable")
    ref_planner = Planner()
    ref_key = plan_key(world * M, jnp.int32, fingerprint=f"cpu/x={world}")
    for call in range(CALLS):
        tag = f"kv/{call}"
        np.testing.assert_array_equal(np.concatenate([r[f"{tag}/idx"] for r in ports]), order)
        np.testing.assert_array_equal(np.concatenate([r[f"{tag}/keys"] for r in ports]),
                                      keys[order])
        obs = json.loads(str(ports[0][f"{tag}/obs"]))
        want = ref_planner.observe_exchange(ref_key, ExchangeObservation(**obs)).to_dict()
        for rank in ports:
            assert json.loads(str(rank[f"{tag}/obs"])) == obs
            assert json.loads(str(rank[f"{tag}/entry"])) == want


@pytest.mark.parametrize("world", WORLDS)
def test_rank_coordinated_autotune_agrees_and_rank_0_writes(results, world):
    workdir, ports = results[0], results[2][world]
    best = {str(r["auto/best"]) for r in ports}
    assert len(best) == 1  # every rank holds the same plan
    assert [bool(r["auto/wrote"]) for r in ports] == [True] + [False] * (world - 1)
    with open(workdir / f"auto{world}.json") as f:
        doc = json.load(f)
    key = str(ports[0]["auto/key"])
    assert key == f"{world * M}|int32|cpu/ranks={world}/procs{world}x1"
    assert doc["plans"] == {key: json.loads(best.pop())}


@pytest.mark.parametrize("world", WORLDS)
def test_a_candidate_failing_on_one_rank_raises_on_every_rank(results, world):
    ports = results[2][world]
    for rank, out in enumerate(ports):
        msg = str(out["fail"])
        if rank == 1:
            assert msg == "kernel launch failed on rank 1"
        else:
            assert "failed on another rank" in msg
