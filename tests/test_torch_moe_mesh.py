"""Expert-parallel MoE on 2 and 4 ranks: ``moe_apply_local`` and
``moe_apply_local_adaptive`` against the reference on a forced CPU mesh.

The reference runs its ``shard_map`` body over a 1-D mesh axis ``x`` with
``all_axes=("x",)``; the port runs one gloo rank a process
(``tests/_torch_ranks.py``), each rank with its token block and its
experts (``moe_shard_specs``).  Both get the same params (the reference's
``moe_init``) and tokens.  Counts, drops, peaks, overflow flags and retries
are held bit for bit; outputs and the aux loss at the reference MoE tests'
atol = rtol = 1e-4, the int8 wire (``compress_dispatch``) included, whose
quantization both sides do alike.  Plan keys differ by design (the port's
fingerprint names ranks, not mesh axes), so the learned factors are
compared as values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import moe as ref_moe

from _torch_ranks import concat, replicated, run_both, save_inputs

WORLDS = (2, 4)
T = 32
OUT = dict(atol=1e-4, rtol=1e-4)
# name: (n_experts, top_k, collapse the router, compress, fixed capacity or None)
CASES = {"random": (8, 2, False, False, None), "dropping": (8, 2, True, False, 3),
         "compressed": (8, 2, False, True, None)}
ADAPTIVE_CALLS = 3

_COMMON = """
CASES = {cases!r}
T = {T}
def params(name):
    return {{k[len(name) + 1:]: v for k, v in IN.items() if k.startswith(name + "/")}}
def tree(flat):
    return {{"router": {{"w": flat["router"]}}, **{{k: v for k, v in flat.items() if k != "router"}}}}
"""

REF_BODY = _COMMON + """
from repro.models import moe
from repro.engine.planner import Planner
for name, (E, k, collapse, compress, cap) in CASES.items():
    cfg = moe.MoEConfig(d_model=16, d_ff=8, n_experts=E, top_k=k, compress_dispatch=compress)
    p = jax.tree.map(jnp.asarray, tree(params(name)))
    (ps, xs), os_ = moe.moe_shard_specs(p, mesh_axes=("x",), ep_axis="x", with_stats=True)
    f = smap(lambda mp, xt: moe.moe_apply_local(mp, cfg, xt, "x", ("x",), capacity=cap,
                                                with_stats=True), (ps, xs), os_)
    for key, v in zip(("y", "aux", "dropped", "counts", "peak", "overflow"), f(p, jnp.asarray(IN["x"]))):
        out[f"{{name}}/{{key}}"] = np.asarray(v)
cfg = moe.MoEConfig(d_model=16, d_ff=8, n_experts=8, top_k=2)
p = jax.tree.map(jnp.asarray, tree(params("adaptive")))
planner = Planner()
for call in range({calls}):
    y, aux, counts = moe.moe_apply_local_adaptive(p, cfg, jnp.asarray(IN["x"]), mesh, axes=("x",),
                                                  ep_axis="x", planner=planner)
    key = moe.moe_plan_key(T, cfg, jnp.float32, mesh)
    obs = planner.telemetry.last(key)
    out[f"adaptive/{{call}}/y"], out[f"adaptive/{{call}}/counts"] = np.asarray(y), np.asarray(counts)
    out[f"adaptive/{{call}}/obs"] = np.array([obs.retries, obs.peak, obs.capacity, obs.dropped,
                                              obs.dropped_averted, int(obs.overflowed)])
out["adaptive/cf"] = np.array(planner.capacity_factor_for(key, default=cfg.capacity_factor))
"""

PORT_BODY = _COMMON + """
from repro_torch.carry import params_from_reference
from repro_torch.engine.planner import Planner
from repro_torch.models import moe
x = shard(IN["x"])
for name, (E, k, collapse, compress, cap) in CASES.items():
    cfg = moe.MoEConfig(d_model=16, d_ff=8, n_experts=E, top_k=k, compress_dispatch=compress)
    p = moe.moe_shard_specs(params_from_reference(tree(params(name)), "cpu"), G)
    res = moe.moe_apply_local(p, cfg, x, G, capacity=cap, with_stats=True)
    for key, v in zip(("y", "aux", "dropped", "counts", "peak", "overflow"), res):
        out[f"{{name}}/{{key}}"] = v.numpy()
cfg = moe.MoEConfig(d_model=16, d_ff=8, n_experts=8, top_k=2)
p = params_from_reference(tree(params("adaptive")), "cpu")
planner = Planner(device="cpu")
key = moe.moe_plan_key(T, cfg, torch.float32, G, device="cpu")
for call in range({calls}):
    y, aux, counts = moe.moe_apply_local_adaptive(p, cfg, x, G, planner=planner)
    obs = planner.telemetry.last(key)
    out[f"adaptive/{{call}}/y"], out[f"adaptive/{{call}}/counts"] = y.numpy(), counts.numpy()
    out[f"adaptive/{{call}}/obs"] = np.array([obs.retries, obs.peak, obs.capacity, obs.dropped,
                                              obs.dropped_averted, int(obs.overflowed)])
out["adaptive/cf"] = np.array(planner.capacity_factor_for(key, default=cfg.capacity_factor))
"""


def _inputs(world: int) -> dict:
    arrays = {"x": np.random.default_rng(world).standard_normal((T, 16)).astype(np.float32)}
    cases = dict(CASES, adaptive=(8, 2, True, False, None))
    for name, (E, k, collapse, _, _) in cases.items():
        cfg = ref_moe.MoEConfig(d_model=16, d_ff=8, n_experts=E, top_k=k)
        p = ref_moe.moe_init(jax.random.PRNGKey(world), cfg, jnp.float32, ep_shards=world)
        if collapse:
            p = ref_moe.collapse_router(p)
        arrays[f"{name}/router"] = np.asarray(p["router"]["w"])
        for leaf in ("w_in", "w_out", "w_gate"):
            arrays[f"{name}/{leaf}"] = np.asarray(p[leaf])
    return arrays


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    refs, ports = {}, {}
    for world in WORLDS:  # inputs differ by world: one workdir each, run side by side
        wd = tmp_path_factory.mktemp(f"moe_mesh{world}")
        save_inputs(wd, _inputs(world))
        fmt = dict(cases=CASES, T=T, calls=ADAPTIVE_CALLS)
        r, p = run_both(REF_BODY.format(**fmt), PORT_BODY.format(**fmt), (world,), wd)
        refs[world], ports[world] = r[world], p[world]
    return refs, ports


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_local_matches_the_reference(runs, world, case):
    ref, ranks = runs[0][world], runs[1][world]
    np.testing.assert_allclose(concat(ranks, f"{case}/y"), ref[f"{case}/y"], **OUT)
    np.testing.assert_allclose(replicated(ranks, f"{case}/aux"), ref[f"{case}/aux"], **OUT)
    for key in ("dropped", "counts", "peak", "overflow"):
        np.testing.assert_array_equal(replicated(ranks, f"{case}/{key}"), ref[f"{case}/{key}"])
    if case == "dropping":
        assert int(ref["dropping/dropped"]) > 0 and bool(ref["dropping/overflow"])


@pytest.mark.parametrize("world", WORLDS)
def test_moe_apply_local_adaptive_matches_the_reference(runs, world):
    ref, ranks = runs[0][world], runs[1][world]
    for call in range(ADAPTIVE_CALLS):
        np.testing.assert_allclose(concat(ranks, f"adaptive/{call}/y"), ref[f"adaptive/{call}/y"],
                                   **OUT)
        np.testing.assert_array_equal(replicated(ranks, f"adaptive/{call}/counts"),
                                      ref[f"adaptive/{call}/counts"])
        np.testing.assert_array_equal(replicated(ranks, f"adaptive/{call}/obs"),
                                      ref[f"adaptive/{call}/obs"])
    retries = [int(ref[f"adaptive/{call}/obs"][0]) for call in range(ADAPTIVE_CALLS)]
    assert retries[0] >= 1 and retries[1:] == [0] * (ADAPTIVE_CALLS - 1)
    assert float(replicated(ranks, "adaptive/cf")) == float(ref["adaptive/cf"])
