"""``repro_torch.models.moe`` against ``repro.models.moe`` on one device.

The reference initializes the params (``jax.random``); they cross into the
port through ``carry.params_from_reference``.  Routing (top-k indices),
per-expert counts, drops, peaks, overflow flags, retries and plan keys are
held bit for bit; float outputs at the reference MoE tests' atol = rtol =
1e-4 (probabilities, gates and the aux loss at 1e-5).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine.planner import Planner as RefPlanner
from repro.models import moe as ref
from repro_torch.carry import params_from_reference
from repro_torch.engine.planner import Planner
from repro_torch.models import moe

OUT = dict(atol=1e-4, rtol=1e-4)
PROB = dict(atol=1e-5, rtol=1e-5)


def make(n_experts=4, top_k=2, *, ep_shards=1, cf=2.0, gated=True, collapse=False, seed=0):
    rcfg = ref.MoEConfig(d_model=16, d_ff=8, n_experts=n_experts, top_k=top_k,
                         capacity_factor=cf, mlp_gated=gated)
    rp = ref.moe_init(jax.random.PRNGKey(seed), rcfg, jnp.float32, ep_shards=ep_shards)
    if collapse:
        rp = ref.collapse_router(rp)
    tcfg = moe.MoEConfig(*rcfg)
    return rcfg, rp, tcfg, params_from_reference(jax.tree.map(np.asarray, rp), "cpu")


def tokens(T, seed, d=16):
    return np.random.default_rng(seed).standard_normal((T, d)).astype(np.float32)


def np_(t):
    return np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)


@pytest.mark.parametrize("case", ["random", "collapsed", "padded"])
def test_router_probs(case):
    if case == "padded":  # 5 real experts padded to 8 over 4 shards
        rcfg, rp, tcfg, tp = make(5, 2, ep_shards=4)
    else:
        rcfg, rp, tcfg, tp = make(8, 3, collapse=case == "collapsed")
    x = tokens(64, 1)
    want = ref.router_probs(rp, rcfg, jnp.asarray(x))
    got = moe.router_probs(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(np_(got[0]), np_(want[0]), **PROB)
    assert got[1].dtype == torch.int32
    np.testing.assert_array_equal(np_(got[1]), np_(want[1]))
    np.testing.assert_allclose(np_(got[2]), np_(want[2]), **PROB)
    np.testing.assert_allclose(float(got[3]), float(want[3]), **PROB)
    if case == "collapsed":  # ties at logit 0 drain to the lowest index
        assert set(np_(got[1]).reshape(-1).tolist()) <= {0, 1, 2, 3}
    if case == "padded":
        assert int(got[1].max()) < 5 and np.allclose(np_(got[0])[:, 5:], 0.0)


def test_collapse_router_matches_reference():
    _, rp, _, tp = make(8, 2)
    got = moe.collapse_router(tp)["router"]["w"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.collapse_router(rp)["router"]["w"]))
    stacked = {"router": {"w": torch.ones(3, 16, 8)}}
    assert moe.collapse_router(stacked, 2.0)["router"]["w"][:, :, 0].eq(2.0).all()


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("capacity", [None, 3])  # 3 drops: 48 assignments over 4 experts
@pytest.mark.parametrize("with_stats", [False, True])
def test_ep_replicated(gated, capacity, with_stats):
    rcfg, rp, tcfg, tp = make(4, 2, gated=gated, collapse=capacity is not None)
    x = tokens(24, 2)
    want = ref.moe_apply_ep_replicated(rp, rcfg, jnp.asarray(x), capacity=capacity,
                                       with_stats=with_stats)
    got = moe.moe_apply_ep_replicated(tp, tcfg, torch.from_numpy(x), capacity=capacity,
                                      with_stats=with_stats)
    assert len(got) == len(want)
    np.testing.assert_allclose(np_(got[0]), np_(want[0]), **OUT)
    np.testing.assert_allclose(float(got[1]), float(want[1]), **PROB)
    for g, w in zip(got[2:], want[2:]):  # dropped, counts, peak, overflow / overflow
        np.testing.assert_array_equal(np_(g), np_(w))
    if capacity is not None:
        assert bool(got[-1])
        if with_stats:
            assert int(got[2]) > 0


@pytest.mark.parametrize("tokens_n,n_experts,top_k", [(1000, 16, 4), (64, 5, 2), (1, 8, 1)])
def test_moe_plan_key(tokens_n, n_experts, top_k):
    rcfg = ref.MoEConfig(16, 8, n_experts, top_k)
    want = ref.moe_plan_key(tokens_n, rcfg, jnp.float32)
    assert moe.moe_plan_key(tokens_n, moe.MoEConfig(*rcfg), torch.float32, device="cpu") == want
    assert moe.moe_plan_key(tokens_n, moe.MoEConfig(*rcfg), torch.bfloat16, device="cpu") == \
        ref.moe_plan_key(tokens_n, rcfg, jnp.bfloat16)


@pytest.mark.parametrize("drops,peak,capacity", [([], 3, 4), ([7], 9, 4), ([7, 3], 9, 8),
                                                 ([7, 3, 1], 9, 8), ([5, 0], 9, 16)])
def test_drop_report(drops, peak, capacity):
    seen = {"ref": [], "port": []}
    kw = dict(m=64, part_buckets=4, capacity=capacity, peak=peak, overflowed=True, retries=1,
              recompiles=0, partition=None)
    ref._drop_report(lambda **k: seen["ref"].append(k), list(drops))(**kw)
    moe._drop_report(lambda **k: seen["port"].append(k), list(drops))(**kw)
    assert seen["port"] == seen["ref"]
    assert moe._drop_report(None, []) is None


def test_adaptive_retries_once_then_never_and_survives_reload(tmp_path):
    """Call 1 overflows and retries; calls 2-3 and a reloaded planner's first
    call retry nothing; the learned factor and every observation equal the
    reference's."""
    rcfg, rp, tcfg, tp = make(8, 1, collapse=True)
    x = tokens(64, 3)
    rplan, tplan = RefPlanner(str(tmp_path / "ref.json")), Planner(str(tmp_path / "port.json"),
                                                                   device="cpu")
    key = ref.moe_plan_key(64, rcfg, jnp.float32)
    assert moe.moe_plan_key(64, tcfg, torch.float32, device="cpu") == key
    fields = ("m", "part_buckets", "capacity", "peak", "overflowed", "retries", "dropped",
              "dropped_averted")
    for call in range(3):
        ry, _, rc = ref.moe_apply_adaptive(rp, rcfg, jnp.asarray(x), planner=rplan)
        ty, _, tc = moe.moe_apply_adaptive(tp, tcfg, torch.from_numpy(x), planner=tplan)
        np.testing.assert_allclose(ty.numpy(), np.asarray(ry), **OUT)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(rc))
        ro, to = rplan.telemetry.last(key), tplan.telemetry.last(key)
        assert {f: getattr(to, f) for f in fields} == {f: getattr(ro, f) for f in fields}
        assert (to.retries >= 1) == (call == 0) and to.dropped == 0
        assert to.recompiles == 0
    cf = tplan.capacity_factor_for(key, default=tcfg.capacity_factor)
    assert cf == rplan.capacity_factor_for(key, default=rcfg.capacity_factor) > tcfg.capacity_factor
    reloaded = Planner(str(tmp_path / "port.json"), device="cpu")
    assert reloaded.capacity_factor_for(key, default=tcfg.capacity_factor) == cf
    moe.moe_apply_adaptive(tp, tcfg, torch.from_numpy(x), planner=reloaded)
    assert reloaded.telemetry.last(key).retries == 0
    assert os.path.exists(tmp_path / "port.json")


def test_fixed_capacity_path_reports_real_drops():
    rcfg, rp, tcfg, tp = make(8, 1, collapse=True)
    x = tokens(64, 4)
    rplan, tplan = RefPlanner(), Planner(device="cpu")
    ry, _, _ = ref.moe_apply_adaptive(rp, rcfg, jnp.asarray(x), planner=rplan, max_retries=0)
    ty, _, _ = moe.moe_apply_adaptive(tp, tcfg, torch.from_numpy(x), planner=tplan, max_retries=0)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), **OUT)
    key = ref.moe_plan_key(64, rcfg, jnp.float32)
    ro, to = rplan.telemetry.last(key), tplan.telemetry.last(key)
    assert to.overflowed and to.retries == 0 and to.dropped == ro.dropped > 0
    assert to.dropped_averted == 0


def test_explicit_capacity_factor_opts_out_of_the_loop():
    _, _, tcfg, tp = make(8, 1, collapse=True)
    planner = Planner(device="cpu")
    moe.moe_apply_adaptive(tp, tcfg, torch.from_numpy(tokens(64, 5)), planner=planner,
                           capacity_factor=8.0)
    assert planner.telemetry.calls == 0 and not planner.learned
