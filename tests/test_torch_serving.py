"""The port's serving path against the reference's: ``prefill_step`` and
``serve_decode_step`` per family, and ``launch.serve.main`` on every top-k
route.

Params (and, for one test, caches) cross from the reference through
``carry``.  Tolerances are the reference serving test's: prefill logits at
atol 2e-3, decode logits at atol 5e-3, rtol 1e-3 both (float32 configs).
Greedy tokens and the ``--moe --stats`` counters are held exactly, except
``recompiles``, which the port, compiling nothing, reports as 0.  Sampling
at ``temperature > 0`` draws from torch's generator, which cannot repeat
``jax.random``'s draws: held by distribution (every draw inside the top-k
set, frequencies within binomial bounds of the softmax), not draw for draw.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.engine.planner as ref_planner_mod
import repro.launch.serve as ref_serve
import repro_torch.engine.planner as planner_mod
from repro.configs.base import ARCHS as REF_ARCHS, reduced as ref_reduced
from repro.models import transformer as ref_tf
from repro.train import steps as ref_steps
from repro_torch.carry import cache_from_reference, params_from_reference
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.train import steps

PREFILL = dict(atol=2e-3, rtol=1e-3)
DECODE = dict(atol=5e-3, rtol=1e-3)

F32 = dict(param_dtype=jnp.float32, compute_dtype=jnp.float32)
# the reference serving test's families (tests/test_serving.py)
FAMILIES = {
    "dense": dict(name="d", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
                  vocab_size=64, qk_norm=True, qkv_bias=True, kv_chunk=8),
    "ssm": dict(name="s", n_layers=2, d_model=32, n_heads=0, n_kv_heads=0, head_dim=0, d_ff=0,
                vocab_size=64, pattern=("mamba",), ffn_pattern=(None,), ssm_state=16,
                ssm_head_dim=8, ssm_chunk=4),
    "local": dict(name="l", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
                  vocab_size=64, pattern=("attn_l", "attn"), ffn_pattern=("dense", "dense"),
                  sliding_window=4, kv_chunk=4),
    "moe": dict(name="m", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=16,
                vocab_size=64, pattern=("attn",), ffn_pattern=("moe",), n_experts=4, top_k=2,
                capacity_factor=8.0, kv_chunk=8),
    "hybrid": dict(name="h", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=16,
                   vocab_size=64, pattern=("attn", "mamba"), ffn_pattern=("moe", "dense"),
                   n_experts=4, top_k=2, capacity_factor=8.0, ssm_state=16, ssm_head_dim=8,
                   ssm_chunk=4, kv_chunk=8),
}


def configs(family):
    kw = FAMILIES[family]
    return (ref_tf.ModelConfig(**kw, **F32),
            transformer.ModelConfig(**kw, param_dtype=torch.float32, compute_dtype=torch.float32))


def carried(rcfg, seed=0):
    rp = ref_tf.model_init(jax.random.PRNGKey(seed), rcfg)
    return rp, params_from_reference(jax.tree.map(np.asarray, rp), "cpu")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_prefill_then_decode_match_the_reference(family):
    rcfg, tcfg = configs(family)
    rp, tp = carried(rcfg)
    rng = np.random.default_rng(0)
    S = 12
    toks = rng.integers(0, rcfg.vocab_size, (2, S)).astype(np.int32)
    ref_prefill = jax.jit(lambda p, t: ref_steps.prefill_step(p, rcfg, t, cache_len=S + 4))
    ref_decode = jax.jit(lambda p, t, c: ref_steps.serve_decode_step(p, rcfg, t, c))
    want, rcache = ref_prefill(rp, jnp.asarray(toks))
    got, tcache = steps.prefill_step(tp, tcfg, torch.from_numpy(toks), cache_len=S + 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PREFILL)
    # the port's prefill continues as the reference's, and so does the
    # reference's own cache carried across
    carried_cache = cache_from_reference(rcache, "cpu")
    for _ in range(3):
        nxt = rng.integers(0, rcfg.vocab_size, (2, 1)).astype(np.int32)
        want, rcache = ref_decode(rp, jnp.asarray(nxt), rcache)
        got, tcache = steps.serve_decode_step(tp, tcfg, torch.from_numpy(nxt), tcache)
        from_ref, carried_cache = steps.serve_decode_step(tp, tcfg, torch.from_numpy(nxt),
                                                          carried_cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **DECODE)
        np.testing.assert_allclose(from_ref.numpy(), np.asarray(want), **DECODE)
    for name, c in tcache.items():
        for t, r in zip(c, rcache[name]):
            np.testing.assert_allclose(t.float().numpy(), np.asarray(r, np.float32), **DECODE)


def test_decode_from_an_empty_cache_matches_forward():
    rcfg, tcfg = configs("dense")
    _, tp = carried(rcfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (2, 6)).astype(np.int32))
    cache = transformer.init_cache(tcfg, 2, 16, device="cpu")
    outs = []
    for t in range(6):
        lg, new = transformer.decode_step(tp, tcfg, toks[:, t: t + 1], cache)
        assert int(cache["pos0"].length[0]) == t  # the cache passed in is left as it was
        cache = new
        outs.append(lg)
    full, _ = transformer.forward(tp, tcfg, toks)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), **PREFILL)


ROUTES = {"direct": [], "queue": ["--topk-queue", "--stats"],
          "tenants": ["--tenants", "web:3:0,batch:1:1", "--slo-ms", "500", "--warmup"]}
FLAGS = ["--arch", "qwen3-0.6b", "--reduced", "--temperature", "0", "--batch", "3",
         "--prompt-len", "8", "--gen", "5"]


@pytest.fixture(scope="module")
def reference_tokens():
    """The reference's greedy tokens on each route."""
    return {route: np.asarray(ref_serve.main(FLAGS + extra)) for route, extra in ROUTES.items()}


@pytest.fixture
def reference_params(monkeypatch):
    """The port's serve.main with the reference's initial params carried in."""
    cfg = ref_reduced(REF_ARCHS["qwen3-0.6b"])
    params = ref_tf.model_init(jax.random.PRNGKey(0), cfg)
    tree = jax.tree.map(np.asarray, params)
    monkeypatch.setattr(serve, "model_init",
                        lambda gen, cfg, ep_shards, device: params_from_reference(tree, device))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_greedy_tokens_match_the_reference_on_every_route(route, reference_tokens,
                                                          reference_params, capsys):
    got = serve.main(FLAGS + ROUTES[route] + ["--device", "cpu"])
    assert got.dtype == np.int32 and got.shape == (3, 5)
    for want in reference_tokens.values():  # greedy: one answer whatever the route
        np.testing.assert_array_equal(got, want)
    out = capsys.readouterr().out
    if route == "tenants":
        assert "slo_misses=0/15" in out and "shed=0" in out
    if route == "queue":
        assert "requests=15" in out


@pytest.mark.parametrize("route", ["direct", "queue"])
def test_sampled_ids_lie_in_the_top_k_and_fit_the_softmax(route):
    from repro_torch.engine import AsyncSortService

    rng = np.random.default_rng(2)
    rows = rng.standard_normal((4, 50)).astype(np.float32) * 2
    k, temp = 5, 0.7
    n = 2000 if route == "direct" else 16  # draws of each row
    top = np.argsort(-rows, axis=1, kind="stable")[:, :k]
    gen = torch.Generator().manual_seed(0)
    queue = AsyncSortService(max_batch=64, device="cpu") if route == "queue" else None
    try:  # n copies of each row in one batch: row r's draws are picks[:, r]
        picks = serve.sample_next(torch.from_numpy(np.tile(rows, (n, 1))), gen, temperature=temp,
                                  top_k=k, queue=queue).numpy().reshape(n, 4)
    finally:
        if queue is not None:
            queue.close()
    assert picks.dtype == np.int32
    for row in range(4):
        assert set(picks[:, row].tolist()) <= set(top[row].tolist())
    if route == "direct":
        logits = torch.from_numpy(rows)
        for row in range(4):
            z = logits.numpy()[row, top[row]] / temp
            p = np.exp(z - z.max())
            p /= p.sum()
            freq = np.array([(picks[:, row] == i).sum() for i in top[row]])
            sigma = np.sqrt(n * p * (1 - p))
            assert np.all(np.abs(freq - n * p) <= 5 * sigma + 1), (freq, n * p)


def test_sampling_main_stays_inside_the_vocabulary():
    gen_ids = serve.main(["--reduced", "--batch", "2", "--prompt-len", "6", "--gen", "4",
                          "--top-k", "4", "--device", "cpu"])
    assert gen_ids.shape == (2, 4) and gen_ids.min() >= 0 and gen_ids.max() < 128


def _moe_stats(out: str) -> dict:
    line = next(ln for ln in out.splitlines() if ln.startswith("moe-stats:"))
    stats = dict(kv.split("=") for kv in line.split()[1:])
    stats["first_retries"] = re.search(r"\(retries=(\d+)\)", out).group(1)
    stats["learned_cf"] = re.search(r"learned_cf=([\d.]+)", out).group(1)
    return stats


def test_moe_route_counters_match_the_reference(monkeypatch, capsys):
    monkeypatch.delenv("REPRO_SORT_PLANS", raising=False)
    monkeypatch.setattr(ref_planner_mod, "_DEFAULT", None)  # fresh process-wide planners
    monkeypatch.setattr(planner_mod, "_DEFAULT", None)
    flags = ["--moe", "--batch", "4", "--prompt-len", "16", "--gen", "4", "--experts", "8",
             "--moe-skew", "6.0", "--stats"]
    ref_serve.main(flags)
    want = _moe_stats(capsys.readouterr().out)
    serve.main(flags + ["--device", "cpu"])
    got = _moe_stats(capsys.readouterr().out)
    assert got.pop("recompiles") == "0"
    want.pop("recompiles")
    assert got == want
    assert int(got["retries"]) == int(got["first_retries"]) >= 1  # step 1 only
