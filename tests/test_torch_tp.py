"""Tensor parallelism over "model" and the split-K decode cache, on 2 and 4
gloo ranks against the reference.

Reduced qwen3 (qk-norm; its 2 KV heads split on a model axis of 2, whole
and sliced on 4), qwen2 (QKV biases, split with their columns), gemma3 (a
local ring buffer of 8 slots under split-K) and granite (TP attention
beside the EP experts), each on meshes 1x2, 2x2 and 1x4, and qwen2 with 6
heads on 1x4, where the heads do not divide "model" and every rank runs
every head.  The port's ranks store their blocks under ``param_specs``
(FSDP x TP) for the loss and gradients, and hold the compute layout
(``compute_specs``) for prefill and decode, with a cache of ``CACHE_LEN``
positions split over "model".  Held, in float32:

* against the reference's single device: the loss within 1e-5 relative,
  the gradients per leaf within 1e-4 relative L2 (gathered from the
  blocks), prefill's last logits and every greedy decode step's logits
  within 1e-5 of the largest logit's magnitude (max absolute error: the
  logits reach about 30, and float32 sums of 64 terms that size differ in
  their last bits), the greedy tokens equal (granite's decode too: no
  token drops at its capacity factor of 4);
* granite's loss and gradients against the reference's own mesh
  (``AxisType.Auto``), the oracle for the mesh-only MoE semantics (each
  sender's capacity, ``aux`` averaged over the senders), at the same
  tolerances;
* the layout: a rank's compute blocks of ``wq`` / ``wo`` / ``w_in`` /
  ``w_gate`` / ``w_out`` are 1/model of the whole (``wk`` / ``wv`` where
  the KV heads divide, else whole; every leaf whole where the heads do
  not divide), its cache holds 1/model of every attention cache's
  positions, and on qwen3 with split KV heads a rank's forward does
  exactly 1/model of one device's matrix-product FLOPs on the same rows.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from _torch_mesh_lm import PORT_IMPORTS, REF_IMPORTS, flat_params, rel_l2
from _torch_ranks import run_port, run_reference, save_inputs

LOSS_RTOL, GRAD_RL2, LOGITS_SHARE = 1e-5, 1e-4, 1e-5
B, S, PROMPT, DECODE, CHUNK = 4, 16, 12, 3, 8
CACHE_LEN = 16
ARCH = {"qwen3": "qwen3-0.6b", "qwen2": "qwen2-7b", "gemma3": "gemma3-12b",
        "granite": "granite-moe-3b-a800m", "qwen2-6h": "qwen2-7b"}
CASES = {f"{n}-{d}x{m}": (n, (d, m)) for n in ("qwen3", "qwen2", "gemma3", "granite")
         for d, m in ((1, 2), (2, 2), (1, 4))}
CASES["qwen2-6h-1x4"] = ("qwen2-6h", (1, 4))
MESH_ORACLE = ("granite",)  # MoE: the reference's mesh holds the loss and gradients

CONFIGS = """
ARCH = {arch!r}
def tp_config(name):
    cfg = reduced(ARCHS[ARCH[name]])
    if name == "qwen2-6h":  # 6 heads: whole heads on a model axis of 4
        cfg = dataclasses.replace(cfg, n_heads=6, n_kv_heads=2)
    return cfg
""".format(arch=ARCH)

REF_BODY = """
from repro.models.transformer import ShardCtx
from repro.train.steps import loss_fn, prefill_step, serve_decode_step
CASES, MESH_ORACLE = {cases!r}, {oracle!r}
single = {{}}
for case, (name, shape) in CASES.items():
    cfg = tp_config(name)
    params = tree_of(f"{{case}}/p/")
    toks = IN[f"{{case}}/tokens"]
    batch = {{"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}}
    ctx = ShardCtx(mesh=amesh(shape), axes=("data", "model")) if name in MESH_ORACLE else ShardCtx()
    (loss, _), g = jax.jit(lambda p: jax.value_and_grad(loss_fn, has_aux=True)(
        p, cfg, batch, ctx=ctx, loss_chunk={chunk}, remat=False))(params)
    out.update(flat(g, f"{{case}}/grad/"))
    out[f"{{case}}/loss"] = np.asarray(loss)
    key = (name, shape[1])
    if key not in single:  # the params depend only on the model axis
        last, cache = jax.jit(lambda p, t: prefill_step(p, cfg, t, cache_len={cache_len}))(
            params, batch["tokens"][:, :{prompt}])
        res = {{"prefill": np.asarray(last)}}
        step = jax.jit(lambda p, t, c: serve_decode_step(p, cfg, t, c))
        nxt, toks_out, dec = jnp.argmax(last, -1), [], []
        for i in range({decode}):
            toks_out.append(np.asarray(nxt))
            lg, cache = step(params, nxt[:, None].astype(jnp.int32), cache)
            dec.append(np.asarray(lg[:, 0]))
            nxt = jnp.argmax(lg[:, 0], -1)
        res["greedy"], res["decode"] = np.stack(toks_out, 1), np.stack(dec, 1)
        single[key] = res
    for k, v in single[key].items():
        out[f"{{case}}/{{k}}"] = v
"""

PORT_BODY = """
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.carry import params_from_reference, shard_from_reference
from repro_torch.distributed.sharding import compute_specs, fit_tree, param_specs, unshard_tree
from repro_torch.models.transformer import forward
from repro_torch.train.steps import loss_fn, prefill_step, serve_decode_step
from repro_torch.tree import from_paths
CASES = {cases!r}
def flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()
for case, (name, shape) in CASES.items():
    if math.prod(shape) != WORLD:
        continue
    cfg = tp_config(name)
    mesh = Mesh(shape, ("data", "model"))
    ctx = ShardCtx(mesh=mesh, axes=mesh.axis_names)
    full = tree_of(f"{{case}}/p/")
    whole = params_from_reference(full, "cpu")
    specs = fit_tree(param_specs(whole), whole, mesh)
    toks = rows(torch.from_numpy(IN[f"{{case}}/tokens"]), mesh)
    batch = {{"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}}
    pairs = list(paths(shard_from_reference(full, specs, mesh, "cpu")))
    leaves = [t.detach().requires_grad_(True) for _, t in pairs]
    loss, _ = loss_fn(from_paths((p, t) for (p, _), t in zip(pairs, leaves)), cfg, batch, ctx=ctx,
                      loss_chunk={chunk}, specs=specs)
    grads = from_paths((p, g) for (p, _), g in zip(pairs, torch.autograd.grad(loss, leaves)))
    grads = unshard_tree(grads, specs, mesh)
    if RANK == 0:
        out.update(flat(grads, f"{{case}}/grad/"))
    out[f"{{case}}/loss"] = loss.detach().numpy()
    params = shard_from_reference(full, compute_specs(param_specs(full), cfg, shape[1]), mesh, "cpu")
    blk = params["blocks"]["pos0"]
    for leaf, t in (("wq", blk["attn"]["wq"]["w"]), ("wk", blk["attn"]["wk"]["w"]),
                    ("wo", blk["attn"]["wo"]["w"])):
        out[f"{{case}}/width/{{leaf}}"] = np.array(t.shape[-1] if leaf != "wo" else t.shape[-2])
    if "ffn" in blk:
        for leaf in ("w_in", "w_gate"):
            out[f"{{case}}/width/{{leaf}}"] = np.array(blk["ffn"][leaf]["w"].shape[-1])
        out[f"{{case}}/width/w_out"] = np.array(blk["ffn"]["w_out"]["w"].shape[-2])
    with torch.no_grad():
        last, cache = prefill_step(params, cfg, batch["tokens"][:, :{prompt}], ctx=ctx,
                                   cache_len={cache_len})
        out[f"{{case}}/prefill"] = last.numpy()
        out[f"{{case}}/cache_positions"] = np.array([c.k.shape[2] for c in cache.values()])
        nxt, toks_out, dec = torch.argmax(last, -1), [], []
        for i in range({decode}):
            toks_out.append(nxt.numpy())
            lg, cache = serve_decode_step(params, cfg, nxt[:, None].int(), cache, ctx=ctx)
            dec.append(lg[:, 0].numpy())
            nxt = torch.argmax(lg[:, 0], -1)
        out[f"{{case}}/greedy"], out[f"{{case}}/decode"] = np.stack(toks_out, 1), np.stack(dec, 1)
        out[f"{{case}}/flops_mesh"] = np.array(flops(lambda: forward(params, cfg, batch["tokens"],
                                                                     ctx=ctx)))
        out[f"{{case}}/flops_one"] = np.array(flops(lambda: forward(whole, cfg, batch["tokens"])))
"""


def _inputs() -> dict:
    import jax

    from repro.configs import base as ref_base
    from repro.models import transformer as ref_tf

    arrays, drawn, tokens = {}, {}, {}
    rng = np.random.default_rng(0)
    for case, (name, shape) in CASES.items():
        key = (name, shape[1])
        if key not in drawn:
            cfg = ref_base.reduced(ref_base.ARCHS[ARCH[name]])
            if name == "qwen2-6h":
                import dataclasses

                cfg = dataclasses.replace(cfg, n_heads=6, n_kv_heads=2)
            drawn[key] = flat_params(jax.tree.map(np.asarray, ref_tf.model_init(
                jax.random.PRNGKey(0), cfg, ep_shards=shape[1])), "")
        if name not in tokens:
            tokens[name] = rng.integers(0, 64, (B, S + 1)).astype(np.int32)
        arrays.update({f"{case}/p/{k}": v for k, v in drawn[key].items()})
        arrays[f"{case}/tokens"] = tokens[name]
    return arrays


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("tp")
    save_inputs(wd, _inputs())
    fmt = dict(cases=CASES, oracle=MESH_ORACLE, prompt=PROMPT, decode=DECODE,
               cache_len=CACHE_LEN, chunk=CHUNK)
    with ThreadPoolExecutor(max_workers=3) as pool:
        ref = pool.submit(run_reference, REF_IMPORTS + CONFIGS + REF_BODY.format(**fmt), 4, wd)
        ports = {w: pool.submit(run_port, PORT_IMPORTS + CONFIGS + PORT_BODY.format(**fmt), w, wd,
                                600)
                 for w in (2, 4)}
        return ref.result(), {w: f.result() for w, f in ports.items()}


def _ranks(runs, case):
    shape = CASES[case][1]
    return shape, runs[1][shape[0] * shape[1]]


def _by_data(ranks, shape, key):
    """The batch rows in order, each data coordinate's rows equal on every
    rank of its model group."""
    data, model = shape
    blocks = []
    for d in range(data):
        group = [ranks[d * model + m][key] for m in range(model)]
        for g in group[1:]:
            np.testing.assert_array_equal(g, group[0])
        blocks.append(group[0])
    return np.concatenate(blocks)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradients_match_the_reference(runs, case):
    ref = runs[0]
    _, ranks = _ranks(runs, case)
    for r in ranks:
        np.testing.assert_allclose(r[f"{case}/loss"], ref[f"{case}/loss"], rtol=LOSS_RTOL)
    prefix = f"{case}/grad/"
    want = {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}
    got = {k[len(prefix):]: v for k, v in ranks[0].items() if k.startswith(prefix)}
    assert set(got) == set(want) and want
    for k, g in want.items():
        assert rel_l2(got[k], g) <= GRAD_RL2, (k, rel_l2(got[k], g))


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_split_k_decode_match_one_device(runs, case):
    ref = runs[0]
    shape, ranks = _ranks(runs, case)
    for key in ("prefill", "decode"):
        got, want = _by_data(ranks, shape, f"{case}/{key}"), ref[f"{case}/{key}"]
        assert got.shape == want.shape
        err = np.abs(got - want).max()
        assert err <= LOGITS_SHARE * np.abs(want).max(), (key, err, np.abs(want).max())
    np.testing.assert_array_equal(_by_data(ranks, shape, f"{case}/greedy"), ref[f"{case}/greedy"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_rank_holds_its_share_of_the_dense_weights_and_the_cache(runs, case):
    name, (data, model) = CASES[case]
    _, ranks = _ranks(runs, case)
    from repro_torch.configs.base import ARCHS, reduced

    cfg = reduced(ARCHS[ARCH[name]])
    heads, kv = (6, 2) if name == "qwen2-6h" else (cfg.n_heads, cfg.n_kv_heads)
    split = heads % model == 0
    q = heads * cfg.head_dim
    want = {"wq": q // model if split else q, "wo": q // model if split else q,
            "wk": kv * cfg.head_dim // (model if split and kv % model == 0 else 1)}
    if name != "granite":
        want.update(dict.fromkeys(("w_in", "w_gate", "w_out"), cfg.d_ff // model))
    lengths = {CACHE_LEN} | ({cfg.sliding_window} if cfg.sliding_window else set())
    for r in ranks:
        for leaf, width in want.items():
            assert int(r[f"{case}/width/{leaf}"]) == width, leaf
        assert set(r[f"{case}/cache_positions"].tolist()) == {n // model for n in lengths}


@pytest.mark.parametrize("case", ["qwen3-1x2", "qwen3-2x2"])
def test_a_rank_computes_its_share_of_the_forward(runs, case):
    """Heads, KV heads, FFN and vocabulary all divide: a rank does exactly
    1/model of one device's matrix-product FLOPs on its rows."""
    _, (_, model) = CASES[case]
    _, ranks = _ranks(runs, case)
    for r in ranks:
        assert int(r[f"{case}/flops_mesh"]) * model == int(r[f"{case}/flops_one"])
