"""The model stack on a (data, model) mesh: ``forward``, ``prefill_step``
and ``serve_decode_step`` on 2 and 4 gloo ranks against the reference.

Each case runs one config on one mesh (``data x model`` = 1x2, 2x1, 2x2,
1x4).  The port's ranks hold the reference's params in the compute layout
(``carry.shard_from_reference`` under ``compute_specs``: the table
vocab-sharded, the experts expert-sharded, and the attention heads and
dense FFN hidden units split over "model", Megatron's tensor
parallelism) and their rows of the batch.  Decoding runs at two cache
lengths: ``PROMPT + DECODE`` = 14, which a model axis of 4 does not
divide, so there every rank holds the whole cache (the reference
replicates it), and ``SPLIT_LEN`` = 16, which every model axis here
divides, so each rank holds its block of the positions (split-K).  Held:

* against the reference's single-device results: ``forward``'s logits,
  ``prefill_step``'s last logits and two greedy ``serve_decode_step``s'
  logits within atol = rtol = 1e-4, the greedy tokens equal (configs whose
  capacity drops no token, where a mesh and one device compute the same),
  at each cache length against the reference's at the same length;
* a rank's attention caches hold ``length / model`` positions where the
  model axis divides the length, else all ``length`` of them;
* against the reference's own mesh path (``_torch_mesh_lm``): the MoE
  stats of ``_hidden_states`` (tokens dropped, the per-sender peak, the
  overflow flag) bit for bit and ``aux`` within 1e-5, and ``forward``'s
  logits within 1e-4, the dropping config included.  With the int8 wire
  the logits are held within 2e-3 relative L2: a payload element a hair
  from a rounding boundary moves by a whole int8 step on one side and not
  the other (measured 5.3e-4; the wire itself moves the logits 3.4e-3
  from the float wire's);
* every rank of a model group holds the same logits, bit for bit;
* ``shard_tree`` then ``unshard_tree`` under ``param_specs`` gives the
  params back bit for bit.

The spawned groups of each world size run the cases one after another,
each side once, all at the same time.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from _torch_mesh_lm import PORT_IMPORTS, REF_IMPORTS, flat_params, ref_params, rel_l2
from _torch_ranks import run_port, run_reference, save_inputs

OUT = dict(atol=1e-4, rtol=1e-4)
INT8_WIRE_RL2 = 2e-3
AUX_RTOL = 1e-5
B, S, PROMPT, DECODE = 4, 16, 12, 2
SPLIT_LEN = 16  # PROMPT + DECODE rounded up to divide every model axis
LENGTHS = {"": PROMPT + DECODE, "split_": SPLIT_LEN}  # result-key prefix: cache length
# case: (config, (data, model), no token dropped: a mesh and one device agree)
CASES = {
    "m-1x2": ("m", (1, 2), True), "m-2x1": ("m", (2, 1), True), "m-2x2": ("m", (2, 2), True),
    "m-1x4": ("m", (1, 4), True), "drop-2x2": ("m-drop", (2, 2), False),
    "int8wire-2x2": ("m-int8wire", (2, 2), False), "granite-2x2": ("granite-moe-3b-a800m", (2, 2), True),
    "qwen3-2x2": ("qwen3-0.6b", (2, 2), True), "jamba-2x2": ("jamba-1.5-large-398b", (2, 2), True),
}
WORLDS = (2, 4)

REF_BODY = """
from repro.models.transformer import ShardCtx, forward
from repro.train.steps import _hidden_states, prefill_step, serve_decode_step
CASES = {cases!r}
single = {{}}
for case, (name, shape, _) in CASES.items():
    cfg = config(name)
    params = tree_of(f"{{case}}/p/")
    toks = jnp.asarray(IN[f"{{case}}/tokens"])
    ctx = ShardCtx(mesh=amesh(shape), axes=("data", "model"))
    logits, st = jax.jit(lambda p, t: forward(p, cfg, t, ctx=ctx, remat=False))(params, toks)
    out[f"{{case}}/mesh_logits"] = np.asarray(logits)
    _, hs = jax.jit(lambda p, t: _hidden_states(p, cfg, t, None, ctx, False))(params, toks)
    for k in ("moe_aux", "moe_overflow", "moe_dropped", "moe_peak"):
        out[f"{{case}}/mesh_{{k}}"] = np.asarray(hs[k])
    key = (name, shape[1])
    if key not in single:  # one device: the params depend only on the model axis
        res = {{"logits": np.asarray(jax.jit(lambda p, t: forward(p, cfg, t, remat=False)[0])(params, toks))}}
        step = jax.jit(lambda p, t, c: serve_decode_step(p, cfg, t, c))
        for tag, cache_len in {lengths!r}.items():
            last, cache = jax.jit(lambda p, t: prefill_step(p, cfg, t, cache_len=cache_len))(
                params, toks[:, :{prompt}])
            res[tag + "prefill"] = np.asarray(last)
            nxt, toks_out, dec = jnp.argmax(last, -1), [], []
            for i in range({decode}):
                toks_out.append(np.asarray(nxt))
                lg, cache = step(params, nxt[:, None].astype(jnp.int32), cache)
                dec.append(np.asarray(lg[:, 0]))
                nxt = jnp.argmax(lg[:, 0], -1)
            res[tag + "greedy"], res[tag + "decode"] = np.stack(toks_out, 1), np.stack(dec, 1)
        single[key] = res
    for k, v in single[key].items():
        out[f"{{case}}/single_{{k}}"] = v
"""

PORT_BODY = """
from repro_torch.carry import params_from_reference, shard_from_reference
from repro_torch.distributed.sharding import (compute_specs, fit_tree, param_specs, shard_tree,
                                              unshard_tree)
from repro_torch.models.transformer import forward
from repro_torch.train.steps import _hidden_states, prefill_step, serve_decode_step
CASES = {cases!r}
for case, (name, shape, _) in CASES.items():
    if math.prod(shape) != WORLD:
        continue
    cfg = config(name)
    mesh = Mesh(shape, ("data", "model"))
    ctx = ShardCtx(mesh=mesh, axes=mesh.axis_names)
    full = tree_of(f"{{case}}/p/")
    params = shard_from_reference(full, compute_specs(param_specs(full), cfg, shape[1]), mesh,
                                  "cpu")
    toks = rows(torch.from_numpy(IN[f"{{case}}/tokens"]), mesh)
    with torch.no_grad():
        logits, _ = forward(params, cfg, toks, ctx=ctx)
        out[f"{{case}}/mesh_logits"] = logits.numpy()
        _, hs = _hidden_states(params, cfg, toks, None, ctx, False)
        for k in ("moe_aux", "moe_overflow", "moe_dropped", "moe_peak"):
            out[f"{{case}}/mesh_{{k}}"] = np.asarray(hs[k])
        for tag, cache_len in {lengths!r}.items():
            last, cache = prefill_step(params, cfg, toks[:, :{prompt}], ctx=ctx,
                                       cache_len=cache_len)
            out[f"{{case}}/{{tag}}prefill"] = last.numpy()
            nxt, toks_out, dec = torch.argmax(last, -1), [], []
            for i in range({decode}):
                toks_out.append(nxt.numpy())
                lg, cache = serve_decode_step(params, cfg, nxt[:, None].int(), cache, ctx=ctx)
                dec.append(lg[:, 0].numpy())
                nxt = torch.argmax(lg[:, 0], -1)
            out[f"{{case}}/{{tag}}greedy"] = np.stack(toks_out, 1)
            out[f"{{case}}/{{tag}}decode"] = np.stack(dec, 1)
            out[f"{{case}}/{{tag}}cache_positions"] = np.array(
                [c.k.shape[2] for c in cache.values() if hasattr(c, "k")])
    tfull = params_from_reference(full, "cpu")
    specs = fit_tree(param_specs(tfull), tfull, mesh)
    back = unshard_tree(shard_tree(tfull, specs, mesh), specs, mesh)
    out[f"{{case}}/roundtrip"] = np.array(all(
        torch.equal(a.view(torch.int32), b.view(torch.int32))
        for (_, a), (_, b) in zip(paths(back), paths(tfull))))
"""


def _inputs() -> dict:
    """Params per (config, model axis) and tokens per config: the
    reference's one-device results are computed once for each pair."""
    arrays, drawn, tokens = {}, {}, {}
    rng = np.random.default_rng(0)
    for case, (name, shape, _) in CASES.items():
        key = (name, shape[1])
        if key not in drawn:
            drawn[key] = flat_params(ref_params(name, shape[1]), "")
        if name not in tokens:
            tokens[name] = rng.integers(0, 64, (B, S)).astype(np.int32)
        arrays.update({f"{case}/p/{k}": v for k, v in drawn[key].items()})
        arrays[f"{case}/tokens"] = tokens[name]
    return arrays


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("mesh_model")
    save_inputs(wd, _inputs())
    fmt = dict(cases=CASES, prompt=PROMPT, decode=DECODE, lengths=LENGTHS)
    with ThreadPoolExecutor(max_workers=1 + len(WORLDS)) as pool:
        ref = pool.submit(run_reference, REF_IMPORTS + REF_BODY.format(**fmt), 4, wd)
        ports = {w: pool.submit(run_port, PORT_IMPORTS + PORT_BODY.format(**fmt), w, wd, 420)
                 for w in WORLDS}
        return ref.result(), {w: f.result() for w, f in ports.items()}


def _ranks(runs, case):
    _, shape, _ = CASES[case]
    return shape, runs[1][int(np.prod(shape))]


def _by_data(ranks, shape, key):
    """The batch rows in order: each data coordinate's rows, checked equal
    on every rank of its model group."""
    data, model = shape
    blocks = []
    for d in range(data):
        group = [ranks[d * model + m][key] for m in range(model)]
        for g in group[1:]:
            np.testing.assert_array_equal(g, group[0])
        blocks.append(group[0])
    return np.concatenate(blocks)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_forward_matches_the_reference(runs, case):
    ref = runs[0]
    shape, ranks = _ranks(runs, case)
    got = _by_data(ranks, shape, f"{case}/mesh_logits")
    if CASES[case][0] == "m-int8wire":
        assert rel_l2(got, ref[f"{case}/mesh_logits"]) <= INT8_WIRE_RL2
    else:
        np.testing.assert_allclose(got, ref[f"{case}/mesh_logits"], **OUT)
    if CASES[case][2]:
        np.testing.assert_allclose(got, ref[f"{case}/single_logits"], **OUT)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_moe_stats_match_the_reference_mesh(runs, case):
    ref = runs[0]
    shape, ranks = _ranks(runs, case)
    for k in ("moe_overflow", "moe_dropped", "moe_peak"):
        for r in ranks:
            np.testing.assert_array_equal(r[f"{case}/mesh_{k}"], ref[f"{case}/mesh_{k}"], err_msg=k)
    for r in ranks:
        np.testing.assert_allclose(r[f"{case}/mesh_moe_aux"], ref[f"{case}/mesh_moe_aux"],
                                   rtol=AUX_RTOL)
    if case == "drop-2x2":
        assert int(ref[f"{case}/mesh_moe_dropped"]) > 0 and bool(ref[f"{case}/mesh_moe_overflow"])


def _check_decode(runs, case, tag):
    ref = runs[0]
    shape, ranks = _ranks(runs, case)
    np.testing.assert_allclose(_by_data(ranks, shape, f"{case}/{tag}prefill"),
                               ref[f"{case}/single_{tag}prefill"], **OUT)
    np.testing.assert_allclose(_by_data(ranks, shape, f"{case}/{tag}decode"),
                               ref[f"{case}/single_{tag}decode"], **OUT)
    np.testing.assert_array_equal(_by_data(ranks, shape, f"{case}/{tag}greedy"),
                                  ref[f"{case}/single_{tag}greedy"])


@pytest.mark.parametrize("case", sorted(c for c, (_, _, same) in CASES.items() if same))
def test_mesh_prefill_and_greedy_decode_match_one_device(runs, case):
    _check_decode(runs, case, "")


@pytest.mark.parametrize("case", sorted(c for c, (_, _, same) in CASES.items() if same))
def test_split_k_prefill_and_greedy_decode_match_one_device(runs, case):
    _check_decode(runs, case, "split_")


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_cache_splits_its_positions_where_the_model_axis_divides_them(runs, case):
    (_, model), ranks = _ranks(runs, case)
    for tag, length in LENGTHS.items():
        want = length // model if length % model == 0 else length
        for r in ranks:
            held = r[f"{case}/{tag}cache_positions"]
            assert len(held) and set(held.tolist()) == {want}, (tag, held)


@pytest.mark.parametrize("case", sorted(CASES))
def test_shard_then_unshard_gives_the_params_back(runs, case):
    _, ranks = _ranks(runs, case)
    assert all(bool(r[f"{case}/roundtrip"]) for r in ranks)
