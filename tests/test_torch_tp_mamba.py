"""Mamba-2 split over "model" (head-parallel SSM blocks), on 2 and 4 gloo
ranks against the reference.

Reduced mamba2-1.3b (one Mamba-2 layer) and reduced jamba (seven Mamba-2
layers beside an attention layer and MoE FFNs): d_model 64, so 8 SSM heads
of 16, state 16, float32, each on meshes 1x2, 2x2 and 1x4; and a mamba2
with d_model 48 (6 heads) on 1x4, where the heads do not divide "model"
and every rank runs every head.  The port's ranks store their blocks under
``param_specs`` (FSDP x TP: a Mamba leaf's "model" block holds its heads'
``z`` / ``x`` / ``dt`` columns and a quarter or half of ``B`` / ``C``) for
the loss and gradients, and hold the compute layout (``compute_specs``:
their heads, ``B`` / ``C`` whole) for prefill and decode.  Held, in
float32:

* the loss within 1e-5 relative and the gradients per leaf within 1e-4
  relative L2 (gathered with ``unshard_tree``, in the reference's column
  order): mamba2 against the reference's single device, jamba against
  the reference's own mesh (``AxisType.Auto``), the oracle for the MoE
  layers' mesh-only semantics (each sender's capacity, ``aux`` averaged
  over the senders);
* against the reference's single device: prefill's last logits and 4
  greedy decode steps' logits within 1e-5 of the largest logit's
  magnitude, the greedy tokens equal, and the prefilled caches (gathered
  with ``cache_specs``: the conv window's ``x`` channels by heads, ``B`` /
  ``C`` whole on every rank) within 1e-5 of each leaf's largest magnitude
  (float32 sums over the ranks' partial products differ from one device's
  in their last bits);
* ``shard_tree`` then ``unshard_tree`` under ``param_specs`` gives the
  params back bit for bit; a mesh checkpoint of the blocks restores in the
  reference's ``CheckpointManager`` bit for bit, and onto the same mesh as
  the same blocks;
* the layout: a rank's compute-layout Mamba params hold ``1/model`` of one
  device's bytes plus the rest of the ``B`` / ``C`` columns and channels,
  its SSM state exactly ``1/model``, its conv window ``1/model`` of the
  ``x`` channels plus all of ``B`` / ``C``; every stored Mamba leaf of
  ``in_proj`` / the conv / ``out_proj`` is evenly split; where the heads
  do not divide, every Mamba leaf of the compute layout is whole.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from _torch_mesh_lm import PORT_IMPORTS, REF_IMPORTS, flat_params, rel_l2
from _torch_ranks import run_port, run_reference, save_inputs

LOSS_RTOL, GRAD_RL2, LOGITS_SHARE, CACHE_SHARE = 1e-5, 1e-4, 1e-5, 1e-5
B, S, PROMPT, DECODE, CHUNK = 4, 16, 12, 4, 8
CACHE_LEN = 16
ARCH = {"mamba2": "mamba2-1.3b", "jamba": "jamba-1.5-large-398b", "mamba2-6h": "mamba2-1.3b"}
CASES = {f"{n}-{d}x{m}": (n, (d, m)) for n in ("mamba2", "jamba")
         for d, m in ((1, 2), (2, 2), (1, 4))}
CASES["mamba2-6h-1x4"] = ("mamba2-6h", (1, 4))
MESH_ORACLE = ("jamba",)  # MoE: the reference's mesh holds the loss and gradients
CHECKPOINTED = ("jamba-2x2", "mamba2-1x4")

CONFIGS = """
ARCH = {arch!r}
def tp_config(name):
    cfg = reduced(ARCHS[ARCH[name]])
    if name == "mamba2-6h":  # 6 SSM heads: whole heads on a model axis of 4
        cfg = dataclasses.replace(cfg, d_model=48)
    return cfg
def flat_cache(cache, prefix):
    return {{f"{{prefix}}{{name}}/{{f}}": np.asarray(t) for name, c in cache.items()
            for f, t in zip(c._fields, c)}}
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
        res = {{"prefill": np.asarray(last), **flat_cache(cache, "cache/")}}
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
from repro_torch.carry import params_from_reference, shard_from_reference
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed.sharding import (cache_specs, compute_specs, fit_tree, param_specs,
                                              shard_tree, unshard_tree)
from repro_torch.models.transformer import init_cache
from repro_torch.train.steps import loss_fn, prefill_step, serve_decode_step
from repro_torch.tree import from_paths
CASES, CHECKPOINTED = {cases!r}, {checkpointed!r}
def nbytes(tree, *words):
    return np.array(sum(t.numel() * t.element_size() for p, t in paths(tree)
                        if all(w in p for w in words)))
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
    blocks = shard_from_reference(full, specs, mesh, "cpu")
    pairs = list(paths(blocks))
    leaves = [t.detach().requires_grad_(True) for _, t in pairs]
    loss, _ = loss_fn(from_paths((p, t) for (p, _), t in zip(pairs, leaves)), cfg, batch, ctx=ctx,
                      loss_chunk={chunk}, specs=specs)
    grads = from_paths((p, g) for (p, _), g in zip(pairs, torch.autograd.grad(loss, leaves)))
    grads = unshard_tree(grads, specs, mesh)
    if RANK == 0:
        out.update(flat(grads, f"{{case}}/grad/"))
    out[f"{{case}}/loss"] = loss.detach().numpy()
    back = unshard_tree(shard_tree(whole, specs, mesh), specs, mesh)
    out[f"{{case}}/roundtrip"] = np.array(all(
        torch.equal(a.view(torch.int32), b.view(torch.int32))
        for (_, a), (_, b) in zip(paths(back), paths(whole))))
    for layer in ("in_proj", "conv_w", "conv_b", "out_proj"):
        out[f"{{case}}/stored/{{layer}}"] = nbytes(blocks, "mamba", layer)
    if case in CHECKPOINTED:
        mgr = CheckpointManager(f"{{IN_DIR}}/ckpt/{{case}}")
        mgr.save(1, blocks, shardings=specs, mesh=mesh)
        restored, _ = mgr.restore(blocks, shardings=specs, mesh=mesh)
        out[f"{{case}}/restored"] = np.array(all(
            torch.equal(a, b) for (_, a), (_, b) in zip(paths(restored), paths(blocks))))
    params = shard_from_reference(full, compute_specs(param_specs(full), cfg, shape[1]), mesh, "cpu")
    out[f"{{case}}/mamba_bytes"] = nbytes(params, "mamba")
    out[f"{{case}}/in_proj_width"] = np.array(params["blocks"]["pos0"]["mamba"]["in_proj"]["w"].shape[-1])
    with torch.no_grad():
        last, cache = prefill_step(params, cfg, batch["tokens"][:, :{prompt}], ctx=ctx,
                                   cache_len={cache_len})
        out[f"{{case}}/prefill"] = last.numpy()
        mamba = [c for c in cache.values() if hasattr(c, "ssm")]
        out[f"{{case}}/ssm_bytes"] = np.array(sum(c.ssm.nbytes for c in mamba))
        out[f"{{case}}/conv_bytes"] = np.array(sum(c.conv.nbytes for c in mamba))
        like = init_cache(cfg, {b}, {cache_len}, "meta")
        gathered = unshard_tree(cache, fit_tree(cache_specs(like, cfg), like, mesh), mesh)
        if RANK == 0:
            out.update(flat_cache(gathered, f"{{case}}/cache/"))
        nxt, toks_out, dec = torch.argmax(last, -1), [], []
        for i in range({decode}):
            toks_out.append(nxt.numpy())
            lg, cache = serve_decode_step(params, cfg, nxt[:, None].int(), cache, ctx=ctx)
            dec.append(lg[:, 0].numpy())
            nxt = torch.argmax(lg[:, 0], -1)
        out[f"{{case}}/greedy"], out[f"{{case}}/decode"] = np.stack(toks_out, 1), np.stack(dec, 1)
"""


def _config(name):
    import dataclasses

    from repro.configs import base as ref_base

    cfg = ref_base.reduced(ref_base.ARCHS[ARCH[name]])
    return dataclasses.replace(cfg, d_model=48) if name == "mamba2-6h" else cfg


def _inputs() -> dict:
    import jax

    from repro.models import transformer as ref_tf

    arrays, drawn, tokens = {}, {}, {}
    rng = np.random.default_rng(0)
    for case, (name, shape) in CASES.items():
        key = (name, shape[1])
        if key not in drawn:
            drawn[key] = flat_params(jax.tree.map(np.asarray, ref_tf.model_init(
                jax.random.PRNGKey(0), _config(name), ep_shards=shape[1])), "")
        if name not in tokens:
            tokens[name] = rng.integers(0, 64, (B, S + 1)).astype(np.int32)
        arrays.update({f"{case}/p/{k}": v for k, v in drawn[key].items()})
        arrays[f"{case}/tokens"] = tokens[name]
    return arrays


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("tp_mamba")
    save_inputs(wd, _inputs())
    fmt = dict(cases=CASES, oracle=MESH_ORACLE, prompt=PROMPT, decode=DECODE,
               cache_len=CACHE_LEN, chunk=CHUNK, checkpointed=CHECKPOINTED, b=B)
    port = PORT_IMPORTS + f"IN_DIR = {str(wd)!r}\n" + CONFIGS + PORT_BODY.format(**fmt)
    with ThreadPoolExecutor(max_workers=3) as pool:
        ref = pool.submit(run_reference, REF_IMPORTS + CONFIGS + REF_BODY.format(**fmt), 4, wd)
        ports = {w: pool.submit(run_port, port, w, wd, 600) for w in (2, 4)}
        return ref.result(), {w: f.result() for w, f in ports.items()}, wd


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


def _sub(d: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradients_match_the_reference(runs, case):
    ref = runs[0]
    _, ranks = _ranks(runs, case)
    for r in ranks:
        np.testing.assert_allclose(r[f"{case}/loss"], ref[f"{case}/loss"], rtol=LOSS_RTOL)
    want, got = _sub(ref, f"{case}/grad/"), _sub(ranks[0], f"{case}/grad/")
    assert set(got) == set(want) and any("mamba" in k for k in want)
    for k, g in want.items():
        assert rel_l2(got[k], g) <= GRAD_RL2, (k, rel_l2(got[k], g))


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_greedy_decode_match_one_device(runs, case):
    ref = runs[0]
    shape, ranks = _ranks(runs, case)
    for key in ("prefill", "decode"):
        got, want = _by_data(ranks, shape, f"{case}/{key}"), ref[f"{case}/{key}"]
        assert got.shape == want.shape
        err = np.abs(got - want).max()
        assert err <= LOGITS_SHARE * np.abs(want).max(), (key, err, np.abs(want).max())
    np.testing.assert_array_equal(_by_data(ranks, shape, f"{case}/greedy"), ref[f"{case}/greedy"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_prefilled_caches_gather_to_one_devices(runs, case):
    ref = runs[0]
    _, ranks = _ranks(runs, case)
    want, got = _sub(ref, f"{case}/cache/"), _sub(ranks[0], f"{case}/cache/")
    assert set(got) == set(want) and any(k.endswith("/ssm") for k in want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        err = np.abs(got[k].astype(np.float64) - w).max()
        assert err <= CACHE_SHARE * max(np.abs(w).max(), 1.0), (k, err)


@pytest.mark.parametrize("case", sorted(CASES))
def test_shard_then_unshard_is_the_identity(runs, case):
    _, ranks = _ranks(runs, case)
    assert all(bool(r[f"{case}/roundtrip"]) for r in ranks)


@pytest.mark.parametrize("case", CHECKPOINTED)
def test_a_mesh_checkpoint_restores_in_the_reference_manager(runs, case):
    import jax

    from repro.checkpoint.manager import CheckpointManager as RefManager

    wd = runs[2]
    with np.load(wd / "inputs.npz") as z:
        whole = {k[len(f"{case}/p/"):]: z[k] for k in z.files if k.startswith(f"{case}/p/")}
    tree = {}
    for k, v in whole.items():
        node = tree
        *head, leaf = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = v
    assert all(bool(r[f"{case}/restored"]) for r in _ranks(runs, case)[1])
    restored, step = RefManager(str(wd / "ckpt" / case)).restore(
        jax.tree.map(np.zeros_like, tree))
    assert step == 1
    got = flat_params(jax.tree.map(np.asarray, restored), "")
    assert set(got) == set(whole)
    for k, v in whole.items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k


def _widths(name):
    cfg = _config(name)
    mc = cfg.mamba_cfg()
    return cfg, mc, mc.n_groups * mc.d_state


@pytest.mark.parametrize("case", sorted(c for c, (n, _) in CASES.items() if n != "mamba2-6h"))
def test_a_rank_holds_its_heads_share_of_mamba_and_its_state(runs, case):
    name, (data, model) = CASES[case]
    _, ranks = _ranks(runs, case)
    cfg, mc, gs = _widths(name)
    D, k, di, nh = cfg.d_model, mc.conv_kernel, mc.d_inner, mc.n_heads
    layers = cfg.n_groups * cfg.pattern.count("mamba")
    f32 = 4 * layers
    proj = D * (2 * di + 2 * gs + nh)
    whole = f32 * (proj + k * mc.conv_dim + mc.conv_dim + di * D + 3 * nh + di)
    bc = f32 * (D + k + 1) * 2 * gs               # B / C columns and channels, whole
    conv_whole = 4 * layers * (B // data) * (k - 1) * mc.conv_dim
    conv_bc = 4 * layers * (B // data) * (k - 1) * 2 * gs
    ssm_whole = 4 * layers * (B // data) * nh * mc.d_state * mc.head_dim
    for r in ranks:
        assert int(r[f"{case}/mamba_bytes"]) * model == whole - bc + model * bc
        assert int(r[f"{case}/in_proj_width"]) == (2 * di + nh) // model + 2 * gs
        assert int(r[f"{case}/ssm_bytes"]) * model == ssm_whole
        assert int(r[f"{case}/conv_bytes"]) * model == conv_whole - conv_bc + model * conv_bc
        stored = {"in_proj": f32 * proj // (data * model), "out_proj": f32 * di * D // (data * model),
                  "conv_w": f32 * k * mc.conv_dim // model, "conv_b": f32 * mc.conv_dim // model}
        for layer, want in stored.items():
            assert int(r[f"{case}/stored/{layer}"]) == want, layer


def test_heads_that_do_not_divide_run_whole_on_every_rank(runs):
    case = "mamba2-6h-1x4"
    _, ranks = _ranks(runs, case)
    cfg, mc, gs = _widths("mamba2-6h")
    assert mc.n_heads % 4
    for r in ranks:
        assert int(r[f"{case}/in_proj_width"]) == 2 * mc.d_inner + 2 * gs + mc.n_heads
        assert int(r[f"{case}/ssm_bytes"]) == 4 * B * mc.n_heads * mc.d_state * mc.head_dim


def test_a_head_split_with_more_than_one_b_c_group_raises():
    """Every config has one ``B`` / ``C`` group; a head split of a block
    with more refuses to run rather than read the wrong group."""
    from types import SimpleNamespace

    import torch

    from repro_torch.models.mamba2 import MambaConfig, mamba_init, mamba_train

    mc = MambaConfig(d_model=32, d_state=8, head_dim=16, n_groups=2, chunk=8)
    p = mamba_init(torch.Generator().manual_seed(0), mc, torch.float32, device="cpu")
    assert mamba_train(p, mc, torch.ones(1, 8, 32)).shape == (1, 8, 32)
    with pytest.raises(NotImplementedError, match="n_groups=2"):
        mamba_train(p, mc, torch.ones(1, 8, 32), group=SimpleNamespace(size=2, rank=0))
