"""The port's model stack and configs against the reference's.

``repro_torch.configs`` must hold the reference's ten ARCHS number for
number; ``forward`` of each reduced arch (float32), with the reference's
params carried across, must give the reference's logits at atol 2e-3,
rtol 1e-3 (the reference serving test's prefill tolerance).  The chunked
attention, the sliding-window blocks and the SSD scan are held at the
layers' float32 atol = rtol = 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models import attention as ref_attn
from repro.models import mamba2 as ref_mamba
from repro.models import transformer as ref_tf
from repro_torch.carry import params_from_reference
from repro_torch.configs import base
from repro_torch.models import attention, mamba2, transformer

ARCH_IDS = sorted(ref_base.ARCHS)
STACK = dict(atol=2e-3, rtol=1e-3)
LAYER = dict(atol=1e-5, rtol=1e-5)


def fields(cfg) -> dict:
    """A config's fields with dtypes as names, comparable across packages."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name.endswith("_dtype"):
            v = str(v).removeprefix("torch.") if isinstance(v, torch.dtype) else jnp.dtype(v).name
        out[f.name] = v
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_the_reference(arch):
    want, got = ref_base.ARCHS[arch], base.ARCHS[arch]
    assert fields(got) == fields(want)
    assert fields(base.reduced(got)) == fields(ref_base.reduced(want))
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert got.n_groups == want.n_groups


def test_shape_table_and_cells_equal_the_reference():
    assert base.SHAPES == ref_base.SHAPES and base.SUBQUADRATIC == ref_base.SUBQUADRATIC
    assert base.all_cells() == ref_base.all_cells()
    assert list(base.ARCHS) == list(ref_base.ARCHS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_of_the_reduced_arch(arch):
    rcfg = ref_base.reduced(ref_base.ARCHS[arch])
    tcfg = base.reduced(base.ARCHS[arch])
    rp = ref_tf.model_init(jax.random.PRNGKey(0), rcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, rp), "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, rcfg.vocab_size, (2, 16)).astype(np.int32)
    fe = None
    if rcfg.frontend != "none":
        fe = rng.standard_normal((2, rcfg.n_frontend_tokens, rcfg.d_model)).astype(np.float32)
    want, wstats = ref_tf.forward(rp, rcfg, jnp.asarray(toks), remat=False,
                                  frontend_embeds=None if fe is None else jnp.asarray(fe))
    got, gstats = transformer.forward(tp, tcfg, torch.from_numpy(toks),
                                      frontend_embeds=None if fe is None else torch.from_numpy(fe))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STACK)
    np.testing.assert_allclose(float(gstats["moe_aux"]), float(wstats["moe_aux"]), **STACK)
    assert bool(gstats["moe_overflow"]) == bool(wstats["moe_overflow"])


def test_param_tree_layout_equals_the_reference():
    for arch in ("jamba-1.5-large-398b", "gemma3-12b", "musicgen-medium"):
        rcfg = ref_base.reduced(ref_base.ARCHS[arch])
        tcfg = base.reduced(base.ARCHS[arch])
        rp = ref_tf.model_init(jax.random.PRNGKey(0), rcfg, ep_shards=2)
        tp = transformer.model_init(torch.Generator().manual_seed(0), tcfg, ep_shards=2, device="cpu")
        rl = jax.tree_util.tree_flatten_with_path(rp)[0]
        tl = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(tp)[0]}
        assert {jax.tree_util.keystr(k): (v.shape, v.dtype.name) for k, v in rl} == \
            {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in tl.items()}


def qkv(B, S, H, Hk, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, h, hd)).astype(np.float32) for h in (H, Hk, Hk)]


@pytest.mark.parametrize("S,kv_chunk,window", [(12, 5, 0), (16, 16, 0), (13, 4, 6)])
def test_flash_causal_with_a_non_dividing_chunk(S, kv_chunk, window):
    cfg = ref_attn.AttnConfig(32, 4, 2, 8, kv_chunk=kv_chunk, sliding_window=window)
    q, k, v = qkv(2, S, 4, 2, 8, S)
    want = ref_attn._flash_causal(*map(jnp.asarray, (q, k, v)), cfg)
    got = attention._flash_causal(*map(torch.from_numpy, (q, k, v)), attention.AttnConfig(*cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)


@pytest.mark.parametrize("S,w", [(16, 4), (13, 4), (9, 8)])
def test_blocked_local(S, w):
    cfg = ref_attn.AttnConfig(32, 4, 2, 8, sliding_window=w)
    q, k, v = qkv(2, S, 4, 2, 8, S + w)
    want = ref_attn._blocked_local(*map(jnp.asarray, (q, k, v)), cfg)
    got = attention._blocked_local(*map(torch.from_numpy, (q, k, v)), attention.AttnConfig(*cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)


@pytest.mark.parametrize("S,chunk,with_h0", [(12, 5, False), (16, 4, True), (7, 8, False)])
def test_ssd_chunked(S, chunk, with_h0):
    cfg = ref_mamba.MambaConfig(d_model=32, d_state=8, head_dim=8, chunk=chunk)
    nh = cfg.n_heads
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, nh, 8)).astype(np.float32)
    dt = np.abs(rng.standard_normal((2, S, nh))).astype(np.float32) * 0.1
    B_ = rng.standard_normal((2, S, 1, 8)).astype(np.float32)
    C_ = rng.standard_normal((2, S, 1, 8)).astype(np.float32)
    A = -np.linspace(1.0, 4.0, nh).astype(np.float32)
    h0 = rng.standard_normal((2, nh, 8, 8)).astype(np.float32) if with_h0 else None
    wy, wh = ref_mamba._ssd_chunked(cfg, *map(jnp.asarray, (x, dt, B_, C_, A)),
                                    h0=None if h0 is None else jnp.asarray(h0))
    gy, gh = mamba2._ssd_chunked(mamba2.MambaConfig(*cfg), *map(torch.from_numpy, (x, dt, B_, C_, A)),
                                 h0=None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **LAYER)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **LAYER)


def test_a_group_raises_rather_than_running_on_one_device():
    """A ShardCtx with a mesh runs: on a one-rank (data=1, model=1) mesh,
    forward and the MoE FFN equal ShardCtx()'s bit for bit (the name is
    from when a group raised here)."""
    from _torch_ranks import one_rank_mesh

    cfg = base.reduced(base.ARCHS["granite-moe-3b-a800m"])
    params = transformer.model_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))).int()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 8, cfg.d_model))).float()
    p0 = transformer.group_params(params["blocks"], 0)["pos0"]
    want, want_stats = transformer.forward(params, cfg, tokens)
    want_ffn, want_ffn_stats = transformer._apply_ffn(p0, cfg, x, transformer.ShardCtx(), {})
    with one_rank_mesh() as mesh:
        ctx = transformer.ShardCtx(mesh=mesh, axes=mesh.axis_names)
        assert ctx.ep_shards == 1 and ctx.batch_axes == ("data",)
        got, stats = transformer.forward(params, cfg, tokens, ctx=ctx)
        got_ffn, ffn_stats = transformer._apply_ffn(p0, cfg, x, ctx, {})
    assert torch.equal(got, want) and torch.equal(got_ffn, want_ffn)
    for s_got, s_want in ((stats, want_stats), (ffn_stats, want_ffn_stats)):
        assert set(s_got) == set(s_want)
        assert all(torch.equal(torch.as_tensor(s_got[k]), torch.as_tensor(s_want[k])) for k in s_got)
