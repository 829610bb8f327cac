"""The port's AdamW (``repro_torch.optim.adamw``) against the reference's.

The same params and gradients (numpy from a seed) go through both
packages' ``apply_updates`` for a few steps, each side carrying its own
state: params, ``m``, ``v`` and ``err`` agree within 1e-6 relative (per
leaf, relative L2: both compute in float32, XLA may fuse a multiply-add
and its ``pow`` is another implementation; ``err``, the quantizer's
residual, relative to the clipped gradient it corrects).  Where that moves a value
across a rounding tie, an int8 ``q`` differs by one: such entries are
counted and held to 1 % of a leaf.  The schedule and the quantizer are
held at float32 round-off.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.models.transformer import ModelConfig as RefModelConfig
from repro.models.transformer import model_init as ref_model_init
from repro.optim import adamw as ref
from repro_torch.carry import opt_state_from_reference, params_from_reference, tensor_to_reference
from repro_torch.models.transformer import ModelConfig
from repro_torch.optim import adamw
from repro_torch.train.steps import train_step
from repro_torch.tree import at_path, paths

STATE_RTOL = 1e-6
TIE_SHARE = 0.01


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def test_lr_schedule_equals_the_reference():
    for cfg in (adamw.OptConfig(peak_lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
                adamw.OptConfig(peak_lr=3e-3, warmup_steps=2, total_steps=12)):
        rcfg = ref.OptConfig(**vars(cfg))
        steps = np.arange(0, cfg.total_steps + 20)
        got = np.array([float(adamw.lr_at(cfg, int(s))) for s in steps])
        want = np.array([float(ref.lr_at(rcfg, int(s))) for s in steps])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    cfg = adamw.OptConfig(peak_lr=1.0, warmup_steps=10, total_steps=100)
    assert float(adamw.lr_at(cfg, 0)) == 0.0
    assert float(adamw.lr_at(cfg, 10)) == pytest.approx(1.0, abs=1e-6)
    assert float(adamw.lr_at(cfg, 100)) == pytest.approx(0.1, abs=1e-6)
    assert float(adamw.lr_at(cfg, torch.tensor(55, dtype=torch.int32))) < 1.0


@pytest.mark.parametrize("shape,seed", [((1, 2), 0), ((1, 300), 1), ((4, 129), 2), ((3, 5, 7), 3)])
def test_quantize_equals_the_reference_and_round_trips(shape, seed):
    x = (np.random.default_rng(seed).standard_normal(shape) * 50).astype(np.float32)
    x.flat[0] = 0.0
    got = adamw.quantize_blockwise(torch.from_numpy(x))
    want = ref.quantize_blockwise(jnp.asarray(x))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    back = adamw.dequantize_blockwise(got, torch.from_numpy(x)).numpy()
    scale = np.abs(x).max(-1, keepdims=True)
    assert (np.abs(back - x) <= scale / 127.0 * 0.51 + 1e-7).all()
    zero = adamw.quantize_blockwise(torch.zeros(2, 4))  # an all-zero row stays zero
    assert not zero["q"].any() and not zero["scale"].any()


def _tiny():
    rcfg = RefModelConfig("t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                          d_ff=64, vocab_size=64, param_dtype=jnp.float32,
                          compute_dtype=jnp.float32, kv_chunk=8)
    return rcfg, as_np(ref_model_init(jax.random.PRNGKey(0), rcfg))


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.05).astype(np.float32), params)


def _check_state(got, want, label, norms=None):
    """Float leaves within STATE_RTOL (relative to ``norms[path]`` where
    given, else to the leaf); int8 ``q`` within one, at no more than
    TIE_SHARE of a leaf's entries."""
    for path, w in paths(want):
        g = at_path(got, path)
        if isinstance(w, dict):  # int8 moment
            gq, wq = g["q"].numpy().astype(np.int32), np.asarray(w["q"], np.int32)
            off = np.abs(gq - wq)
            assert off.max(initial=0) <= 1, (label, path)
            assert int(off.sum()) <= TIE_SHARE * max(wq.size, 100), (label, path, int(off.sum()))
            assert rel_l2(g["scale"].numpy(), w["scale"]) <= STATE_RTOL, (label, path)
        elif norms is not None:
            diff = np.linalg.norm(tensor_to_reference(g).astype(np.float64) - w)
            assert diff <= STATE_RTOL * norms[path], (label, path)
        else:
            assert rel_l2(tensor_to_reference(g), w) <= STATE_RTOL, (label, path)


@pytest.mark.parametrize("state_dtype,compress", [("f32", False), ("int8", False),
                                                  ("f32", True), ("int8", True)])
def test_apply_updates_equals_the_reference(state_dtype, compress):
    _, params = _tiny()
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10, state_dtype=state_dtype,
              compress_grads=compress)
    rcfg, tcfg = ref.OptConfig(**kw), adamw.OptConfig(**kw)
    rp, rs = params, as_np(ref.init_opt_state(params, rcfg))
    tp, ts = params_from_reference(params, "cpu"), adamw.init_opt_state(
        params_from_reference(params, "cpu"), tcfg)
    # the initial states agree too (and carry across)
    _check_state(opt_state_from_reference(rs, "cpu")["m"], rs["m"], "init")
    for step in range(3):
        g = _grads(params, step)
        rp, rs, rm = ref.apply_updates(rp, g, rs, rcfg)
        rp, rs = as_np(rp), as_np(rs)
        tp, ts, tm = adamw.apply_updates(tp, params_from_reference(g, "cpu"), ts, tcfg)
        assert int(ts["count"]) == int(rs["count"]) == step + 1
        assert float(tm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=1e-6)
        for path, w in paths(rp):
            assert rel_l2(tensor_to_reference(at_path(tp, path)), w) <= STATE_RTOL, (step, path)
        for name in ("m", "v"):
            _check_state(ts[name], rs[name], f"{name} step {step}")
        if compress:
            clip = min(1.0, rcfg.clip_norm / float(rm["grad_norm"]))
            norms = {path: clip * np.linalg.norm(leaf) for path, leaf in paths(g)}
            _check_state(ts["err"], rs["err"], f"err step {step}", norms)
    assert set(ts) == set(rs)


def test_grad_clipping_applies_as_in_the_reference():
    _, params = _tiny()
    kw = dict(peak_lr=1e-3, clip_norm=1e-6, warmup_steps=1, total_steps=10)
    tp = params_from_reference(params, "cpu")
    tcfg = adamw.OptConfig(**kw)
    g = jax.tree.map(lambda p: np.ones(p.shape, np.float32), params)
    p2, _, m = adamw.apply_updates(tp, params_from_reference(g, "cpu"), adamw.init_opt_state(tp, tcfg),
                                   tcfg)
    rp2, _, rm = ref.apply_updates(params, g, ref.init_opt_state(params, ref.OptConfig(**kw)),
                                   ref.OptConfig(**kw))
    # with a vanishing clip norm the update reduces to ~weight decay only
    delta = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(paths(tp), paths(p2)))
    assert delta < 1e-3
    assert float(m["grad_norm"]) > 1.0
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=1e-6)
    for path, w in paths(as_np(rp2)):
        assert rel_l2(at_path(p2, path).numpy(), w) <= STATE_RTOL


def test_bf16_params_update_in_float32():
    """A bfloat16 param's update is computed in float32 and cast once: the
    same as updating its float32 copy and casting the result."""
    gen = torch.Generator().manual_seed(0)
    p = {"w": torch.randn(4, 8, generator=gen).to(torch.bfloat16)}
    g = {"w": (torch.randn(4, 8, generator=gen) * 1e-2).to(torch.bfloat16)}
    cfg = adamw.OptConfig(peak_lr=1e-2, warmup_steps=0, total_steps=10)
    new, state, _ = adamw.apply_updates(p, g, adamw.init_opt_state(p, cfg), cfg)
    p32 = {"w": p["w"].float()}
    new32, _, _ = adamw.apply_updates(p32, g, adamw.init_opt_state(p32, cfg), cfg)
    assert new["w"].dtype == torch.bfloat16 and state["m"]["w"].dtype == torch.float32
    assert torch.equal(new["w"], new32["w"].to(torch.bfloat16))


@pytest.mark.parametrize("state_dtype,compress", [("f32", False), ("int8", False),
                                                  ("f32", True), ("int8", True)])
def test_training_converges_all_variants(state_dtype, compress):
    """The reference's convergence test, on the port's train_step."""
    rcfg, params = _tiny()
    cfg = ModelConfig("t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
                      vocab_size=64, param_dtype=torch.float32, compute_dtype=torch.float32,
                      kv_chunk=8)
    ocfg = adamw.OptConfig(peak_lr=1e-2, warmup_steps=5, total_steps=60, state_dtype=state_dtype,
                           compress_grads=compress)
    p = params_from_reference(params, "cpu")
    opt = adamw.init_opt_state(p, ocfg)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(25):
        toks = torch.from_numpy((rng.integers(0, 32, size=(4, 17)) * 2).astype(np.int32) % 64)
        p, opt, m = train_step(p, opt, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, cfg=cfg,
                               opt_cfg=ocfg, loss_chunk=8)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 5, (state_dtype, compress, losses[0], losses[-1])
