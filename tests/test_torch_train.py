"""The port's training step (``repro_torch.train.steps``) against the reference's.

Reduced float32 configs, the reference's params carried across
(``carry.params_from_reference``), the same seeded numpy batch through both
packages on their single device.  Tolerances:

* loss and CE within 1e-5 relative; MoE drop and peak counts equal;
* gradients per leaf within 1e-4 relative L2;
* one ``train_step`` (1 and 2 microbatches, remat on and off): the update
  (new - old params) per leaf within 1e-3 relative L2 (AdamW divides by
  sqrt(v), which amplifies the gradients' round-off where they are small),
  ``grad_norm`` and ``lr`` within 1e-5 relative.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models import attention as ref_attn
from repro.models import mamba2 as ref_mamba
from repro.models import transformer as ref_tf
from repro.models.moe import collapse_router as ref_collapse
from repro.optim import adamw as ref_adamw
from repro.train import steps as ref_steps
from repro_torch.carry import opt_state_from_reference, params_from_reference
from repro_torch.configs import base
from repro_torch.models import attention, mamba2
from repro_torch.optim import adamw
from repro_torch.train import steps
from repro_torch.tree import at_path, paths

LOSS_RTOL = 1e-5
GRAD_RL2 = 1e-4
UPDATE_RL2 = 1e-3
METRIC_RTOL = 1e-5
B, S, CHUNK = 2, 16, 8
TRAIN_ARCHS = ["qwen3-0.6b", "granite-moe-3b-a800m", "mamba2-1.3b", "jamba-1.5-large-398b",
               "gemma3-12b"]


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def configs(arch, **changes):
    rcfg = dataclasses.replace(ref_base.reduced(ref_base.ARCHS[arch]), **changes)
    tcfg = dataclasses.replace(base.reduced(base.ARCHS[arch]), **changes)
    return rcfg, tcfg


def ref_params(rcfg, skew=0.0):
    p = ref_tf.model_init(jax.random.PRNGKey(0), rcfg)
    if skew:
        p["blocks"] = {pos: {**gp, "moe": ref_collapse(gp["moe"], skew)} if "moe" in gp else gp
                       for pos, gp in p["blocks"].items()}
    return jax.tree.map(np.asarray, p)


def make_batch(cfg, seed=0, batch=B):
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, cfg.vocab_size, (batch, S + 1)).astype(np.int32)
    labels = tok[:, 1:].copy()
    labels[0, :3] = -1  # masked positions
    return {"tokens": tok[:, :-1], "labels": labels}


def to_ref(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def ref_loss_and_grads(rcfg, params, batch, **kw):
    (loss, stats), grads = jax.jit(jax.value_and_grad(
        lambda p: ref_steps.loss_fn(p, rcfg, to_ref(batch), loss_chunk=CHUNK, **kw),
        has_aux=True))(params)
    return float(loss), {k: np.asarray(v) for k, v in stats.items()}, jax.tree.map(np.asarray, grads)


def port_loss_and_grads(tcfg, params, batch, **kw):
    tp = params_from_reference(params, "cpu")
    leaves = [leaf.requires_grad_(True) for _, leaf in paths(tp)]
    loss, stats = steps.loss_fn(tp, tcfg, to_port(batch), loss_chunk=CHUNK, **kw)
    grads = torch.autograd.grad(loss, leaves)
    return (float(loss.detach()), {k: v.detach().numpy() for k, v in stats.items()},
            {path: g.numpy() for (path, _), g in zip(paths(tp), grads)})


def assert_grads_match(tgrads, rgrads):
    for path, g in tgrads.items():
        assert np.isfinite(g).all(), path
        assert rel_l2(g, at_path(rgrads, path)) <= GRAD_RL2, path


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_loss_and_gradients_equal_the_reference(arch):
    rcfg, tcfg = configs(arch)
    params = ref_params(rcfg)
    batch = make_batch(rcfg)
    rloss, rstats, rgrads = ref_loss_and_grads(rcfg, params, batch)
    tloss, tstats, tgrads = port_loss_and_grads(tcfg, params, batch)
    assert tloss == pytest.approx(rloss, rel=LOSS_RTOL)
    assert float(tstats["ce"]) == pytest.approx(float(rstats["ce"]), rel=LOSS_RTOL)
    assert float(tstats["moe_aux"]) == pytest.approx(float(rstats["moe_aux"]), rel=LOSS_RTOL,
                                                     abs=1e-7)
    for k in ("moe_overflow", "moe_dropped", "moe_peak"):
        assert int(tstats[k]) == int(rstats[k]), k
    assert_grads_match(tgrads, rgrads)


@pytest.mark.parametrize("v_pad", [0, 3])
def test_chunked_ce_loss_equals_the_reference(v_pad):
    """A vocab-padded table's extra rows never win; masked labels count
    nothing; the value and the gradients wrt x and the table match."""
    rcfg, tcfg = configs("qwen3-0.6b")
    rng = np.random.default_rng(v_pad)
    V = rcfg.vocab_size + v_pad
    x = rng.standard_normal((B, S, rcfg.d_model)).astype(np.float32)
    table = (rng.standard_normal((V, rcfg.d_model)) * 0.3).astype(np.float32)
    labels = rng.integers(0, rcfg.vocab_size, (B, S)).astype(np.int32)
    labels[1, 5:] = -1
    ctx = ref_tf.ShardCtx()
    want, (gx, gt) = jax.value_and_grad(
        lambda x, t: ref_steps.chunked_ce_loss(x, {"table": t}, jnp.asarray(labels), rcfg, ctx,
                                               chunk=5), argnums=(0, 1))(jnp.asarray(x),
                                                                         jnp.asarray(table))
    tx, tt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(table).requires_grad_(True)
    got = steps.chunked_ce_loss(tx, {"table": tt}, torch.from_numpy(labels), tcfg, None, chunk=5)
    ggx, ggt = torch.autograd.grad(got, (tx, tt))
    assert float(got.detach()) == pytest.approx(float(want), rel=LOSS_RTOL)
    assert rel_l2(ggx.numpy(), gx) <= GRAD_RL2 and rel_l2(ggt.numpy(), gt) <= GRAD_RL2
    assert not ggt[rcfg.vocab_size:].any()


@pytest.fixture(scope="module")
def qwen_reference_steps():
    """The reference's train_step (remat on, its default) at 1 and 2 microbatches."""
    rcfg, _ = configs("qwen3-0.6b")
    params = ref_params(rcfg)
    batch = make_batch(rcfg, seed=1, batch=4)
    ocfg = ref_adamw.OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    opt = jax.tree.map(np.asarray, ref_adamw.init_opt_state(params, ocfg))
    out = {}
    for mb in (1, 2):
        step = jax.jit(functools.partial(ref_steps.train_step, cfg=rcfg, opt_cfg=ocfg,
                                         n_microbatch=mb, loss_chunk=CHUNK))
        new, new_opt, m = step(params, opt, to_ref(batch))
        out[mb] = (jax.tree.map(np.asarray, new), {k: np.asarray(v) for k, v in m.items()})
    return params, opt, batch, out


@pytest.fixture(scope="module")
def qwen_port_steps(qwen_reference_steps):
    params, opt, batch, _ = qwen_reference_steps
    _, tcfg = configs("qwen3-0.6b")
    ocfg = adamw.OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    out = {}
    for mb in (1, 2):
        for remat in (True, False):
            new, new_opt, m = steps.train_step(
                params_from_reference(params, "cpu"), opt_state_from_reference(opt, "cpu"),
                to_port(batch), cfg=tcfg, opt_cfg=ocfg, n_microbatch=mb, loss_chunk=CHUNK,
                remat=remat)
            out[mb, remat] = (new, new_opt, m)
    return out


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("remat", [True, False])
def test_train_step_equals_the_reference(mb, remat, qwen_reference_steps, qwen_port_steps):
    params, _, _, ref_out = qwen_reference_steps
    rnew, rm = ref_out[mb]
    tnew, topt, tm = qwen_port_steps[mb, remat]
    for k in ("grad_norm", "lr", "loss", "ce"):
        assert float(tm[k]) == pytest.approx(float(rm[k]), rel=METRIC_RTOL), k
    assert set(tm) == set(rm)
    for path, old in paths(params):
        upd = at_path(tnew, path).numpy().astype(np.float64) - old
        assert rel_l2(upd, at_path(rnew, path).astype(np.float64) - old) <= UPDATE_RL2, path
    assert int(topt["count"]) == 1


@pytest.mark.parametrize("mb", [1, 2])
def test_remat_does_not_change_the_result(mb, qwen_port_steps):
    on, off = qwen_port_steps[mb, True], qwen_port_steps[mb, False]
    for (path, a), (_, b) in zip(paths(on[0]), paths(off[0])):
        assert torch.equal(a, b), path
    assert all(torch.equal(on[2][k], off[2][k]) for k in on[2])


@pytest.mark.parametrize("policy", ["dots", "none"])
def test_remat_policies_give_the_same_gradients(policy):
    rcfg, tcfg = configs("granite-moe-3b-a800m", remat_policy=policy)
    params = ref_params(rcfg)
    batch = make_batch(rcfg)
    _, _, plain = port_loss_and_grads(tcfg, params, batch, remat=False)
    _, _, remat = port_loss_and_grads(tcfg, params, batch, remat=True)
    for path, g in plain.items():
        np.testing.assert_array_equal(remat[path], g, err_msg=str(path))


def test_moe_drop_and_peak_stats_equal_the_reference():
    """The single-device form of the reference's drop/peak test: a collapsed
    router at a starved capacity drops tokens and peaks above it (the
    gradients, through the spare drop slot and the router's gates, equal
    the reference's); a generous capacity drops nothing at the same peak;
    with two microbatches drops add up and the peak is the larger one."""
    rcfg, tcfg = configs("granite-moe-3b-a800m", capacity_factor=1.0)
    params = ref_params(rcfg, skew=6.0)
    batch = make_batch(rcfg, seed=2, batch=4)
    rloss, rstats, rgrads = ref_loss_and_grads(rcfg, params, batch, moe_capacity=2)
    tloss, tstats, tgrads = port_loss_and_grads(tcfg, params, batch, moe_capacity=2)
    assert int(tstats["moe_dropped"]) == int(rstats["moe_dropped"]) > 0
    assert int(tstats["moe_peak"]) == int(rstats["moe_peak"]) > 2
    assert bool(tstats["moe_overflow"]) and bool(rstats["moe_overflow"])
    assert tloss == pytest.approx(rloss, rel=LOSS_RTOL)
    assert_grads_match(tgrads, rgrads)
    router = ("blocks", "pos0", "moe", "router", "w")
    assert np.abs(tgrads[router]).max() > 0  # the gates carry a gradient

    generous = S * B * 2 * rcfg.top_k
    jparams = jax.tree.map(jnp.asarray, params)
    _, rfull = ref_steps.loss_fn(jparams, rcfg, to_ref(batch), loss_chunk=CHUNK,
                                 moe_capacity=generous)
    _, tfull = steps.loss_fn(params_from_reference(params, "cpu"), tcfg, to_port(batch),
                             loss_chunk=CHUNK, moe_capacity=generous)
    assert int(tfull["moe_dropped"]) == int(rfull["moe_dropped"]) == 0
    assert int(tfull["moe_peak"]) == int(rfull["moe_peak"]) == int(rstats["moe_peak"])

    halves = [ref_steps.loss_fn(jparams, rcfg, to_ref({k: v[i * 2:(i + 1) * 2]
                                                      for k, v in batch.items()}),
                                loss_chunk=CHUNK, moe_capacity=2)[1] for i in range(2)]
    ocfg = adamw.OptConfig(peak_lr=1e-4, warmup_steps=2, total_steps=4)
    tp = params_from_reference(params, "cpu")
    _, _, m = steps.train_step(tp, adamw.init_opt_state(tp, ocfg), to_port(batch), cfg=tcfg,
                               opt_cfg=ocfg, n_microbatch=2, loss_chunk=CHUNK, moe_capacity=2)
    assert int(m["moe_dropped"]) == sum(int(h["moe_dropped"]) for h in halves) > 0
    assert int(m["moe_peak"]) == max(int(h["moe_peak"]) for h in halves)
    assert bool(m["moe_overflow"]) == bool(halves[-1]["moe_overflow"])


@pytest.mark.parametrize("chunk,S_,dt_scale", [(8, 16, 1.0), (256, 256, 1.0)])
def test_ssd_gradients_stay_finite_where_the_reference_overflows(chunk, S_, dt_scale):
    """Above the diagonal the segment sums are positive, and over a chunk of
    strong decay exp() overflows there: the reference's ``where(causal,
    exp(seg), 0)`` backpropagates 0 * inf = NaN into dt.  The port masks
    before the exp: the same forward, finite gradients, and the gradients
    the reference does get right (x, B, C) equal."""
    cfg = ref_mamba.MambaConfig(d_model=32, d_state=8, head_dim=8, chunk=chunk)
    nh = cfg.n_heads
    rng = np.random.default_rng(chunk)
    x = rng.standard_normal((2, S_, nh, 8)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((2, S_, nh))) * dt_scale).astype(np.float32)
    B_ = rng.standard_normal((2, S_, 1, 8)).astype(np.float32)
    C_ = rng.standard_normal((2, S_, 1, 8)).astype(np.float32)
    A = -np.linspace(1.0, 16.0, nh).astype(np.float32)

    def ref_fn(*args):
        y, h = ref_mamba._ssd_chunked(cfg, *args, jnp.asarray(A))
        return y.sum() + h.sum(), y

    (_, ry), rg = jax.value_and_grad(ref_fn, argnums=(0, 1, 2, 3), has_aux=True)(
        *map(jnp.asarray, (x, dt, B_, C_)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, dt, B_, C_)]
    y, h = mamba2._ssd_chunked(mamba2.MambaConfig(*cfg), *ts, torch.from_numpy(A))
    tg = torch.autograd.grad(y.sum() + h.sum(), ts)
    assert not np.isfinite(np.asarray(rg[1])).all()  # the reference's dt gradient
    assert all(bool(torch.isfinite(g).all()) for g in tg)
    # forward within 1e-4 relative L2: a 256-long chunk sums 256 float32 terms
    assert rel_l2(y.detach().numpy(), ry) <= GRAD_RL2
    for i in (0, 2, 3):
        assert rel_l2(tg[i].numpy(), rg[i]) <= GRAD_RL2, i


@pytest.mark.parametrize("S_,kv_chunk,window", [(16, 4, 0), (16, 4, 5), (13, 4, 3)])
def test_flash_causal_gradients_with_fully_masked_chunks(S_, kv_chunk, window):
    """Rows that see no key of a chunk (the sliding window) keep finite
    gradients equal to the reference's."""
    cfg = ref_attn.AttnConfig(32, 4, 2, 8, kv_chunk=kv_chunk, sliding_window=window)
    rng = np.random.default_rng(S_ + window)
    q, k, v = (rng.standard_normal((2, S_, h, 8)).astype(np.float32) for h in (4, 2, 2))
    w = rng.standard_normal((2, S_, 4, 8)).astype(np.float32)
    rg = jax.grad(lambda *a: (ref_attn._flash_causal(*a, cfg) * w).sum(), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = attention._flash_causal(*ts, attention.AttnConfig(*cfg))
    tg = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    for got, want in zip(tg, rg):
        assert bool(torch.isfinite(got).all())
        assert rel_l2(got.numpy(), want) <= GRAD_RL2
