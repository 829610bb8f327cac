"""Shared plumbing of the mesh LM tests (``tests/test_torch_mesh_*.py``).

The reference's own mesh path runs on jax 0.9.0 when its mesh axes are
``AxisType.Auto`` (``jax.make_mesh``'s default, Explicit, makes its
sharding pins raise): each reference body builds its (data, model) meshes
that way and is the oracle for what only a mesh defines (each sender's
capacity, the per-sender peak, ``aux`` averaged over the senders).  The
reference's single-device results are the oracle for everything else.

``TRAIN_REF_BODY`` / ``TRAIN_PORT_BODY`` and ``run_train`` run the
training cases of ``test_torch_mesh_train*.py``: a case is (config,
(data, model), state dtype, compress_grads, what is held: ``"grads"``
and / or ``"step"``).

Configs: ``"m"`` is the reference mesh tests' model (2 layers, d_model 32,
4 experts top-2, vocabulary 64); ``"m-drop"`` the same at capacity factor
1.0 (tokens drop); ``"m-int8wire"`` with ``compress_dispatch``; an arch id
is its ``reduced()`` config (granite: 5 experts, padded to 6 on a model
axis of 2).  ``CONFIG_SRC`` defines ``config(name)`` in either package's
body; ``ref_params`` draws the reference's params for a model axis size,
and ``flat_params`` / ``tree_of`` carry them through an ``.npz``.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np

from repro.configs import base as ref_base
from repro.models import transformer as ref_tf

M_FIELDS = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=16,
                vocab_size=64, pattern=("attn",), ffn_pattern=("moe",), n_experts=4, top_k=2,
                capacity_factor=8.0, kv_chunk=8)

CONFIG_SRC = """
import dataclasses
M_FIELDS = {m_fields!r}
def config(name):
    if name.startswith("m"):
        extra = {{"m-drop": dict(capacity_factor=1.0),
                  "m-int8wire": dict(compress_dispatch=True)}}.get(name, {{}})
        return ModelConfig(name, **{{**M_FIELDS, **extra}}, param_dtype=F32, compute_dtype=F32)
    return reduced(ARCHS[name])
""".format(m_fields=M_FIELDS)

REF_IMPORTS = """
import math, functools
from jax.sharding import AxisType
import jax.numpy as jnp
from repro.configs.base import ARCHS, reduced
from repro.models.transformer import ModelConfig
F32 = jnp.float32
def amesh(shape):
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:math.prod(shape)])
def tree_of(prefix):
    out = {}
    for k, v in IN.items():
        if k.startswith(prefix):
            node = out
            *head, leaf = k[len(prefix):].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[leaf] = jnp.asarray(v)
    return out
def flat(tree, prefix):
    return {prefix + "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
""" + CONFIG_SRC

PORT_IMPORTS = """
import math
from repro_torch.configs.base import ARCHS, reduced
from repro_torch.models.transformer import ModelConfig, ShardCtx
from repro_torch.launch.mesh import Mesh
from repro_torch.tree import paths
F32 = torch.float32
def tree_of(prefix):
    out = {}
    for k, v in IN.items():
        if k.startswith(prefix):
            node = out
            *head, leaf = k[len(prefix):].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[leaf] = v
    return out
def flat(tree, prefix):
    return {prefix + "/".join(p): t.detach().cpu().numpy() for p, t in paths(tree)}
def rows(a, mesh):
    n = a.shape[0] // mesh.shape["data"]
    return a[mesh.coords["data"] * n:(mesh.coords["data"] + 1) * n]
""" + CONFIG_SRC


def ref_config(name: str):
    """The reference's config for ``name`` (as ``CONFIG_SRC`` builds it)."""
    import jax.numpy as jnp

    if name.startswith("m"):
        extra = {"m-drop": dict(capacity_factor=1.0),
                 "m-int8wire": dict(compress_dispatch=True)}.get(name, {})
        return ref_tf.ModelConfig(name, **{**M_FIELDS, **extra}, param_dtype=jnp.float32,
                                  compute_dtype=jnp.float32)
    return ref_base.reduced(ref_base.ARCHS[name])


def ref_params(name: str, ep_shards: int) -> dict:
    """The reference's params of config ``name`` for a model axis of
    ``ep_shards`` (vocabulary and experts padded to its multiple)."""
    return jax.tree.map(np.asarray, ref_tf.model_init(jax.random.PRNGKey(0), ref_config(name),
                                                      ep_shards=ep_shards))


def flat_params(tree, prefix: str) -> dict:
    """``{prefix + "a/b/c": array}`` for every leaf of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_params(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# ------------------------------------------------------------ train cases ---
B, S, CHUNK = 4, 16, 8
CONVERGE_STEPS = 25
DRIVER = ["--arch", "granite-moe-3b-a800m", "--reduced", "--steps", "4", "--batch", "4",
          "--seq", "16", "--lr", "5e-3", "--log-every", "100", "--device", "cpu"]

TRAIN_REF_BODY = """
from repro.models.transformer import ShardCtx
from repro.optim.adamw import OptConfig, init_opt_state
from repro.train.steps import loss_fn, train_step
CASES, SINGLE = {cases!r}, {single!r}
for case, (name, shape, state_dtype, compress, held) in CASES.items():
    if held == "params":
        continue
    cfg = config(name)
    params = tree_of(f"{{case}}/p/")
    toks = IN[f"{{case}}/tokens"]
    batch = {{"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}}
    ocfg = OptConfig(peak_lr=5e-3, warmup_steps=2, total_steps=20, state_dtype=state_dtype,
                     compress_grads=compress)
    opt = init_opt_state(params, ocfg)
    ctx = ShardCtx(mesh=amesh(shape), axes=("data", "model"))
    lossgrad = functools.partial(jax.value_and_grad(loss_fn, has_aux=True), cfg=cfg, ctx=ctx,
                                 loss_chunk={chunk}, remat=False)
    step = functools.partial(train_step, cfg=cfg, opt_cfg=ocfg, ctx=ctx, loss_chunk={chunk},
                             remat=False)
    if held == "grads":
        (loss, _), g = jax.jit(lambda p: lossgrad(p, batch=batch))(params)
    elif held == "step":
        new, _, m = jax.jit(step)(params, opt, batch)
    else:  # one executable for both
        ((loss, _), g), (new, _, m) = jax.jit(
            lambda p, o: (lossgrad(p, batch=batch), step(p, o, batch)))(params, opt)
    if "grads" in held:
        out.update(flat(g, f"{{case}}/grad/"))
        out[f"{{case}}/loss"] = np.asarray(loss)
    if "step" in held:
        out.update(flat(new, f"{{case}}/new/"))
        out.update({{f"{{case}}/m/{{k}}": np.asarray(v) for k, v in m.items()}})
    if case in SINGLE:
        new, _, m = jax.jit(functools.partial(train_step, cfg=cfg, opt_cfg=ocfg,
                                              loss_chunk={chunk}, remat=False))(params, opt, batch)
        out.update(flat(new, f"{{case}}/single_new/"))
        out.update({{f"{{case}}/single_m/{{k}}": np.asarray(v) for k, v in m.items()}})
"""

TRAIN_PORT_BODY = """
import io, contextlib
from repro_torch.carry import shard_from_reference
from repro_torch.distributed.sharding import (fit_tree, opt_state_specs, param_specs, shard_tree,
                                              unshard_tree)
from repro_torch.optim.adamw import OptConfig, init_opt_state
from repro_torch.train.steps import loss_fn, train_step
from repro_torch.tree import from_paths
CASES = {cases!r}
def step_inputs(case, mesh):
    full = tree_of(f"{{case}}/p/")
    specs = fit_tree(param_specs(full), full, mesh)
    toks = rows(torch.from_numpy(IN[f"{{case}}/tokens"]), mesh)
    return full, specs, shard_from_reference(full, specs, mesh, "cpu"), \\
        {{"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}}
for case, (name, shape, state_dtype, compress, held) in CASES.items():
    if math.prod(shape) != WORLD or held == "params":
        continue
    cfg = config(name)
    mesh = Mesh(shape, ("data", "model"))
    ctx = ShardCtx(mesh=mesh, axes=mesh.axis_names)
    full, specs, params, batch = step_inputs(case, mesh)
    ocfg = OptConfig(peak_lr=5e-3, warmup_steps=2, total_steps=20, state_dtype=state_dtype,
                     compress_grads=compress)
    opt = init_opt_state(params, ocfg)
    ospecs = opt_state_specs(opt, specs)
    if "grads" in held:
        pairs = list(paths(params))
        leaves = [t.detach().requires_grad_(True) for _, t in pairs]
        loss, _ = loss_fn(from_paths((p, t) for (p, _), t in zip(pairs, leaves)), cfg, batch,
                          ctx=ctx, loss_chunk={chunk}, specs=specs)
        grads = from_paths((p, g) for (p, _), g in zip(pairs, torch.autograd.grad(loss, leaves)))
        grads = unshard_tree(grads, specs, mesh)
        if RANK == 0:
            out.update(flat(grads, f"{{case}}/grad/"))
        out[f"{{case}}/loss"] = loss.detach().numpy()
    if "step" not in held:
        continue
    new, new_opt, m = train_step(params, opt, batch, cfg=cfg, opt_cfg=ocfg, ctx=ctx,
                                 loss_chunk={chunk}, specs=specs)
    whole = unshard_tree(new, specs, mesh)
    if RANK == 0:
        out.update(flat(whole, f"{{case}}/new/"))
    out.update({{f"{{case}}/m/{{k}}": np.asarray(v) for k, v in m.items()}})
    blocks = [t for tree in (new, new_opt["m"], new_opt["v"]) for _, t in paths(tree)]
    out[f"{{case}}/bytes"] = np.array(sum(t.numel() * t.element_size() for t in blocks))
    mine = {{"m": new_opt["m"], "v": new_opt["v"]}}
    whole_opt = unshard_tree(mine, {{"m": ospecs["m"], "v": ospecs["v"]}}, mesh)
    out[f"{{case}}/whole_bytes"] = np.array(sum(
        t.numel() * t.element_size() for tree in (whole, whole_opt["m"], whole_opt["v"])
        for _, t in paths(tree)))

if WORLD == 4 and EXTRAS:
    # convergence: the reference mesh test's batches, 25 steps on 2x2
    cfg = config("m")
    mesh = Mesh((2, 2), ("data", "model"))
    ctx = ShardCtx(mesh=mesh, axes=mesh.axis_names)
    full, specs, params, _ = step_inputs("m-2x2", mesh)
    ocfg = OptConfig(peak_lr=5e-3, warmup_steps=3, total_steps=40)
    opt = init_opt_state(params, ocfg)
    rng = np.random.default_rng(0)
    losses = []
    for i in range({steps}):
        t = rows(torch.from_numpy((rng.integers(0, 32, size=(8, 17)) * 2).astype(np.int32) % 64),
                 mesh)
        batch = {{"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}}
        params, opt, m = train_step(params, opt, batch, cfg=cfg, opt_cfg=ocfg, ctx=ctx,
                                    loss_chunk=16, specs=specs)
        losses.append(float(m["loss"]))
    out["converge/losses"] = np.array(losses)

    # the driver on the mesh, from the params the one-device driver gets
    from repro_torch.carry import params_from_reference
    from repro_torch.launch import train
    driver_params = tree_of("granite-2x2/p/")
    train.model_init = lambda gen, cfg, ep_shards, device: params_from_reference(driver_params,
                                                                                 device)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["driver/losses"] = np.array(train.main({driver!r} + ["--mesh", "data=2,model=2",
                                                   "--plans", IN_DIR + "/plans.json"]))
    out["driver/log"] = np.array(buf.getvalue())
"""



def train_inputs(cases: dict) -> dict:
    """Params per (config, model axis) and tokens per config."""
    arrays, drawn, tokens = {}, {}, {}
    rng = np.random.default_rng(0)
    for case, (name, shape, *_) in cases.items():
        key = (name, shape[1])
        if key not in drawn:
            drawn[key] = flat_params(ref_params(name, shape[1]), "")
        if name not in tokens:
            tokens[name] = rng.integers(0, 64, (B, S + 1)).astype(np.int32)
        arrays.update({f"{case}/p/{k}": v for k, v in drawn[key].items()})
        arrays[f"{case}/tokens"] = tokens[name]
    return arrays


def run_train(wd, cases: dict, single: tuple, worlds, extras: bool):
    """Both sides of the training cases (and, with ``extras``, the 25-step
    convergence run and the mesh driver on 4 ranks), all at once:
    ``(reference dict, {world: [rank dicts]}, workdir)``."""
    from _torch_ranks import run_port, run_reference, save_inputs

    save_inputs(wd, train_inputs(cases))
    fmt = dict(cases=cases, single=single, chunk=CHUNK, steps=CONVERGE_STEPS, driver=DRIVER)
    port_body = (PORT_IMPORTS + f"IN_DIR = {str(wd)!r}\nEXTRAS = {extras!r}\n"
                 + TRAIN_PORT_BODY.format(**fmt))
    with ThreadPoolExecutor(max_workers=1 + len(worlds)) as pool:
        ref = pool.submit(run_reference, REF_IMPORTS + TRAIN_REF_BODY.format(**fmt), 4, wd)
        ports = {w: pool.submit(run_port, port_body, w, wd, 480) for w in worlds}
        return ref.result(), {w: f.result() for w, f in ports.items()}, wd


# ----------------------------------------------------------- train checks ---
LOSS_RTOL = 1e-5
GRAD_RL2 = 1e-4
UPDATE_RL2 = 1e-3
METRIC_RTOL = 1e-5


def ranks_of(runs, cases, case) -> list:
    return runs[1][int(np.prod(cases[case][1]))]


def leaves(d: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def case_params(runs, case) -> dict:
    with np.load(runs[2] / "inputs.npz") as z:
        return {k[len(f"{case}/p/"):]: z[k] for k in z.files if k.startswith(f"{case}/p/")}


def case_tree(runs, case) -> dict:
    """The case's params as a nested dict of arrays."""
    tree = {}
    for k, v in case_params(runs, case).items():
        node = tree
        *head, leaf = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = v
    return tree


def check_grads(runs, cases, case) -> None:
    """Loss within 1e-5 relative on every rank, gradients per leaf within
    1e-4 relative L2, against the reference's mesh."""
    ref, ranks = runs[0], ranks_of(runs, cases, case)
    for r in ranks:
        np.testing.assert_allclose(r[f"{case}/loss"], ref[f"{case}/loss"], rtol=LOSS_RTOL)
    want, got = leaves(ref, f"{case}/grad/"), leaves(ranks[0], f"{case}/grad/")
    assert set(got) == set(want) == set(case_params(runs, case))
    for k, g in want.items():
        assert rel_l2(got[k], g) <= GRAD_RL2, k


def check_step(runs, cases, case, prefix: str = "") -> None:
    """One train_step against the reference's mesh (``prefix="single_"``:
    its one device): every rank's metrics equal; loss and CE within 1e-5,
    ``grad_norm`` / ``lr`` / ``aux`` within 1e-5 relative, MoE counts
    equal, the update per leaf within 1e-3 relative L2."""
    ref, ranks = runs[0], ranks_of(runs, cases, case)
    for r in ranks:
        for k, v in leaves(r, f"{case}/m/").items():
            np.testing.assert_array_equal(v, ranks[0][f"{case}/m/{k}"], err_msg=k)
    want, got = leaves(ref, f"{case}/{prefix}m/"), leaves(ranks[0], f"{case}/m/")
    assert set(got) == set(want)
    for k in ("loss", "ce", "grad_norm", "lr", "moe_aux"):
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)
    if not prefix:  # one device has one sender: its drops and peak are not a mesh's
        for k in ("moe_dropped", "moe_peak", "moe_overflow"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    params = case_params(runs, case)
    want_new, got_new = leaves(ref, f"{case}/{prefix}new/"), leaves(ranks[0], f"{case}/new/")
    assert set(want_new) == set(got_new) == set(params)
    for k, p in params.items():
        assert rel_l2(got_new[k] - p, want_new[k] - p) <= UPDATE_RL2, k


def replicated_bytes(tree: dict, shape, *, int8: bool) -> int:
    """A rank's bytes of the params and the two moments (float32, or int8
    with a float32 scale a row) on a (data, model) mesh of ``shape``: each
    leaf's whole bytes times the share its fitted spec leaves a rank (a
    row scale follows its spec without the last axis)."""
    from repro_torch.distributed.sharding import fit_tree, param_specs, replication
    from repro_torch.tree import at_path, paths

    mesh = type("M", (), {"axis_names": ("data", "model"),
                          "shape": {"data": shape[0], "model": shape[1]}})()
    specs = fit_tree(param_specs(tree), tree, mesh)
    world = shape[0] * shape[1]
    total = 0
    for path, p in paths(tree):
        spec = at_path(specs, path)
        if int8:  # q like the param, a row scale replicated where the rows are split
            scales = 2 * (p.size // p.shape[-1]) * 4 * replication(spec[:-1], mesh) // world
            total += (p.size * p.itemsize + 2 * p.size) * replication(spec, mesh) // world + scales
        else:
            total += (p.size * p.itemsize + 2 * p.size * 4) * replication(spec, mesh) // world
    return total
