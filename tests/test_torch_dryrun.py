"""The production-mesh dry-run (``repro_torch.launch.dryrun``) on fake CPU
tensors.

* The collective counter against the dry-run: a real (data=1, model=2)
  run on two gloo ranks counts the collectives of a train step (reduced
  qwen3; reduced granite, whose MoE adds all_to_alls; reduced mamba2, its
  SSM heads split over "model"), a prefill and a split-K decode step
  (reduced gemma3) and a decode step of reduced jamba (Mamba-2 and
  attention) through ``CollectiveCounter``; the same steps traced as each
  rank of a fake world of two give the same kinds, counts and bytes,
  exactly.
* Mamba-2 over "model": reduced jamba's cell on a fake (data=1, model=4)
  world carries no note, and a rank's Mamba params hold 1/4 of one
  device's bytes plus the rest of the ``B`` / ``C`` columns and channels,
  its SSM state exactly 1/4; 6 SSM heads on 4 ranks run whole, with the
  note that says so.
* Argument bytes: for every architecture's ``train_4k`` cell on the pod
  mesh, a rank's fake arguments (params, AdamW state, batch) hold exactly
  the bytes the reference's ``param_specs`` / ``opt_state_specs`` /
  ``batch_specs`` and ``fit_spec`` give a device: spec arithmetic on
  ``jax.eval_shape`` stand-ins, no XLA compile.
* Real cells: qwen3-0.6b ``train_4k`` and ``decode_32k`` on the pod mesh
  give records with every key of the reference's; the decode cell's
  attention cache on a rank is 1/16 of the bytes of the batch-split
  layout that keeps every position on each rank of a model group.
* The command line prints the reference's ``OK`` line and defaults to
  fake CUDA tensors.
"""
import json
import math

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ARCHS, SHAPES, input_specs, reduced
from repro_torch.launch import dryrun

REF_KEYS = {"arch", "shape", "mesh", "n_devices", "lower_s", "compile_s", "memory", "cost",
            "collectives"}
MEMORY_KEYS = {"argument_bytes_per_device", "output_bytes_per_device", "temp_bytes_per_device",
               "peak_bytes_per_device"}
# (case, arch, kind): the steps counted for real and traced
COUNTED = [("qwen3-train", "qwen3-0.6b", "train"),
           ("granite-train", "granite-moe-3b-a800m", "train"),
           ("gemma3-prefill", "gemma3-12b", "prefill"),
           ("gemma3-decode", "gemma3-12b", "decode"),
           ("mamba2-train", "mamba2-1.3b", "train"),
           ("jamba-decode", "jamba-1.5-large-398b", "decode")]
B, S, MICRO, CHUNK = 4, 16, 2, 8


def _inputs_meta(cfg, kind):
    def tok(*dims):
        return torch.empty(dims, dtype=torch.int32, device="meta")

    if kind == "train":
        return {"tokens": tok(B, S), "labels": tok(B, S)}
    return {"tokens": tok(B, S if kind == "prefill" else 1)}


PORT_BODY = """
import json
from repro_torch.configs.base import ARCHS, reduced
from repro_torch.distributed.sharding import compute_specs, fit_tree, param_specs, shard_tree
from repro_torch.exchange.group import CollectiveCounter
from repro_torch.launch.mesh import Mesh
from repro_torch.models.transformer import ShardCtx, init_cache, model_init
from repro_torch.optim.adamw import OptConfig, init_opt_state
from repro_torch.train.steps import prefill_step, serve_decode_step, train_step
mesh = Mesh((1, 2), ("data", "model"))
ctx = ShardCtx(mesh=mesh, axes=mesh.axis_names)
for case, arch, kind in {counted!r}:
    cfg = reduced(ARCHS[arch])
    full = model_init(torch.Generator().manual_seed(0), cfg, ep_shards=2, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, ({b}, {s}), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    with CollectiveCounter() as coll:
        if kind == "train":
            specs = fit_tree(param_specs(full), full, mesh)
            params = shard_tree(full, specs, mesh)
            train_step(params, init_opt_state(params, OptConfig()),
                       {{"tokens": toks, "labels": toks}}, cfg=cfg, opt_cfg=OptConfig(), ctx=ctx,
                       n_microbatch={micro}, loss_chunk={chunk}, remat=True, specs=specs)
        else:
            params = shard_tree(full, compute_specs(param_specs(full), cfg, 2), mesh)
            with torch.no_grad():
                if kind == "prefill":
                    prefill_step(params, cfg, toks, ctx=ctx)
                else:
                    serve_decode_step(params, cfg, toks[:, :1], init_cache(cfg, {b}, {s}, "cpu",
                                                                           ctx=ctx), ctx=ctx)
    out[case] = np.array(json.dumps(coll.record()))
"""


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    from _torch_ranks import run_port, save_inputs

    wd = tmp_path_factory.mktemp("dryrun_counted")
    save_inputs(wd, {"unused": np.zeros(1)})
    body = PORT_BODY.format(counted=COUNTED, b=B, s=S, micro=MICRO, chunk=CHUNK)
    return [{k: json.loads(str(v)) for k, v in r.items()} for r in run_port(body, 2, wd, 600)]


@pytest.mark.parametrize("case,arch,kind", COUNTED)
def test_collective_counter_equals_the_dry_run(counted, case, arch, kind):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim.adamw import OptConfig

    cfg = reduced(ARCHS[arch])
    for rank in range(2):
        with dryrun.fake_world(2, rank):
            mesh = Mesh((1, 2), ("data", "model"))
            mode = FakeTensorMode()
            fn, args, _ = dryrun.build_cell(cfg, kind, _inputs_meta(cfg, kind), mesh,
                                            torch.device("cpu"), mode, cache_len=S,
                                            n_microbatch=MICRO, loss_chunk=CHUNK,
                                            opt_cfg=OptConfig())
            rec = dryrun.trace(fn, args, mode)
        real = counted[rank][case]
        assert rec["collectives"] == real
        assert real["total_bytes"] > 0


class _RefMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


def _reference_argument_bytes(arch: str) -> int:
    """Bytes a device holds of the reference's train_4k arguments, from its
    specs fitted to the pod mesh."""
    from functools import partial

    import jax

    from repro.configs import base as ref_base
    from repro.distributed import sharding as ref_sh
    from repro.models import transformer as ref_tf
    from repro.optim import adamw as ref_adamw

    cfg = ref_base.ARCHS[arch]
    p = jax.eval_shape(partial(ref_tf.model_init, cfg=cfg, ep_shards=16), jax.random.PRNGKey(0))
    pspecs = ref_sh.param_specs(p)
    ocfg = ref_adamw.OptConfig(state_dtype="int8" if cfg.param_count() > 3e10 else "f32")
    o = jax.eval_shape(partial(ref_adamw.init_opt_state, cfg=ocfg), p)
    b = ref_base.input_specs(cfg, "train_4k")
    total = 0
    for tree, specs in ((p, pspecs), (o, ref_sh.opt_state_specs(o, pspecs)),
                        (b, ref_sh.batch_specs(b))):
        leaves = jax.tree.leaves(tree)
        spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert len(leaves) == len(spec_leaves)
        for leaf, spec in zip(leaves, spec_leaves):
            fitted = ref_sh.fit_spec(leaf.shape, spec, _RefMesh())
            split = math.prod(_RefMesh.shape[a] for e in fitted if e is not None
                              for a in (e if isinstance(e, tuple) else (e,)))
            total += math.prod(leaf.shape) * leaf.dtype.itemsize // split
    return total


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_argument_bytes_equal_the_reference_specs(arch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import make_production_mesh

    cfg = ARCHS[arch]
    with dryrun.fake_world(256):
        mesh = make_production_mesh()
        mode = FakeTensorMode()
        _, args, _ = dryrun.build_cell(cfg, "train", input_specs(cfg, "train_4k"), mesh,
                                       torch.device("cpu"), mode)
        got = dryrun.storage_bytes(args)
    assert got == _reference_argument_bytes(arch)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_cells")
    return out, {shape: dryrun.run_cell("qwen3-0.6b", shape, "pod", str(out), "cpu")
                 for shape in ("train_4k", "decode_32k")}


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_real_cells_give_records_with_the_reference_keys(cells, shape):
    out, recs = cells
    rec = recs[shape]
    with open(out / f"qwen3-0.6b__{shape}__pod.json") as f:
        assert json.load(f) == json.loads(json.dumps(rec))
    assert REF_KEYS <= set(rec) and rec["n_devices"] == 256 and rec["compile_s"] == 0
    mem = rec["memory"]
    assert set(mem) == MEMORY_KEYS
    assert mem["peak_bytes_per_device"] == (mem["argument_bytes_per_device"]
                                            + mem["output_bytes_per_device"]
                                            + mem["temp_bytes_per_device"])
    assert min(mem.values()) > 0 and rec["cost"]["flops"] > 0
    coll = rec["collectives"]
    assert set(coll) == {"bytes", "counts", "total_bytes"}
    assert coll["total_bytes"] == sum(coll["bytes"].values()) > 0


def test_the_decode_cells_cache_is_split_over_model():
    """A rank's attention cache holds 1/16 of the bytes it would hold with
    every position on each rank of a model group (rows over "data" alone)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs.base import cache_specs
    from repro_torch.launch.mesh import make_production_mesh

    cfg = ARCHS["qwen3-0.6b"]
    whole = cache_specs(cfg, "decode_32k")
    with dryrun.fake_world(256):
        mesh = make_production_mesh()
        mode = FakeTensorMode()
        _, (_, _, cache), _ = dryrun.build_cell(cfg, "decode", input_specs(cfg, "decode_32k"), mesh,
                                                torch.device("cpu"), mode,
                                                cache_len=SHAPES["decode_32k"][0])
        rank = sum(c.k.nbytes + c.v.nbytes for c in cache.values())
    batch_split = sum(c.k.nbytes + c.v.nbytes for c in whole.values()) // 16
    assert rank * 16 == batch_split
    seq = SHAPES["decode_32k"][0]
    assert {c.k.shape[2] for c in cache.values()} == {seq // 16}


def _mamba_cell(cfg, kind):
    """``build_cell``'s ``(args, notes)`` of ``cfg`` as rank 0 of a fake
    (data=1, model=4) world, on fake CPU tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import Mesh

    with dryrun.fake_world(4):
        mesh = Mesh((1, 4), ("data", "model"))
        _, args, notes = dryrun.build_cell(cfg, kind, _inputs_meta(cfg, kind), mesh,
                                           torch.device("cpu"), FakeTensorMode(), cache_len=S)
    return args, notes


def test_a_rank_of_a_reduced_jamba_cell_holds_its_share_of_mamba():
    from repro_torch.tree import paths

    cfg = reduced(ARCHS["jamba-1.5-large-398b"])
    mc = cfg.mamba_cfg()
    (params, _, cache), notes = _mamba_cell(cfg, "decode")
    assert notes == []
    mine = sum(t.nbytes for p, t in paths(params) if "mamba" in p)
    layers, gs, D, k = cfg.pattern.count("mamba"), mc.n_groups * mc.d_state, cfg.d_model, mc.conv_kernel
    whole = 4 * layers * (D * (2 * mc.d_inner + 2 * gs + mc.n_heads) + (k + 1) * mc.conv_dim
                          + mc.d_inner * D + 3 * mc.n_heads + mc.d_inner)
    bc = 4 * layers * (D + k + 1) * 2 * gs
    assert mine * 4 == whole - bc + 4 * bc
    assert mine < 0.32 * whole
    ssm = sum(c.ssm.nbytes for c in cache.values() if hasattr(c, "ssm"))
    assert ssm * 4 == 4 * layers * B * mc.n_heads * mc.d_state * mc.head_dim


def test_ssm_heads_that_do_not_divide_model_run_whole_with_a_note():
    import dataclasses

    cfg = dataclasses.replace(reduced(ARCHS["mamba2-1.3b"]), d_model=48)  # 6 heads
    (params, _), notes = _mamba_cell(cfg, "prefill")
    assert notes == ["6 SSM heads do not divide model=4: every rank runs every head"]
    assert params["blocks"]["pos0"]["mamba"]["A_log"].shape[-1] == 6


def test_the_command_line_prints_ok_and_defaults_to_the_card(tmp_path, capsys):
    assert dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--device", "cpu",
                        "--out", str(tmp_path)]) == 0
    assert capsys.readouterr().out.startswith("OK   qwen3-0.6b")
    assert (tmp_path / "qwen3-0.6b__decode_32k__pod.json").exists()
    assert dryrun.parser().parse_args(["--all"]).device == "cuda"
