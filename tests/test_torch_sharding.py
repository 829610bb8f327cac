"""The port's layout rules (``repro_torch.distributed.sharding``) against
the reference's (``repro/distributed/sharding.py``), leaf by leaf.

* ``param_specs`` for all ten architectures: at full size (the port's
  params as ``meta`` tensors, the reference's as ``jax.eval_shape``
  stand-ins, 16 expert shards) and reduced (real tensors, 2 shards);
* ``opt_state_specs`` for float32 and int8 moments, with and without the
  ``compress_grads`` buffer; ``cache_specs`` of every reduced
  architecture's cache and of every full-size decode cell's
  (``configs.base.cache_specs``, ``meta`` tensors); ``batch_specs``;
* ``fit_spec``: ``tests/test_sharding_specs.py``'s cases and seeded random
  shapes and specs, equal to the reference's;
* ``configs.base.input_specs`` / ``cache_specs``: the shapes and dtypes of
  the reference's ``ShapeDtypeStruct`` stand-ins for every cell.

A spec is a tuple of entries here and a ``PartitionSpec`` there; both
compare as tuples, and the port's Mamba-2 layout (``with_mamba_layout``)
is the only difference allowed.  ``shard_tree`` -> ``unshard_tree`` round trips on real
ranks are in ``test_torch_mesh_model.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import base as ref_base
from repro.distributed import sharding as ref_sh
from repro.models import transformer as ref_tf
from repro.optim import adamw as ref_adamw
from repro_torch.configs import base
from repro_torch.distributed import sharding
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.tree import paths

ARCH_IDS = sorted(ref_base.ARCHS)


def ref_flat(specs) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k)))) for k in kp):
            tuple(s) for kp, s in flat}


def port_flat(specs) -> dict:
    """Spec trees may hold namedtuples (caches): walk them by field.  A
    ``SegmentedAxis`` entry is rendered with its segments, so it never
    compares equal to the reference's plain axis name."""
    out = {}

    def entry(e):
        if isinstance(e, sharding.SegmentedAxis):
            return ("segmented", str(e), e.sizes, e.whole)
        return e

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (str(k),))
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for f, v in zip(t._fields, t):
                walk(v, path + (f,))
        else:
            out[path] = tuple(entry(e) for e in t)

    walk(specs, ())
    return out


def with_mamba_layout(flat: dict, cfg) -> dict:
    """The reference's specs ``flat`` with the port's deliberate deviations
    on Mamba-2 leaves (ROADMAP Queue 3), and no others: ``in_proj``'s
    columns ``(z, x, B, C, dt)`` and the conv's channels ``(x, B, C)``
    (params and their optimizer state) split segment by segment over
    "model"; the decode cache's conv window holds its ``x`` channels split
    and ``B`` / ``C`` whole, and its SSM state splits heads as one
    segment."""
    mc = cfg.mamba_cfg()
    di, gs, nh = mc.d_inner, mc.n_groups * mc.d_state, mc.n_heads

    def segments(path):
        if path[0].startswith("pos"):  # a decode cache (posN, field)
            if cfg.pattern[int(path[0][3:])].startswith("attn"):
                return None
            return ((di, gs, gs), (1, 2)) if path[-1] == "conv" else ((nh,), ())
        if "mamba" in path and "in_proj" in path:
            return (di, di, gs, gs, nh), ()
        if "mamba" in path and ("conv_w" in path or "conv_b" in path):
            return (di, gs, gs), ()
        return None

    out = {}
    for path, spec in flat.items():
        seg = segments(path)
        out[path] = spec if seg is None else tuple(
            ("segmented", "model") + seg if e == "model" else e for e in spec)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_at_full_size_equal_the_reference(arch):
    shapes = jax.eval_shape(lambda k: ref_tf.model_init(k, ref_base.ARCHS[arch], ep_shards=16),
                            jax.random.PRNGKey(0))
    meta = transformer.model_init(torch.Generator(), base.ARCHS[arch], ep_shards=16, device="meta")
    want, got = ref_flat(ref_sh.param_specs(shapes)), port_flat(sharding.param_specs(meta))
    assert got == with_mamba_layout(want, base.ARCHS[arch])
    assert {p: tuple(t.shape) for p, t in paths(meta)} == {
        tuple(str(k.key) for k in kp): tuple(l.shape)
        for kp, l in jax.tree_util.tree_flatten_with_path(shapes)[0]}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_param_opt_and_cache_specs_equal_the_reference(arch):
    rcfg, tcfg = ref_base.reduced(ref_base.ARCHS[arch]), base.reduced(base.ARCHS[arch])
    rparams = ref_tf.model_init(jax.random.PRNGKey(0), rcfg, ep_shards=2)
    tparams = transformer.model_init(torch.Generator().manual_seed(0), tcfg, ep_shards=2,
                                     device="cpu")
    rspecs, tspecs = ref_sh.param_specs(rparams), sharding.param_specs(tparams)
    assert port_flat(tspecs) == with_mamba_layout(ref_flat(rspecs), tcfg)
    for state_dtype in ("f32", "int8"):
        for compress in (False, True):
            rocfg = ref_adamw.OptConfig(state_dtype=state_dtype, compress_grads=compress)
            tocfg = adamw.OptConfig(state_dtype=state_dtype, compress_grads=compress)
            want = ref_sh.opt_state_specs(ref_adamw.init_opt_state(rparams, rocfg), rspecs)
            got = sharding.opt_state_specs(adamw.init_opt_state(tparams, tocfg), tspecs)
            assert port_flat(got) == with_mamba_layout(ref_flat(want), tcfg), (state_dtype, compress)
    rcache = ref_tf.init_cache(rcfg, 4, 16)
    tcache = transformer.init_cache(tcfg, 4, 16, device="cpu")
    assert port_flat(sharding.cache_specs(tcache, tcfg)) == with_mamba_layout(
        ref_flat(ref_sh.cache_specs(rcache, rcfg)), tcfg)
    batch = {"tokens": np.zeros((4, 16), np.int32), "frontend_embeds": np.zeros((4, 2, 8))}
    assert port_flat(sharding.batch_specs(batch)) == ref_flat(ref_sh.batch_specs(batch))


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s in ref_base.all_cells()])
def test_input_and_cache_specs_of_every_cell_equal_the_reference(arch, shape):
    want = ref_base.input_specs(ref_base.ARCHS[arch], shape)
    got = base.input_specs(base.ARCHS[arch], shape)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == want[k].shape
        assert str(v.dtype).removeprefix("torch.") == jnp.dtype(want[k].dtype).name
    if ref_base.SHAPES[shape][2] != "decode":
        with pytest.raises(ValueError, match="decode"):
            base.cache_specs(base.ARCHS[arch], shape)
        return
    rcache = ref_base.cache_specs(ref_base.ARCHS[arch], shape)
    tcache = base.cache_specs(base.ARCHS[arch], shape)
    want_shapes = {tuple(str(getattr(k, "key", getattr(k, "name", k))) for k in kp): l.shape
                   for kp, l in jax.tree_util.tree_flatten_with_path(rcache)[0]}
    got_shapes = {}
    for name, c in tcache.items():
        for f, t in zip(c._fields, c):
            assert t.device.type == "meta"
            got_shapes[(name, f)] = tuple(t.shape)
    assert got_shapes == want_shapes
    cfg = base.ARCHS[arch]
    assert port_flat(sharding.cache_specs(tcache, cfg)) == with_mamba_layout(
        ref_flat(ref_sh.cache_specs(rcache, ref_base.ARCHS[arch])), cfg)


class _Mesh:
    axis_names = ("pod", "data")
    shape = {"pod": 2, "data": 16}


@pytest.mark.parametrize("shape,spec,want", [
    ((1, 5), (("pod", "data"), None), (None, None)),
    ((32, 5), (("pod", "data"), None), (("pod", "data"), None)),
    ((2, 5), (("pod", "data"), None), ("pod", None)),
    ((16, 5), ("data", "pod"), ("data", None)),
])
def test_fit_spec_cases_of_the_reference_tests(shape, spec, want):
    assert sharding.fit_spec(shape, spec, _Mesh()) == want
    assert tuple(ref_sh.fit_spec(shape, P(*spec), _Mesh())) == want


def test_fit_spec_equals_the_reference_on_random_specs():
    rng = np.random.default_rng(0)
    class M:
        axis_names = ("pod", "data", "model")
        shape = {"pod": 2, "data": 4, "model": 3}

    entries = [None, "pod", "data", "model", "other", ("pod", "data"), ("data", "model"),
               ("pod", "model", "data")]
    for _ in range(300):
        nd = int(rng.integers(1, 4))
        shape = tuple(int(rng.choice([1, 2, 3, 4, 6, 8, 12, 24, 48])) for _ in range(nd))
        spec = tuple(entries[int(rng.integers(len(entries)))] for _ in range(nd))
        assert sharding.fit_spec(shape, spec, M()) == tuple(ref_sh.fit_spec(shape, P(*spec), M()))
