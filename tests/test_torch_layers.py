"""``repro_torch.models.layers`` against ``repro.models.layers``.

The same seeded numpy inputs and parameters go through both.  Tolerances:
float32 atol = rtol = 1e-5; bfloat16 atol = rtol = 2**-5 (eight units in
the last place of bf16 at 1.0: the libraries round bf16 intermediates at
different points, XLA after each elementwise op and torch once a fused op,
and sum products in different orders, so an MLP's two rounded
intermediates reach its output through a 48-term product).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref
from repro_torch.carry import params_from_reference, tensor_to_reference
from repro_torch.models import layers

from _torch_parity import DTYPES

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2 ** -5, rtol=2 ** -5)}
KINDS = ("float32", "bfloat16")


def arr(shape, dtype, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(DTYPES[dtype])


def close(port, want, dtype):
    np.testing.assert_allclose(np.asarray(tensor_to_reference(port), np.float32),
                               np.asarray(want, np.float32), **TOL[dtype])


def both(tree):
    """A param tree as (reference jnp tree, port tensor tree)."""
    jt = {k: (both(v)[0] if isinstance(v, dict) else jnp.asarray(v)) for k, v in tree.items()}
    return jt, params_from_reference(tree, "cpu")


@pytest.mark.parametrize("dtype", KINDS)
def test_rmsnorm(dtype):
    x = arr((3, 5, 32), dtype, 0, scale=3.0)
    jp, tp = both({"scale": arr((32,), dtype, 1)})
    got = layers.rmsnorm(tp, params_from_reference({"x": x}, "cpu")["x"])
    assert got.dtype == getattr(torch, dtype)
    close(got, ref.rmsnorm(jp, jnp.asarray(x)), dtype)


@pytest.mark.parametrize("dtype", KINDS)
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(dtype, theta):
    pos = np.arange(40, dtype=np.int32).reshape(2, 20)
    cos, sin = layers.rope_angles(torch.from_numpy(pos), 16, theta)
    rcos, rsin = ref.rope_angles(jnp.asarray(pos), 16, theta)
    close(cos, rcos, "float32")
    close(sin, rsin, "float32")
    x = arr((2, 20, 4, 16), dtype, 2)
    got = layers.apply_rope(params_from_reference({"x": x}, "cpu")["x"], cos, sin)
    assert got.dtype == getattr(torch, dtype)
    close(got, ref.apply_rope(jnp.asarray(x), rcos, rsin), dtype)


@pytest.mark.parametrize("dtype", KINDS)
@pytest.mark.parametrize("bias", [False, True])
def test_linear(dtype, bias):
    tree = {"w": arr((32, 24), dtype, 3, scale=32 ** -0.5)}
    if bias:
        tree["b"] = arr((24,), dtype, 4)
    jp, tp = both(tree)
    x = arr((2, 7, 32), dtype, 5)
    close(layers.linear(tp, params_from_reference({"x": x}, "cpu")["x"]),
          ref.linear(jp, jnp.asarray(x)), dtype)


@pytest.mark.parametrize("dtype", KINDS)
@pytest.mark.parametrize("gated", [True, False])
def test_mlp(dtype, gated):
    tree = {"w_in": {"w": arr((32, 48), dtype, 6, 32 ** -0.5)},
            "w_out": {"w": arr((48, 32), dtype, 7, 48 ** -0.5)}}
    if gated:
        tree["w_gate"] = {"w": arr((32, 48), dtype, 8, 32 ** -0.5)}
    jp, tp = both(tree)
    x = arr((2, 7, 32), dtype, 9)
    close(layers.mlp(tp, params_from_reference({"x": x}, "cpu")["x"]),
          ref.mlp(jp, jnp.asarray(x)), dtype)


@pytest.mark.parametrize("dtype", KINDS)
def test_embed_and_padded_unembed(dtype):
    jp, tp = both({"table": arr((12, 16), dtype, 10)})
    tokens = np.random.default_rng(11).integers(0, 10, (3, 5)).astype(np.int32)
    emb = layers.embed(tp, torch.from_numpy(tokens), getattr(torch, dtype))
    close(emb, ref.embed(jp, jnp.asarray(tokens), getattr(jnp, dtype)), dtype)
    x = arr((3, 5, 16), dtype, 12)
    xt = params_from_reference({"x": x}, "cpu")["x"]
    for vocab in (None, 12, 10):
        got = layers.unembed(tp, xt, vocab)
        want = np.asarray(ref.unembed(jp, jnp.asarray(x), vocab))
        assert got.dtype == torch.float32 and got.shape == (3, 5, 12)
        np.testing.assert_array_equal(np.isneginf(got.numpy()), np.isneginf(want))
        close(got, want, "float32")
    assert np.isneginf(layers.unembed(tp, xt, 10).numpy()[..., 10:]).all()


@pytest.mark.parametrize("dtype", KINDS)
def test_inits_have_the_reference_layout(dtype):
    import jax

    key = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    pairs = [
        (ref.rmsnorm_init(8, jd), layers.rmsnorm_init(8, td, "cpu")),
        (ref.linear_init(key, 8, 4, jd, bias=True), layers.linear_init(gen, 8, 4, td, bias=True, device="cpu")),
        (ref.mlp_init(key, 8, 12, jd), layers.mlp_init(gen, 8, 12, td, device="cpu")),
        (ref.mlp_init(key, 8, 12, jd, gated=False), layers.mlp_init(gen, 8, 12, td, gated=False, device="cpu")),
        (ref.embed_init(key, 10, 8, jd), layers.embed_init(gen, 10, 8, td, "cpu")),
    ]

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        return (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))

    for want, got in pairs:
        assert layout(got) == layout(want)
    assert torch.equal(layers.rmsnorm_init(8, td, "cpu")["scale"], torch.ones(8, dtype=td))
