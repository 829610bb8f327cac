"""Kernel T (``topk_select``) on the CPU: its plain version and
``engine.topk(impl='kernel')``, which routes to it, bit for bit against the
reference's ``topk`` and NumPy's stable argsort; and the route, which keeps
the kv network for what T does not take.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_bits_equal
from _torch_topk import CASES, case_id, numpy_topk, topk_keys
from repro.engine import kv as ref_kv
from repro_torch.carry import tensor_to_reference
from repro_torch.engine import kv
from repro_torch.kernels.bitonic_sort import bitonic_sort as kernels
from repro_torch.kernels.bitonic_sort import ops
from repro_torch.keys import to_kernel_keys


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_plain_topk_select_is_the_stable_order(case, largest):
    kind, dtype, shape, k = case
    x = topk_keys(kind, dtype, shape, seed=len(CASES) + k)
    got = kernels.topk_select(to_kernel_keys(x).contiguous(), k, largest)
    assert got.dtype == torch.int32 and got.shape == shape[:-1] + (k,)
    np.testing.assert_array_equal(got.numpy(), numpy_topk(x, k, largest))


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_kernel_topk_matches_reference(case, largest):
    kind, dtype, shape, k = case
    x = topk_keys(kind, dtype, shape, seed=k)
    got_v, got_i = kv.topk(x, k, largest=largest, impl="kernel")
    want_v, want_i = ref_kv.topk(jnp.asarray(tensor_to_reference(x)), k, largest=largest)
    assert_bits_equal(got_v, want_v)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_i.numpy(), numpy_topk(x, k, largest))


@pytest.mark.parametrize("k,takes", [(1, True), (kernels.SELECT_MAX_K, True),
                                     (kernels.SELECT_MAX_K + 1, False)])
def test_topk_routes_by_what_kernel_t_takes(k, takes, monkeypatch):
    calls = []

    def kernel_topk(x, k, *, largest=True):
        calls.append(k)
        return ops.kernel_topk(x, k, largest=largest)

    monkeypatch.setattr(kv, "kernel_topk", kernel_topk)
    x = topk_keys("specials", torch.float32, (2, 1000), seed=k)
    got_v, got_i = kv.topk(x, k, impl="kernel", block_n=64)
    assert calls == ([k] if takes else [])
    want_v, want_i = ref_kv.topk(jnp.asarray(x.numpy()), k)
    assert_bits_equal(got_v, want_v)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("x,k", [
    (torch.zeros(4, dtype=torch.float64), 2),  # no kernel dtype: the network raises
    (torch.zeros(4, dtype=torch.bool), 2),
    (torch.zeros(3, 4), 5),  # k > n: the network's first n, as the reference has them
    (torch.zeros(3, 4), 0),
    (torch.tensor(1.0), 1),  # no axis
])
def test_topk_takes_refuses_what_kernel_t_cannot_select(x, k):
    assert not ops.topk_takes(x, k)
    assert not ops.topk_takes(torch.zeros(4, device="meta"), 2)


@pytest.mark.parametrize("k", [0, 5, kernels.SELECT_MAX_K + 1])
def test_topk_select_refuses_k_out_of_range(k):
    with pytest.raises(ValueError, match="1 <= k"):
        kernels.topk_select(torch.zeros(2, 4), k)
    with pytest.raises(TypeError, match="unsupported key dtype"):
        kernels.topk_select(torch.zeros(2, 4, dtype=torch.uint8), 1)


def test_select_geometry_fills_the_card_and_holds_k():
    # the decode cell: 128 rows of 256,000, k = 50
    assert kernels.select_geometry(128, 256_000, 50) == (2, 64)
    assert kernels.select_geometry(1, 5, 5) == (1, 64)
    assert kernels.select_geometry(1, 1 << 24, 65) == (64, 128)
    assert kernels.select_geometry(4096, 256_000, 256) == (1, 256)
    for rows, n in ((1, 1), (3, 8193), (128, 256_000)):
        segments, _ = kernels.select_geometry(rows, n, 1)
        assert 1 <= segments <= n and (segments == 1 or n // segments >= 4096)
