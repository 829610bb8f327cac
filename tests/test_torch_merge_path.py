"""Kernel M's plain version (``plain_merge_runs``: the kernel's tile cut,
diagonal searches, tie rule and merge) against ``rank_merge_pairs``, bit for
bit, and the rounds ``merge_adjacent`` keeps on the rank merge.

Runs are sorted on ``core.merge.sort_image`` (stable), as model B's tiles
and every merge round leave them; on such runs the merge path must give the
rank merge's bits: -0.0 beside +0.0 and NaN of either sign and any payload
keep run a's keys first among equal images.  The kernel itself is held to the
same oracle on the card in ``tests/test_torch_gpu.py``.
Tolerance: exact (bit patterns) throughout.
"""
import pytest
import torch

from repro_torch.core import merge
from repro_torch.kernels.bitonic_sort import bitonic_sort as kernels

TILE = kernels.MERGE_TILE
DTYPES = (torch.float32, torch.int32, torch.float16, torch.bfloat16)
KINDS = ("normal", "ties", "signed_zeros", "nan", "all_equal", "sentinel_pads")
# NaN of both signs, quiet and signalling, with several payloads, as bits
NAN_BITS = {
    torch.float32: (0x7FC00000, 0x7FC00001, -0x00400000, 0x7F800001, -0x007FFEDD),
    torch.float16: (0x7E00, 0x7E01, -0x0200, 0x7C01, -0x03FF),
    torch.bfloat16: (0x7FC0, 0x7FC1, -0x0040, 0x7F81, -0x007F),
}
# (shape, width): one tile up to n / 2, with leading dims and rows of several pairs
SHAPES = (
    ((1 << 15,), TILE // 2),
    ((1 << 15,), TILE),
    ((1 << 15,), 2 * TILE),
    ((3, 1 << 14), TILE // 2),
    ((3, 1 << 14), TILE),
    ((2, 3 * TILE), TILE // 2),
)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)


def sort_runs(x: torch.Tensor, width: int) -> torch.Tensor:
    """Each aligned ``width`` slice of ``x`` sorted stably on its sort image,
    bits kept."""
    rows = x.reshape(-1, width)
    order = torch.sort(merge.sort_image(rows), dim=-1, stable=True).indices
    return merge.gather_bits(rows, order).reshape(x.shape)


def merge_keys(kind: str, dtype: torch.dtype, shape, width: int, seed: int) -> torch.Tensor:
    """Seeded keys of ``kind`` whose ``width`` runs are sorted:
    ``ties`` draws from five values, so equal keys cross runs and tile edges;
    ``signed_zeros`` and ``nan`` put -0.0 beside +0.0 and NaN payloads among
    them; ``sentinel_pads`` ends each row in the +sentinel that model B pads
    with."""
    g = torch.Generator().manual_seed(seed)
    n = torch.Size(shape).numel()
    if kind == "normal":
        x = torch.randn(n, generator=g) * 100
        x = torch.randint(-(2**31), 2**31 - 1, (n,), generator=g, dtype=torch.int32) \
            if dtype == torch.int32 else x.to(dtype)
    elif kind == "all_equal":
        x = torch.full((n,), 7, dtype=dtype)
    else:
        x = torch.randint(-2, 3, (n,), generator=g).to(dtype)
    if kind in ("signed_zeros", "nan") and dtype.is_floating_point:
        x[torch.rand(n, generator=g) < 0.3] = -0.0
        x[torch.rand(n, generator=g) < 0.2] = 0.0
    if kind == "nan" and dtype.is_floating_point:
        at = torch.rand(n, generator=g) < 0.2
        pick = torch.randint(0, len(NAN_BITS[dtype]), (int(at.sum()),), generator=g)
        _bits(x)[at] = torch.tensor(NAN_BITS[dtype], dtype=_bits(x).dtype)[pick]
        x[torch.rand(n, generator=g) < 0.05] = float("inf")
    x = x.reshape(shape)
    if kind == "sentinel_pads":
        top = float("inf") if dtype.is_floating_point else torch.iinfo(dtype).max
        x[..., -(shape[-1] // 3):] = top
    return sort_runs(x, width)


def rank_merge(x: torch.Tensor, width: int) -> torch.Tensor:
    *lead, n = x.shape
    return merge.rank_merge_pairs(x.reshape(*lead, n // (2 * width), 2, width)).reshape(x.shape)


CASES = [(kind, dtype, shape, width) for kind in KINDS for dtype in DTYPES
         for shape, width in SHAPES if kind != "nan" or dtype.is_floating_point]


@pytest.mark.parametrize("kind,dtype,shape,width", CASES,
                         ids=[f"{k}-{str(d)[6:]}-{'x'.join(map(str, s))}-w{w}" for k, d, s, w in CASES])
def test_plain_merge_path_equals_the_rank_merge(kind, dtype, shape, width):
    x = merge_keys(kind, dtype, shape, width, seed=len(shape) * 1000 + width % 997)
    got = kernels.merge_runs(x, width)  # a CPU tensor: the plain version
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(_bits(got), _bits(rank_merge(x, width)))
    assert torch.equal(_bits(got), _bits(kernels.plain_merge_runs(x, width)))
    assert kernels.launch_counts()["merge_runs"] == 0


@pytest.mark.parametrize("threads,elems", [(256, 16), (64, 8), (32, 4)])
def test_plain_merge_path_at_other_tiles(threads, elems):
    # the tile cut is a parameter of the plain version: narrower tiles put
    # many more tile edges and thread splits inside runs of ties
    x = merge_keys("ties", torch.float32, (2, 1 << 13), 1 << 11, seed=threads)
    want = rank_merge(x, 1 << 11)
    assert torch.equal(_bits(kernels.plain_merge_runs(x, 1 << 11, threads, elems)), _bits(want))


def test_merge_runs_refuses_what_kernel_m_does_not_take():
    x = torch.zeros(2 * TILE)
    with pytest.raises(TypeError):
        kernels.merge_runs(x.to(torch.int64), TILE)
    with pytest.raises(TypeError):
        kernels.merge_runs(x.double(), TILE)
    with pytest.raises(ValueError, match="MERGE_TILE"):
        kernels.merge_runs(x, TILE // 4)  # merged runs narrower than a tile
    with pytest.raises(ValueError, match="MERGE_TILE"):
        kernels.merge_runs(x, 3 * TILE // 2)  # 2 * width does not divide the row
    with pytest.raises(ValueError, match="contiguous"):
        kernels.merge_runs(torch.zeros(2 * TILE, 2).t(), TILE)


class _OnTheCard(torch.Tensor):
    """A CPU tensor that says it is on the card, so that ``merge_adjacent``
    routes its round as it would there."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("dtype,width,values,takes", [
    (torch.float32, TILE // 2, None, True),
    (torch.bfloat16, 1 << 23, None, True),
    (torch.int32, TILE // 4, None, False),  # narrower than a tile
    (torch.float32, 3 * TILE // 4, None, False),  # 2 * width not a whole number of tiles
    (torch.int64, TILE, None, False),
    (torch.float64, TILE, None, False),
    (torch.float32, TILE, {"i": None}, False),  # the values path
])
def test_merge_adjacent_routes_rounds_to_kernel_m(dtype, width, values, takes, monkeypatch):
    # merge_adjacent on a round it takes to be on the card: keys only that
    # kernel M's rule takes go to merge_runs, every other round to the rank
    # merge, counted; the wrapper refuses the widths the rule refuses
    calls = []

    def spy_m(x, w):
        calls.append("merge_runs")
        return x

    def spy_rank(pairs, vals=None):
        calls.append("rank_merge_pairs")
        out = pairs.reshape(*pairs.shape[:-2], -1)
        return out if vals is None else (out, {k: v.reshape(out.shape) for k, v in vals.items()})

    monkeypatch.setattr(merge, "merge_runs", spy_m)
    monkeypatch.setattr(merge, "rank_merge_pairs", spy_rank)
    x = torch.empty(2 * width, dtype=dtype).as_subclass(_OnTheCard)
    if values is not None:
        values = {"i": torch.empty(2 * width, dtype=torch.int32)}
    kernels.reset_launch_counts()
    merge.merge_adjacent(x, width, values)
    assert calls == ["merge_runs" if takes else "rank_merge_pairs"]
    assert kernels.merge_round_counts() == {"merge_runs": 0, "rank_merge_pairs": int(not takes)}
    if values is None and dtype in kernels.KEY_DTYPES and not takes:
        with pytest.raises(ValueError, match="MERGE_TILE"):
            kernels.merge_runs(torch.zeros(2 * width, dtype=dtype), width)


def test_merge_adjacent_keeps_the_rank_merge_off_the_card(monkeypatch):
    calls = []
    rank = merge.rank_merge_pairs

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return rank(*args, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError("kernel M (its plain version) called on a CPU round")

    x = merge_keys("ties", torch.float32, (2, 2 * TILE), TILE, seed=3)
    want = rank_merge(x, TILE)
    monkeypatch.setattr(merge, "rank_merge_pairs", spy)
    monkeypatch.setattr(kernels, "plain_merge_runs", refuse)
    kernels.reset_launch_counts()
    assert torch.equal(_bits(merge.merge_adjacent(x, TILE)), _bits(want))
    v = torch.arange(x.numel(), dtype=torch.int32).view(x.shape)
    merged, _ = merge.merge_adjacent(x, TILE, {"i": v})
    assert torch.equal(_bits(merged), _bits(want))
    assert len(calls) == 2
    assert kernels.merge_round_counts() == {"merge_runs": 0, "rank_merge_pairs": 0}
