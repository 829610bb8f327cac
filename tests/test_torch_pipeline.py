"""The port's data pipeline (``repro_torch.data.pipeline``) against the reference's.

``SyntheticLM`` batches are numpy from ``default_rng((seed, step))`` in both
packages: bit-equal.  ``length_bucketed_batches`` sorts the packed (length,
id) keys with each package's model-B sort: the same batches of ids and the
same two waste fractions.
"""
import numpy as np
import pytest

from repro.data import pipeline as ref
from repro_torch.data import pipeline


@pytest.mark.parametrize("vocab,batch,seq,seed", [(50, 2, 8, 7), (151_936, 4, 64, 0),
                                                  (128, 3, 33, 11)])
def test_synthetic_batches_are_bit_equal(vocab, batch, seq, seed):
    got, want = iter(pipeline.SyntheticLM(vocab, batch, seq, seed=seed)), iter(
        ref.SyntheticLM(vocab, batch, seq, seed=seed))
    for _ in range(3):
        g, w = next(got), next(want)
        assert set(g) == set(w) == {"tokens", "labels"}
        for k in g:
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])
    np.testing.assert_array_equal(g["tokens"][:, 1:], g["labels"][:, :-1])


def test_pipeline_state_resumes_bit_exact():
    pipe = pipeline.SyntheticLM(vocab=101, batch=2, seq=8, seed=3)
    it = iter(pipe)
    for _ in range(4):
        next(it)
    saved = pipe.checkpoint_state()
    assert saved == {"seed": 3, "step": 4}
    want = next(iter(pipe))
    other = pipeline.SyntheticLM(vocab=101, batch=2, seq=8, seed=0)
    other.restore_state(saved)
    got = next(iter(other))
    np.testing.assert_array_equal(want["tokens"], got["tokens"])
    np.testing.assert_array_equal(want["labels"], ref.SyntheticLM(101, 2, 8, seed=3)._batch_at(4)["labels"])


def test_prefetcher_preserves_order_and_stops():
    direct = [b for _, b in zip(range(5), iter(ref.SyntheticLM(vocab=50, batch=1, seq=4, seed=1)))]
    pipe = pipeline.SyntheticLM(vocab=50, batch=1, seq=4, seed=1)
    pre = pipeline.Prefetcher(iter(pipe), depth=2)
    fetched = [next(pre) for _ in range(5)]
    pre.close()
    assert not pre.t.is_alive()  # close waits for the thread
    for d, f in zip(direct, fetched):
        np.testing.assert_array_equal(d["tokens"], f["tokens"])
    # the thread is gone, so the pipeline's state no longer moves
    step = pipe.state.step
    assert step >= 5 and pipe.state.step == step


@pytest.mark.parametrize("n,batch,seed", [(512, 16, 0), (1000, 7, 1), (37, 4, 2)])
def test_length_bucketing_equals_the_reference(n, batch, seed):
    lengths = np.random.default_rng(seed).integers(10, 2048, size=n)
    got = pipeline.length_bucketed_batches(lengths, batch, device="cpu")
    want = ref.length_bucketed_batches(lengths, batch)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.int64
    assert got[1] == want[1] and got[2] == want[2]
    assert got[0].shape == (n // batch, batch) and got[2] < got[1]


def test_length_bucketing_reduces_padding_waste():
    lengths = np.random.default_rng(0).integers(10, 2048, size=512)
    batches, before, after = pipeline.length_bucketed_batches(lengths, batch=16, device="cpu")
    assert after < before * 0.25, (before, after)
    assert sorted(batches.reshape(-1).tolist()) == list(range(512))


def test_length_bucketing_guards_int32_packing():
    lengths = np.full(70_000, 40_000)
    for fn in (ref.length_bucketed_batches, lambda l, b: pipeline.length_bucketed_batches(
            l, b, device="cpu")):
        with pytest.raises(ValueError, match="int32"):
            fn(lengths, 8)
