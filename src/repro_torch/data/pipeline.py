"""Synthetic data pipeline (torch): deterministic, checkpointable, sort-integrated.

Counterpart of ``repro/data/pipeline.py``:

* ``SyntheticLM``: a deterministic token stream (zipf-ish marginals, so the
  loss has structure to learn), numpy batches from ``default_rng((seed,
  step))``, bit-equal to the reference's; its state is (seed, step), so a
  restart from a checkpoint replays the same batches.
* ``Prefetcher``: a host thread that keeps batches ready.
* ``length_bucketed_batches``: documents of varying length grouped into
  batches of near-equal length by the paper's shared-memory sort (model B,
  ``repro_torch.core.shared_sort``), so each batch pads little.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch.carry import check_device
from repro_torch.core.shared_sort import shared_memory_sort

__all__ = ["PipelineState", "SyntheticLM", "Prefetcher", "length_bucketed_batches"]


@dataclass
class PipelineState:
    seed: int
    step: int


class SyntheticLM:
    """Deterministic synthetic LM batches: tokens ~ zipf-ish, labels = shift."""

    def __init__(self, vocab: int, batch: int, seq: int, *, seed: int = 0):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.state = PipelineState(seed=seed, step=0)

    def checkpoint_state(self) -> dict:
        return {"seed": self.state.seed, "step": self.state.step}

    def restore_state(self, s: dict) -> None:
        self.state = PipelineState(seed=int(s["seed"]), step=int(s["step"]))

    def _batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.state.seed, step))
        # zipf-ish marginal + a periodic structure the model can learn
        z = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        toks = (z % (self.vocab - 1)).astype(np.int32) + 1
        pattern = np.arange(self.seq + 1) % 7 == 0
        toks[:, pattern] = 1 + (np.arange(self.batch, dtype=np.int32) % 7)[:, None]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        while True:
            b = self._batch_at(self.state.step)
            self.state.step += 1
            yield b


class Prefetcher:
    """Host-side background prefetch (keeps step time off the data path).

    ``close`` stops the thread and waits for it, so the iterator it read
    (and the pipeline state behind it) is left alone afterwards: a driver
    that restores the pipeline after a failure starts a new ``Prefetcher``.
    """

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.it = it
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        for item in self.it:
            if self._stop.is_set():
                return
            self.q.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self, timeout: float = 60.0):
        self._stop.set()
        try:  # free the slot a blocked put waits for; the thread then sees the stop
            self.q.get_nowait()
        except queue.Empty:
            pass
        self.t.join(timeout)


def length_bucketed_batches(doc_lengths: np.ndarray, batch: int, *, n_threads: int = 8,
                            device="cuda"):
    """Group document ids into batches of near-equal length.

    Sorts the packed (length, id) keys with the paper's model-B sort on
    ``device``; adjacent ids then form minimal-padding batches.  Returns
    (batches (n_batches, batch) of doc ids, padding_waste_fraction_before,
    after).
    """
    n = len(doc_lengths)
    if n * (int(np.max(doc_lengths)) + 1) >= 2**31:
        raise ValueError("length*id packing exceeds int32 (enable x64 or shard the pool)")
    device = check_device(device)
    lengths = torch.as_tensor(np.asarray(doc_lengths), dtype=torch.int32, device=device)
    # stable key-value sort: pack (length, id); lengths fit comfortably
    packed = lengths * n + torch.arange(n, dtype=torch.int32, device=device)
    packed_sorted = shared_memory_sort(packed, n_threads=n_threads).cpu().numpy()
    order = (packed_sorted % n).astype(np.int64)
    sorted_len = (packed_sorted // n).astype(np.int64)

    usable = (n // batch) * batch
    batches = order[:usable].reshape(-1, batch)
    blens = sorted_len[:usable].reshape(-1, batch)

    def waste(arr):
        mx = arr.max(axis=1, keepdims=True)
        return float((mx - arr).sum() / np.maximum((mx * np.ones_like(arr)).sum(), 1))

    unsorted = np.asarray(doc_lengths)[:usable].reshape(-1, batch)
    return batches, waste(unsorted), waste(blens)
