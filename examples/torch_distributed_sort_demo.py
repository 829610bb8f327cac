"""Models C and D across ranks on the PyTorch/CUDA port (paper §3.3 / §3.4),
with the paper-faithful decimal MSD mode and the sample-splitter mode under
skew.

    PYTHONPATH=src python examples/torch_distributed_sort_demo.py              # NCCL, a rank a card
    PYTHONPATH=src python examples/torch_distributed_sort_demo.py --device cpu # 8 gloo ranks

Every rank passes its shard of the keys; model C leaves the sorted array on
rank 0, model D leaves each rank its contiguous range of it.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

from torch_ranks import default_ranks, run_ranks


def check_range(group, slab, valid, want: np.ndarray) -> None:
    """This rank's valid keys are its contiguous range of the sorted whole."""
    mine = slab[valid].cpu().numpy()
    counts = group.all_gather(torch.tensor([mine.size], device=slab.device)).cpu().numpy().ravel()
    start = int(counts[:group.rank].sum())
    assert counts.sum() == want.size and (mine == want[start:start + mine.size]).all()


def demo(rank, world, device, n):
    from repro_torch.core import cluster_sort, distributed_merge_sort
    from repro_torch.exchange import AxisGroup

    group = AxisGroup()
    rng = np.random.default_rng(0)
    x = rng.integers(100, 1000, size=n).astype(np.int32)
    m = n // world
    shard = torch.from_numpy(x[rank * m:(rank + 1) * m]).to(device)
    want = np.sort(x[:m * world])
    say = print if rank == 0 else (lambda *a: None)

    # model C: the distributed merge tree (MPI's rounds as point-to-point exchanges)
    out = distributed_merge_sort(shard, group)
    if rank == 0:
        assert (out.cpu().numpy() == want).all()
    say("model C  distributed merge tree      OK   (rank 0 holds all data: the")
    say("         paper's own scaling flaw, kept as the faithful baseline)")

    # model D: one-step MSD-radix scatter + local sort (no merging between ranks)
    slab, valid = cluster_sort(shard, group, mode="decimal", digits=3)
    check_range(group, slab, valid, want)
    say("model D  decimal MSD (paper-exact)   OK   (the result stays distributed)")

    # beyond the paper: sample splitters keep buckets balanced under heavy skew
    skewed = (rng.zipf(1.5, size=m * world) % 900 + 100).astype(np.int32)
    slab, valid = cluster_sort(torch.from_numpy(skewed[rank * m:(rank + 1) * m]).to(device), group,
                               mode="splitters")
    check_range(group, slab, valid, np.sort(skewed))
    say(f"model D+ sample splitters (skewed)   OK   ({world} ranks on {device.type})")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (NCCL, a rank a card) or cpu (gloo)")
    ap.add_argument("--ranks", type=int, default=None, help="default: every card, or 8 on the CPU")
    ap.add_argument("--n", type=int, default=80_000, help="keys in all")
    args = ap.parse_args()
    run_ranks(demo, args.ranks or default_ranks(args.device, 8), args.device, args.n)
