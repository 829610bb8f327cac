"""Quickstart on the PyTorch/CUDA port: the paper's shared-memory sort
models, the hand-written bitonic kernels and the engine, in a minute.

    PYTHONPATH=src python examples/torch_quickstart.py               # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # kernels' plain versions

On a CUDA tensor ``kernel_sort`` launches the bitonic kernels (built with
nvcc on first use); on a CPU tensor it runs their plain torch versions.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

import numpy as np
import torch

import repro_torch
from repro_torch.core import bitonic_sort, nonrecursive_merge_sort
from repro_torch.engine import SortService, argsort, sort_kv
from repro_torch.kernels.bitonic_sort.ops import kernel_sort

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
ap.add_argument("--n", type=int, default=100_000, help="keys to sort")
args = ap.parse_args()
device = torch.device(args.device)

rng = np.random.default_rng(0)
x_np = rng.integers(100, 1000, size=args.n).astype(np.int32)  # the paper's 3-digit keys
x = torch.from_numpy(x_np).to(device)
want = np.sort(x_np)

# model A: shared-memory non-recursive merge sort (paper §3.2)
assert (repro_torch.sort(x, strategy="shared_merge", n_threads=8).cpu().numpy() == want).all()
print("model A  shared non-recursive merge  OK")

# model B: shared-memory hybrid quicksort + merge (paper §3.2, the winner)
assert (repro_torch.sort(x, strategy="shared_hybrid", n_threads=8).cpu().numpy() == want).all()
print("model B  shared hybrid quick+merge   OK")

# the building blocks are first-class too
assert (nonrecursive_merge_sort(x).cpu().numpy() == want).all()
assert (bitonic_sort(x[:4096]).cpu().numpy() == np.sort(x_np[:4096])).all()

# the hand-written bitonic kernels (CUDA on the card), element-exact vs np.sort
m = min(args.n, 65536)
assert (kernel_sort(x[:m], block_n=1024).cpu().numpy() == np.sort(x_np[:m])).all()
print(f"kernel   bitonic sort on {device.type:4s}       OK")

# the engine sorts records, not just keys: sort_kv carries any nest of
# values along with the keys (stable: equal keys keep arrival order)
payload = {"row": torch.arange(args.n, device=device), "feat": torch.ones(args.n, 4, device=device)}
sk, sv = sort_kv(x, payload)
order = np.argsort(x_np, kind="stable")
assert (sk.cpu().numpy() == want).all() and (sv["row"].cpu().numpy() == order).all()
assert (argsort(x).cpu().numpy() == order).all()
print("engine   sort_kv / argsort           OK")

# the serving front door: ragged batches, shape-bucketed, cells reused
svc = SortService(device=device)
sizes = [n for n in (1000, 800, 500) if n <= args.n]
outs = svc.submit([x_np[:n] for n in sizes])
assert all((o == np.sort(x_np[:n])).all() for o, n in zip(outs, sizes))
misses = svc.cache.stats()["misses"]
svc.submit([x_np[:n] for n in sizes])  # the same buckets: no new cell
assert svc.cache.stats()["misses"] == misses
print(f"engine   SortService bucket cache    OK   ({misses} cells)")

# models C and D need several ranks: see examples/torch_distributed_sort_demo.py
print("\nfor models C/D run: python examples/torch_distributed_sort_demo.py")
