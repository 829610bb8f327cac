"""The launcher the port's mesh examples share (not an example itself): run
a function on several ranks of a ``torch.distributed`` group, gloo ranks on
the CPU, NCCL with one card a rank on ``cuda``.  The ranks meet through a
``FileStore`` in a temporary directory, so no port is opened."""
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def default_ranks(device_type: str, cpu_ranks: int) -> int:
    """One rank a card on ``cuda``; ``cpu_ranks`` on the CPU."""
    return torch.cuda.device_count() if device_type == "cuda" else cpu_ranks


def run_ranks(fn, world: int, device_type: str, *args) -> None:
    """``fn(rank, world, device, *args)`` on ``world`` spawned ranks of one
    group (``fn`` must be importable: define it at a module's top level)."""
    if device_type == "cuda" and world > torch.cuda.device_count():
        raise SystemExit(f"{world} NCCL ranks need {world} cards; this host has "
                         f"{torch.cuda.device_count()} (run with --device cpu for gloo ranks)")
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(fn, world, device_type, os.path.join(tmp, "store"),
                                             args),
                           nprocs=world, join=True, start_method="spawn")


def _rank_main(rank, fn, world, device_type, store, args):
    torch.set_num_threads(1)
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device, backend = torch.device("cuda", rank), "nccl"
    else:
        device, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        fn(rank, world, device, *args)
    finally:
        dist.destroy_process_group()
