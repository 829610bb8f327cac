"""End-to-end training on the PyTorch/CUDA port: a ~20M-param qwen3-family
model for 150 steps with checkpoints (the full-size configs are traced by
``repro_torch.launch.dryrun``; this runs the same driver end to end).

    PYTHONPATH=src python examples/torch_train_lm.py                  # ~20M, 150 steps, on the card
    PYTHONPATH=src python examples/torch_train_lm.py --tiny           # seconds
    PYTHONPATH=src python examples/torch_train_lm.py --moe            # tiny MoE LM on a mesh of
        # ranks (data x model; NCCL a rank a card, or 4 gloo ranks with
        # --device cpu), skewed router: the between-step capacity-learning
        # loop end to end; point $REPRO_SORT_PLANS at a file to keep the
        # learned factor
    add --device cpu to run on the CPU
"""
import argparse
import math
import os
import sys
import tempfile
from dataclasses import replace

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch

from torch_ranks import default_ranks, run_ranks


def register(name: str):
    """The example's configs, registered in ``ARCHS`` for the driver."""
    from repro_torch.configs.base import ARCHS

    base = ARCHS["qwen3-0.6b"]
    if name == "qwen3-moe-tiny":
        # cf=1.0 on a collapsed router overflows on step 1: the capacity loop
        # must visibly learn (and keep) a higher factor
        cfg = replace(base, name=name, n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                      head_dim=16, d_ff=32, vocab_size=128, kv_chunk=16, pattern=("attn",),
                      ffn_pattern=("moe",), n_experts=8, top_k=2, capacity_factor=1.0,
                      param_dtype=torch.float32, compute_dtype=torch.float32)
    else:  # ~20M params: the qwen3 family at 1/4 width
        cfg = replace(base, name=name, n_layers=8, d_model=256, n_heads=8, n_kv_heads=4,
                      head_dim=32, d_ff=1024, vocab_size=8192, kv_chunk=128,
                      param_dtype=torch.float32, compute_dtype=torch.float32)
    ARCHS[name] = cfg
    return name


def moe_rank(rank, world, device, steps):
    from repro_torch.launch.train import main as train_main

    mesh = f"data={2 if world % 4 == 0 else 1},model={world // (2 if world % 4 == 0 else 1)}"
    losses = train_main([
        "--arch", register("qwen3-moe-tiny"), "--steps", str(steps), "--batch", "4", "--seq", "32",
        "--lr", "1e-3", "--moe-skew", "6.0", "--mesh", mesh, "--device", device.type,
        "--dist-backend", "nccl" if device.type == "cuda" else "gloo",
    ])
    assert all(math.isfinite(l) for l in losses), losses
    if rank == 0:
        print(f"moe-train-smoke: {len(losses)} steps on {mesh}, all losses finite")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--moe", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    ap.add_argument("--ranks", type=int, default=None,
                    help="--moe: ranks (default: every card, or 4 on the CPU)")
    ap.add_argument("--ckpt-dir", default=None, help="default: a temporary directory")
    args = ap.parse_args()

    from repro_torch.launch.train import main as train_main

    if args.moe:
        run_ranks(moe_rank, args.ranks or default_ranks(args.device, 4), args.device,
                  args.steps or 5)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = args.ckpt_dir or tmp
            if args.tiny:
                train_main(["--arch", "qwen3-0.6b", "--reduced", "--steps", str(args.steps or 30),
                            "--batch", "4", "--seq", "32", "--lr", "5e-3", "--ckpt-dir", ckpt,
                            "--device", args.device])
            else:
                train_main(["--arch", register("qwen3-20m"), "--steps", str(args.steps or 150),
                            "--batch", "8", "--seq", "128", "--lr", "3e-3", "--microbatch", "2",
                            "--ckpt-dir", ckpt, "--state-dtype", "int8", "--device", args.device])
