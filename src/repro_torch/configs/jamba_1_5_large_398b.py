"""Jamba-1.5-large 398B: Mamba+attention 1:7 interleave, MoE 16e top-2 every
second layer. [arXiv:2403.19887; hf]"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    pattern=("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba"),
    ffn_pattern=("dense", "moe", "dense", "moe", "dense", "moe", "dense", "moe"),
    n_experts=16, top_k=2,
    ssm_state=128, ssm_head_dim=64,
    remat_policy="none",
    notes="Hybrid MoE: sort-based EP dispatch on 36 MoE layers; long_500k runs "
          "(9 attn layers hold KV; 63 mamba layers O(1) state).",
)
