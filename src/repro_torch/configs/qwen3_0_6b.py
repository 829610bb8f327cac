"""Qwen3-0.6B: qk_norm, GQA kv=8, head_dim 128 decoupled from d_model.
[hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=3072, vocab_size=151936,
    qk_norm=True, rope_theta=1_000_000.0,
    notes="Dense arch: sort technique inapplicable (DESIGN.md §6).",
)
