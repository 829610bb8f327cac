"""Qwen2-7B: GQA kv=4, QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152064,
    qkv_bias=True, rope_theta=1_000_000.0,
    notes="Dense arch: sort technique inapplicable (DESIGN.md §6).",
)
