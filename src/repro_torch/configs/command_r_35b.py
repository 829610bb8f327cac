"""Command-R 35B: GQA kv=8, no biases, large vocab.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22528, vocab_size=256000,
    rope_theta=4_000_000.0,
    remat_policy="none",
    notes="Dense arch: sort technique inapplicable (DESIGN.md §6).",
)
