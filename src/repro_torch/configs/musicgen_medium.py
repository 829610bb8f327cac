"""MusicGen-medium 1.5B: decoder-only over EnCodec tokens (vocab 2048),
MHA (kv=24), plain GELU FFN. [arXiv:2306.05284; hf]
Frontend STUB: conditioning embeddings provided by input_specs; the 4-codebook
delay pattern is collapsed to one stream (assignment: backbone only)."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048,
    mlp_gated=False,
    frontend="audio", n_frontend_tokens=64,
    notes="Audio decoder: backbone per assignment. Dense arch: sort technique "
          "inapplicable.",
)
