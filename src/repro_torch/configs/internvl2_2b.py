"""InternVL2-2B: InternViT frontend (STUBBED) + InternLM2-1.8B backbone.
[arXiv:2404.16821; hf] — input_specs provides precomputed patch embeddings."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92553,
    frontend="vision", n_frontend_tokens=256,
    notes="VLM: backbone only per assignment; 256 patch-embedding stub tokens "
          "prepended. Dense arch: sort technique inapplicable to FFN path.",
)
