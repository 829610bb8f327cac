"""Mamba2-1.3B: attention-free SSD (state-space duality), state 128.
[arXiv:2405.21060; unverified]"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280,
    pattern=("mamba",), ffn_pattern=(None,),
    ssm_state=128, ssm_head_dim=64,
    notes="Attention-free: paper technique inapplicable to the layer stack "
          "(DESIGN.md §6); long_500k runs (O(1) state decode).",
)
