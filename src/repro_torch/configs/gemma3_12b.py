"""Gemma3-12B: 5:1 local:global attention cadence, window 1024, qk-norm,
128k context. [hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab_size=262144,
    pattern=("attn_l",) * 5 + ("attn",),
    ffn_pattern=("dense",) * 6,
    sliding_window=1024, qk_norm=True,
    rope_theta=1_000_000.0, rope_theta_local=10_000.0,
    notes="5:1 sliding-window cadence -> sub-quadratic serving memory; "
          "long_500k runs (ring-buffer local KV). Dense: sort technique "
          "inapplicable to FFN path.",
)
