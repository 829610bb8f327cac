"""Granite-3.0 MoE 3B-a800m: 40 experts top-8, fine-grained d_ff=512.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    pattern=("attn",), ffn_pattern=("moe",),
    n_experts=40, top_k=8,
    notes="40 experts on 16 EP shards: experts padded to 48 (3/shard), "
          "router masks the 8 dummies — stresses bucket!=shard mapping.",
)
