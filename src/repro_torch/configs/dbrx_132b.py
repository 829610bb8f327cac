"""DBRX-base 132B: MoE 16 experts top-4, fine-grained; GQA kv=8.
[hf:databricks/dbrx-base; unverified]"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100352,
    pattern=("attn",), ffn_pattern=("moe",),
    n_experts=16, top_k=4,
    remat_policy="none",
    notes="MoE arch: paper technique (sort-based EP dispatch) on every layer.",
)
