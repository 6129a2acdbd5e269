"""dbrx-132b [moe] — 40L d=6144 48H (GQA kv=8) ff=10752, vocab=100352,
MoE 16 experts top-4 (fine-grained). [hf:databricks/dbrx-base; unverified]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="dbrx-132b", kind="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab=100352, ffn_act="swiglu", rope_theta=5e5,
    n_experts=16, top_k=4, capacity_factor=1.25,
)

SMOKE = ModelConfig(
    arch="dbrx-132b", kind="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab=512, ffn_act="swiglu",
    n_experts=4, top_k=2, capacity_factor=1.25,
)
