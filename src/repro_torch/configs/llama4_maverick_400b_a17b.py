"""llama4-maverick-400b-a17b [moe] — 48L d=5120 40H (GQA kv=8) ff=8192,
vocab=202048, MoE 128 experts top-1 (assigned config; early-fusion noted —
the fused-modality frontend is out of scope for the LM shape cells).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="llama4-maverick-400b-a17b", kind="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202048, ffn_act="swiglu", rope_theta=5e5,
    n_experts=128, top_k=1, capacity_factor=1.25,
)

SMOKE = ModelConfig(
    arch="llama4-maverick-400b-a17b", kind="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, ffn_act="swiglu",
    n_experts=8, top_k=1, capacity_factor=1.25,
)
