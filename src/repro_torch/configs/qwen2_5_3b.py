"""qwen2.5-3b [dense] — 36L d=2048 16H (GQA kv=2) ff=11008, vocab=151936,
QKV bias, tied embeddings. [hf:Qwen/Qwen2.5-0.5B; hf]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="qwen2.5-3b", kind="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_ff=11008,
    vocab=151936, ffn_act="swiglu", qkv_bias=True, tie_embeddings=True,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    arch="qwen2.5-3b", kind="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, ffn_act="swiglu", qkv_bias=True, tie_embeddings=True,
)
