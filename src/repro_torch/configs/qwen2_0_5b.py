"""qwen2-0.5b [dense] — 24L d=896 14H (GQA kv=2) ff=4864, vocab=151936,
QKV bias, tied embeddings. [arXiv:2407.10671; hf]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="qwen2-0.5b", kind="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab=151936, ffn_act="swiglu", qkv_bias=True, tie_embeddings=True,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    arch="qwen2-0.5b", kind="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, ffn_act="swiglu", qkv_bias=True, tie_embeddings=True,
)
