"""qwen2-7b [dense] — 28L d=3584 28H (GQA kv=4) ff=18944, vocab=152064,
QKV bias. [arXiv:2407.10671; hf]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="qwen2-7b", kind="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab=152064, ffn_act="swiglu", qkv_bias=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    arch="qwen2-7b", kind="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, ffn_act="swiglu", qkv_bias=True,
)
