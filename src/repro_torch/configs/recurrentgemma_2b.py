"""recurrentgemma-2b [hybrid] — 26L d=2560 10H (MQA kv=1) ff=7680,
vocab=256000, RG-LRU + local attention in a 2:1 pattern (rg, rg, attn),
window 2048, head_dim=256, d_rnn=2560 (Griffin lru_width == width).
[arXiv:2402.19427; hf]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="recurrentgemma-2b", kind="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256000, ffn_act="geglu", head_dim=256, tie_embeddings=True,
    pattern=("rglru", "rglru", "attn"), local_window=2048,
    rglru_d_rnn=2560,
)

SMOKE = ModelConfig(
    arch="recurrentgemma-2b", kind="hybrid",
    n_layers=5, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
    vocab=512, ffn_act="geglu", head_dim=32, tie_embeddings=True,
    pattern=("rglru", "rglru", "attn"), local_window=32,
    rglru_d_rnn=64,
)
