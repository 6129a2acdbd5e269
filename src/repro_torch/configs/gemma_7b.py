"""gemma-7b [dense] — 28L d=3072 16H (GQA kv=16) ff=24576, vocab=256000,
GeGLU, head_dim=256, tied embeddings, embedding scaled by sqrt(d).
[arXiv:2403.08295; hf]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="gemma-7b", kind="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, d_ff=24576,
    vocab=256000, ffn_act="geglu", head_dim=256, tie_embeddings=True,
)

SMOKE = ModelConfig(
    arch="gemma-7b", kind="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=192,
    vocab=512, ffn_act="geglu", head_dim=32, tie_embeddings=True,
)
