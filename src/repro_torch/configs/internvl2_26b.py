"""internvl2-26b [vlm] — 48L d=6144 48H (GQA kv=8) ff=16384, vocab=92553,
InternViT frontend stubbed: input_specs() supplies (b, 256, 6144) patch
embeddings prepended to the token sequence; the InternLM2-style backbone is
real. [arXiv:2404.16821; hf]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="internvl2-26b", kind="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=92553, ffn_act="swiglu",
    frontend="vision_stub", frontend_tokens=256,
)

SMOKE = ModelConfig(
    arch="internvl2-26b", kind="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, ffn_act="swiglu",
    frontend="vision_stub", frontend_tokens=8,
)
