"""mamba2-2.7b [ssm] — 64L d=2560, attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality), expand=2, head_dim=64.
ssm_chunk=64 keeps the intra-chunk decay tensor inside the prefill memory
budget (DESIGN.md §5). [arXiv:2405.21060; unverified]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="mamba2-2.7b", kind="ssm",
    n_layers=64, d_model=2560, n_heads=1, d_ff=0,
    vocab=50280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    ssm_chunk=64, tie_embeddings=True,
)

SMOKE = ModelConfig(
    arch="mamba2-2.7b", kind="ssm",
    n_layers=2, d_model=64, n_heads=1, d_ff=0,
    vocab=512, ssm_state=16, ssm_head_dim=16, ssm_expand=2,
    ssm_chunk=16, tie_embeddings=True,
)
