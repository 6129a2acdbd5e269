"""whisper-base [audio] — 6L (x2: encoder+decoder) d=512 8H ff=2048,
vocab=51865, enc-dec with stubbed conv frontend: input_specs() supplies
(b, 1500, 512) frame embeddings. Sinusoidal positions; assigned shapes
override whisper's native 448-token decoder max (DESIGN.md §5 note).
[arXiv:2212.04356; unverified]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="whisper-base", kind="encdec",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab=51865, ffn_act="gelu", pos="sinusoidal",
    enc_layers=6, enc_seq=1500, frontend="audio_stub",
)

SMOKE = ModelConfig(
    arch="whisper-base", kind="encdec",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=512, ffn_act="gelu", pos="sinusoidal",
    enc_layers=2, enc_seq=32, frontend="audio_stub",
)
