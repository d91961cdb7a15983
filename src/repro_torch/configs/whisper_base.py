"""Whisper-base — encoder-decoder, conv audio frontend STUBBED
[arXiv:2212.04356].

6L encoder + 6L decoder, d_model 512, 8 heads (MHA), d_ff 2048 (gelu),
vocab 51865.  ``input_specs`` feeds precomputed frame embeddings
(B, S, 512) — the conv frontend is a stub per the assignment.  Decode
shapes run the DECODER with cross-attention.  Full attention → long_500k
skipped.
"""
from ..models.api import ModelConfig

CONFIG = ModelConfig(
    arch="whisper-base", family="encdec", n_layers=6, n_enc_layers=6,
    d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048, vocab=51865, d_head=64,
    mlp_type="gelu", rope_theta=1e4, dtype="bfloat16",
)

REDUCED = ModelConfig(
    arch="whisper-smoke", family="encdec", n_layers=2, n_enc_layers=2,
    d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512, d_head=32,
    mlp_type="gelu", dtype="float32", remat=False,
)
