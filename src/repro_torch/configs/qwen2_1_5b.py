"""Qwen2-1.5B — dense GQA with QKV bias [arXiv:2407.10671].

28L, d_model 1536, 12 heads (GQA kv=2), d_ff 8960 (swiglu), vocab 151936.
Full attention → long_500k skipped.
"""
from ..models.api import ModelConfig

CONFIG = ModelConfig(
    arch="qwen2-1.5b", family="dense", n_layers=28, d_model=1536,
    n_heads=12, n_kv_heads=2, d_ff=8960, vocab=151936, d_head=128,
    mlp_type="swiglu", qkv_bias=True, rope_theta=1e6, dtype="bfloat16",
)

REDUCED = ModelConfig(
    arch="qwen2-1.5b-smoke", family="dense", n_layers=2, d_model=96,
    n_heads=3, n_kv_heads=1, d_ff=256, vocab=512, d_head=32,
    qkv_bias=True, dtype="float32", remat=False,
)
