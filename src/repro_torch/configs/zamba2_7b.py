"""Zamba2-7B — hybrid Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].

81 mamba layers, d_model 3584 (d_inner 7168, ssm_state 64), one SHARED
attention+MLP block (32H MHA, d_ff 14336) applied every 6 layers, vocab
32000.  SSM decode state is O(1) → long_500k RUNS (the shared-attention
cache at 500k is the documented cost of the hybrid).
"""
from ..models.api import ModelConfig

CONFIG = ModelConfig(
    arch="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, d_ff=14336, vocab=32000, d_head=112,
    d_inner=7168, ssm_state=64, attn_every=6, ssm_chunk=64,
    rope_theta=1e4, dtype="bfloat16", sub_quadratic=True,
)

REDUCED = ModelConfig(
    arch="zamba2-smoke", family="hybrid", n_layers=5, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=256, vocab=512, d_head=32,
    d_inner=256, ssm_state=16, attn_every=2, ssm_chunk=16,
    dtype="float32", remat=False, sub_quadratic=True,
)
