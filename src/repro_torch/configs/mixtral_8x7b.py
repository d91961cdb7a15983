"""Mixtral-8x7B — MoE 8 experts top-2 with sliding-window attention
[arXiv:2401.04088].

32L, d_model 4096, 32 heads (GQA kv=8), expert d_ff 14336, vocab 32000,
SWA window 4096.  SWA makes decode cache window-bounded → long_500k RUNS.
8 experts < 16-way model axis → EP impossible; falls back to TP over the
expert d_ff (sharding.py rule).
"""
from ..models.api import ModelConfig

CONFIG = ModelConfig(
    arch="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=32000, d_head=128,
    n_experts=8, top_k=2, window=4096, rope_theta=1e6, dtype="bfloat16",
    sub_quadratic=True,
)

REDUCED = ModelConfig(
    arch="mixtral-smoke", family="moe", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, d_head=32,
    n_experts=4, top_k=2, window=32, dtype="float32", remat=False,
    sub_quadratic=True, moe_capacity_factor=8.0,  # drop-free at smoke scale
)
