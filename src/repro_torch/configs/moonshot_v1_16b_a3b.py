"""Moonlight-16B-A3B (moonshot) — MoE 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B].

48L, d_model 2048, 16 heads (kv=16, MHA), expert d_ff 1408, vocab 163840.
Expert parallelism: 64 experts over the 16-way model axis (4/device).
Full attention → long_500k skipped.  (Shared-expert and dense-first-layer
details of the HF checkpoint are simplified to a uniform MoE stack; see
DESIGN.md.)
"""
from ..models.api import ModelConfig

CONFIG = ModelConfig(
    arch="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=163840, d_head=128,
    n_experts=64, top_k=6, rope_theta=5e4, dtype="bfloat16",
)

REDUCED = ModelConfig(
    arch="moonshot-smoke", family="moe", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=64, vocab=512, d_head=32,
    n_experts=8, top_k=2, dtype="float32", remat=False, moe_capacity_factor=8.0,
)
