"""Qwen2-VL-7B — VLM backbone with M-RoPE [arXiv:2409.12191].

28L, d_model 3584, 28 heads (GQA kv=4), d_ff 18944 (swiglu), vocab 152064.
M-RoPE sections (16, 24, 24) over the 64 d_head/2 frequency slots; the
vision frontend is a STUB — ``input_specs`` provides patch embeddings
(B, S, D) and 3-stream positions.  Full attention → long_500k skipped.
"""
from ..models.api import ModelConfig

CONFIG = ModelConfig(
    arch="qwen2-vl-7b", family="vlm", n_layers=28, d_model=3584,
    n_heads=28, n_kv_heads=4, d_ff=18944, vocab=152064, d_head=128,
    mlp_type="swiglu", mrope_sections=(16, 24, 24), rope_theta=1e6,
    dtype="bfloat16",
)

REDUCED = ModelConfig(
    arch="qwen2-vl-smoke", family="vlm", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, d_head=32,
    mrope_sections=(4, 6, 6), dtype="float32", remat=False,
)
