"""StarCoder2-15B — dense GQA code model [arXiv:2402.19173].

40L, d_model 6144, 48 heads (GQA kv=4), d_ff 24576 (4x, gelu), vocab 49152,
RoPE.  Full attention → long_500k skipped (DESIGN.md §Arch-applicability).
"""
from ..models.api import ModelConfig

CONFIG = ModelConfig(
    arch="starcoder2-15b", family="dense", n_layers=40, d_model=6144,
    n_heads=48, n_kv_heads=4, d_ff=24576, vocab=49152, d_head=128,
    mlp_type="gelu", rope_theta=1e5, dtype="bfloat16",
)

REDUCED = ModelConfig(
    arch="starcoder2-15b-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=512, vocab=512, d_head=32,
    mlp_type="gelu", dtype="float32", remat=False,
)
