"""GLM4-9B — dense GQA [hf:THUDM/glm-4-9b].

40L, d_model 4096, 32 heads (GQA kv=2), d_ff 13696 (swiglu), vocab 151552,
RoPE.  Full attention → long_500k skipped.
"""
from ..models.api import ModelConfig

CONFIG = ModelConfig(
    arch="glm4-9b", family="dense", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=2, d_ff=13696, vocab=151552, d_head=128,
    mlp_type="swiglu", rope_theta=1e4, dtype="bfloat16",
)

REDUCED = ModelConfig(
    arch="glm4-9b-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, d_head=32, dtype="float32",
    remat=False,
)
