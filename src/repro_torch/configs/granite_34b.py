"""Granite-34B-Code — dense MQA (kv=1), 88 layers [arXiv:2405.04324].

d_model 6144, 48 heads, d_ff 24576 (4x gelu, GPTBigCode lineage), vocab
49152.  The 88-layer depth is the scan-over-layers stress test.  Full
attention → long_500k skipped.
"""
from ..models.api import ModelConfig

CONFIG = ModelConfig(
    arch="granite-34b", family="dense", n_layers=88, d_model=6144,
    n_heads=48, n_kv_heads=1, d_ff=24576, vocab=49152, d_head=128,
    mlp_type="gelu", rope_theta=1e4, dtype="bfloat16",
)

REDUCED = ModelConfig(
    arch="granite-34b-smoke", family="dense", n_layers=3, d_model=128,
    n_heads=4, n_kv_heads=1, d_ff=512, vocab=512, d_head=32,
    mlp_type="gelu", dtype="float32", remat=False,
)
