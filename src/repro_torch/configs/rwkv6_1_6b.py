"""RWKV6-1.6B ("Finch") — attention-free linear RNN with data-dependent
decay [arXiv:2404.05892].

24L, d_model 2048, d_ff 7168, vocab 65536.  No KV cache; decode state is
(token-shift, wkv matrix) per layer → long_500k RUNS.
"""
from ..models.api import ModelConfig

CONFIG = ModelConfig(
    arch="rwkv6-1.6b", family="rwkv", n_layers=24, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=7168, vocab=65536, d_head=64,
    dtype="bfloat16", sub_quadratic=True,
)

REDUCED = ModelConfig(
    arch="rwkv6-smoke", family="rwkv", n_layers=2, d_model=128,
    n_heads=2, n_kv_heads=2, d_ff=256, vocab=512, d_head=64,
    dtype="float32", remat=False, sub_quadratic=True,
)
