"""The LM substrate on torch: the config dataclass and family dispatch
(``api``), shared layers (``layers``: norms, RoPE/M-RoPE, attention,
MLPs, MoE) and the decoder-only LM (``lm``: dense, MoE, SWA and M-RoPE
variants; forward, loss, prefill and decode), each a copy of its
``repro/models`` counterpart.  The SSM, RWKV and enc-dec families come
later."""
