"""The LM substrate on torch: the config dataclass and family dispatch
(``api``), shared layers (``layers``) and the decoder-only LM (``lm``),
each a copy of its ``repro/models`` counterpart.  Only the dense family
is ported; training, MoE, M-RoPE, SSM, RWKV and enc-dec come later."""
