"""The LM substrate on torch: the config dataclass and family dispatch
(``api``), shared layers (``layers``: norms, RoPE/M-RoPE, attention,
MLPs, MoE), the decoder-only LM (``lm``: dense, MoE, SWA and M-RoPE
variants; forward, loss, prefill and decode), the Mamba2 and RWKV6 blocks
and the RWKV LM (``ssm``), the Zamba2-style hybrid (``hybrid``) and the
Whisper-style encoder-decoder (``whisper``), each a copy of its
``repro/models`` counterpart."""
