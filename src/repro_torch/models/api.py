"""Model API: config dataclass + family dispatch + step factories.

The port's copy of ``repro/models/api.py``.  ``build_model(cfg)`` returns
a ``Model`` facade with uniform entry points (init / prefill / decode /
state init); the step factories make the functions the serve launcher
calls.  Only the dense family is built; the loss and the train step
(``Model.loss``, ``make_train_step``) wait for the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple, Union

import torch

from . import lm


@dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                      # dense | moe | hybrid | rwkv | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                  # default: d_model // n_heads
    mlp_type: str = "swiglu"
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    causal: bool = True
    window: Optional[int] = None     # SWA
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_aux_weight: float = 0.01
    moe_capacity_factor: float = 1.25
    # SSM / hybrid
    d_inner: int = 0
    ssm_state: int = 0
    attn_every: int = 6
    ssm_chunk: int = 64
    # enc-dec
    n_enc_layers: int = 0
    # VLM
    mrope_sections: Optional[Tuple[int, ...]] = None
    # engineering
    dtype: str = "float32"
    attn_mode: Union[str, Callable] = "chunked"  # chunked | pallas | ref, or a function
    remat: bool = True
    sub_quadratic: bool = False      # eligible for long_500k
    scan_unroll: bool = False        # unroll layer scans (roofline probes)
    loss_chunk: int = 512            # CE loss sequence-chunk size
    microbatch: int = 1              # gradient-accumulation microbatches
    remat_group: int = 1             # layers per remat unit (sqrt-remat when >1)

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def n_attn_points(self) -> int:
        return -(-self.n_layers // self.attn_every)

    def n_params(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS)."""
        d, f, v, l = self.d_model, self.d_ff, self.vocab, self.n_layers
        emb = v * d
        if self.family in ("dense", "vlm", "moe"):
            attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads * self.d_head \
                + self.n_heads * self.d_head * d
            if self.is_moe:
                mlp = self.n_experts * 3 * d * f + d * self.n_experts
            else:
                mlp = (3 if self.mlp_type == "swiglu" else 2) * d * f
            return emb + l * (attn + mlp)
        if self.family == "hybrid":
            di, n = self.d_inner, self.ssm_state
            mamba = d * (2 * di + 2 * n + di // 64) + di * d
            shared = 4 * d * d + 3 * d * f
            return emb + l * mamba + shared
        if self.family == "rwkv":
            return emb + l * (5 * d * d + 2 * d * f + d * 128)
        if self.family == "encdec":
            per = 4 * d * self.n_heads * self.d_head + 2 * d * f
            return emb + (self.n_enc_layers + l) * per + l * 4 * d * d
        raise ValueError(self.family)

    def n_active_params(self) -> int:
        if not self.is_moe:
            return self.n_params()
        d, f, l = self.d_model, self.d_ff, self.n_layers
        attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads * self.d_head \
            + self.n_heads * self.d_head * d
        mlp = self.top_k * 3 * d * f
        return self.vocab * d + l * (attn + mlp)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[[torch.Generator], Any]
    prefill: Optional[Callable] = None
    decode: Optional[Callable] = None
    init_state: Optional[Callable] = None  # (batch, cap) → decode state


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "dense":
        return Model(
            cfg=cfg,
            init=lambda gen: lm.init_lm(cfg, gen),
            prefill=lambda p, b, cap: lm.prefill(
                p, cfg, tokens=b.get("tokens"), embeds=b.get("embeds"),
                cache_capacity=cap),
            decode=lambda p, cache, toks: lm.decode_step(p, cfg, cache, toks),
            init_state=lambda bsz, cap, device=None: lm.init_cache(cfg, bsz, cap, device),
        )
    if cfg.family in ("moe", "vlm", "hybrid", "rwkv", "encdec"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet (ROADMAP Queue 1 item 8)")
    raise ValueError(f"unknown family {cfg.family}")


# ---------------------------------------------------------------------------
# step factories
# ---------------------------------------------------------------------------


def make_serve_step(model: Model):
    def serve_step(params, state, tokens):
        logits, new_state = model.decode(params, state, tokens)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, new_state

    return serve_step


def make_prefill_step(model: Model, cache_capacity: int):
    def prefill_step(params, batch):
        return model.prefill(params, batch, cache_capacity)

    return prefill_step
