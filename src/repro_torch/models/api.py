"""Model API: config dataclass + family dispatch + step factories.

The port's copy of ``repro/models/api.py``.  ``build_model(cfg)`` returns
a ``Model`` facade with uniform entry points (init / loss / prefill /
decode / state init); the step factories make the functions the train and
serve launchers call.  Every family of the JAX package is built: dense,
MoE, VLM, hybrid, RWKV and enc-dec (whose prefill takes ``frames`` and
returns the decode cache only, with no logits, as JAX's).

``make_train_step`` takes gradients with ``torch.autograd.grad`` over
detached copies of the parameter leaves and returns them as a tree (JAX's
functional shape): nothing accumulates into ``.grad`` and the caller's
tensors are left as they were.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from ..train.optimizer import AdamW, Optimizer, tree_leaves, tree_like, tree_map
from . import hybrid, lm, ssm, whisper
from .sharding import placed_like, replicated, vocab_parallel_argmax


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
    loss: Callable[[Any, Dict[str, torch.Tensor]], torch.Tensor]
    prefill: Optional[Callable] = None
    decode: Optional[Callable] = None
    init_state: Optional[Callable] = None  # (batch, cap) → decode state


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family in ("dense", "moe", "vlm"):
        return Model(
            cfg=cfg,
            init=lambda gen: lm.init_lm(cfg, gen),
            loss=lambda p, b: lm.lm_loss(p, cfg, b),
            prefill=lambda p, b, cap: lm.prefill(
                p, cfg, tokens=b.get("tokens"), embeds=b.get("embeds"),
                cache_capacity=cap, positions3=b.get("positions3")),
            decode=lambda p, cache, toks: lm.decode_step(p, cfg, cache, toks),
            init_state=lambda bsz, cap, device=None: lm.init_cache(cfg, bsz, cap, device),
        )
    if cfg.family == "hybrid":
        return Model(
            cfg=cfg,
            init=lambda gen: hybrid.init_hybrid(cfg, gen),
            loss=lambda p, b: hybrid.lm_loss(p, cfg, b),
            prefill=lambda p, b, cap: hybrid.prefill(p, cfg, b["tokens"], cap),
            decode=lambda p, st, toks: hybrid.decode_step(p, cfg, st, toks),
            init_state=lambda bsz, cap, device=None: hybrid.init_decode_state(
                None, cfg, bsz, cap, device),
        )
    if cfg.family == "rwkv":
        return Model(
            cfg=cfg,
            init=lambda gen: ssm.init_rwkv_lm(cfg, gen),
            loss=lambda p, b: ssm.rwkv_lm_loss(p, cfg, b),
            prefill=lambda p, b, cap: ssm.rwkv_prefill(p, cfg, b["tokens"]),
            decode=lambda p, st, toks: ssm.rwkv_decode_step(p, cfg, st, toks),
            init_state=lambda bsz, cap, device=None: ssm.rwkv_init_state(cfg, bsz, device),
        )
    if cfg.family == "encdec":
        return Model(
            cfg=cfg,
            init=lambda gen: whisper.init_encdec(cfg, gen),
            loss=lambda p, b: whisper.encdec_loss(p, cfg, b),
            prefill=lambda p, b, cap: whisper.prefill(p, cfg, b["frames"], cap),
            decode=lambda p, cache, toks: whisper.decode_step(p, cfg, cache, toks),
        )
    raise ValueError(f"unknown family {cfg.family}")


# ---------------------------------------------------------------------------
# step factories
# ---------------------------------------------------------------------------


def _microbatch_slices(batch: Dict[str, torch.Tensor], m: int) -> Dict[str, torch.Tensor]:
    """Reshape each batch leaf to (m, b/m, ...); positions3 batches on dim 1."""
    out = {}
    for k, v in batch.items():
        if k == "positions3":
            b = v.shape[1]
            out[k] = torch.movedim(v.reshape(3, m, b // m, *v.shape[2:]), 1, 0)
        else:
            out[k] = v.reshape(m, v.shape[0] // m, *v.shape[1:])
    return out


def value_and_grad(loss_fn: Callable[[Any, Any], torch.Tensor], params: Any, batch: Any):
    """(loss, gradient tree) of ``loss_fn(params, batch)``, as
    ``jax.value_and_grad`` gives them: each gradient in its parameter's
    dtype, zeros where the loss does not reach a leaf.  DTensor leaves give
    DTensor gradients (a leaf replicated over the data axes comes back as
    a partial sum there)."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_like(live, list(grads))


def make_train_step(model: Model, optimizer: Optional[Optimizer] = None,
                    microbatch: Optional[int] = None,
                    grad_constraint: Optional[Callable[[Any], Any]] = None):
    """Gradient-accumulation train step: ``(params, opt_state, batch) →
    (params', opt_state', {"loss"})``.

    ``microbatch`` m > 1 splits the global batch into m slices and
    accumulates their gradients into f32 zeros, then divides by m, as JAX
    does; with m ≤ 1 the gradients come in the parameters' dtype.

    The same step runs on DTensors placed by ``models/sharding.py``, inside
    its ``dtensor_scope`` (``frontends/tensor.py:lower_to_pjit`` binds it so),
    called alike on every rank of the mesh: a microbatch slice keeps its
    batch leaf's placement, and ``grad_constraint`` (ZeRO-2, as JAX's: a
    tree → the tree placed by ``tree_grad_specs``) places each microbatch's
    gradients and the f32 accumulator."""
    opt = optimizer or AdamW()
    m = microbatch if microbatch is not None else model.cfg.microbatch
    constrain = grad_constraint or (lambda tree: tree)

    def train_step(params, opt_state, batch):
        if m <= 1:
            loss, grads = value_and_grad(model.loss, params, batch)
        else:
            # a batch leaf split over the data axes is gathered before its
            # microbatches are cut; each slice then takes the leaf's placement
            slices = _microbatch_slices({k: replicated(v) for k, v in batch.items()}, m)
            gsum = constrain(tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                                      params))
            lsum = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
            for i in range(m):
                mb = {k: placed_like(v[i], batch[k]) for k, v in slices.items()}
                l, g = value_and_grad(model.loss, params, mb)
                tree_map(lambda acc, x: acc.add_(x), gsum, constrain(g))
                lsum = lsum + l
            grads = tree_map(lambda g: g / m, gsum)
            loss = lsum / m
        new_params, new_state = opt.update(grads, opt_state, params)
        return new_params, new_state, {"loss": loss}

    return train_step, opt


def make_serve_step(model: Model):
    """``(params, state, tokens) → (next token (B, 1) int32, logits,
    state')``: greedy, the lowest index among equal maxima, as
    ``jnp.argmax``.  On DTensor logits the argmax runs per rank
    (``sharding.vocab_parallel_argmax``), never over gathered logits."""

    def serve_step(params, state, tokens):
        logits, new_state = model.decode(params, state, tokens)
        if hasattr(logits, "placements"):
            next_tok = vocab_parallel_argmax(logits)
        else:
            next_tok = torch.argmax(logits, dim=-1)
        next_tok = next_tok.to(torch.int32)[:, None]
        return next_tok, logits, new_state

    return serve_step


def make_prefill_step(model: Model, cache_capacity: int):
    def prefill_step(params, batch):
        return model.prefill(params, batch, cache_capacity)

    return prefill_step
