"""Assigned input shapes × per-arch input specs (meta-device tensors only).

The port's copy of ``repro/configs/shapes.py``.  Shapes (LM family, 4 per
arch = 40 cells):

  train_4k    : seq 4096,   global_batch 256 — the train step
  prefill_32k : seq 32768,  global_batch 32  — the prefill step
  decode_32k  : seq 32768,  global_batch 128 — the serve step (1 token)
  long_500k   : seq 524288, global_batch 1   — the serve step; sub-quadratic
                archs only (mixtral SWA / zamba2 / rwkv6); skips recorded.

``input_specs`` returns tensors on the ``meta`` device where JAX returns
``jax.ShapeDtypeStruct``: a shape and a dtype, never allocated (the
dry-run's contract).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from ..models.api import Model, ModelConfig, build_model


@dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch × shape) cell."""
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, "full attention is quadratic at 500k; skipped per assignment"
    return True, ""


def _sds(shape, dtype) -> torch.Tensor:
    dt = dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)
    return torch.empty(tuple(shape), dtype=dt, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: Shape) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    specs: Dict[str, torch.Tensor] = {
        "labels": _sds((b, s), "int32"),
        "mask": _sds((b, s), "float32"),
    }
    if cfg.family == "vlm":
        specs["embeds"] = _sds((b, s, cfg.d_model), cfg.dtype)    # stub patch embeds
        specs["positions3"] = _sds((3, b, s), "int32")
    elif cfg.family == "encdec":
        specs["frames"] = _sds((b, s, cfg.d_model), cfg.dtype)    # stub conv frontend
        specs["tokens"] = _sds((b, s), "int32")
    else:
        specs["tokens"] = _sds((b, s), "int32")
    return specs


def prefill_batch_specs(cfg: ModelConfig, shape: Shape) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        return {"frames": _sds((b, s, cfg.d_model), cfg.dtype)}
    if cfg.family == "vlm":
        return {"embeds": _sds((b, s, cfg.d_model), cfg.dtype),
                "positions3": _sds((3, b, s), "int32")}
    return {"tokens": _sds((b, s), "int32")}


def decode_state_specs(model: Model, shape: Shape) -> Any:
    """The decode state on the meta device: ``init_state`` there, with
    ``"len"`` a 0-d int32 (the port's state keeps a Python int, JAX's
    spec an int32 scalar)."""
    b, cap = shape.global_batch, shape.seq_len
    cfg = model.cfg
    if cfg.family == "encdec":
        # decoder self-cache + cross K/V over 1500 encoder frames (the port's
        # Whisper model has no init_state, as JAX's has none)
        l, h, d = cfg.n_layers, cfg.n_heads, cfg.d_head
        return {
            "k": _sds((l, b, cfg.n_kv_heads, cap, d), cfg.dtype),
            "v": _sds((l, b, cfg.n_kv_heads, cap, d), cfg.dtype),
            "cross_k": _sds((l, b, h, 1500, d), cfg.dtype),
            "cross_v": _sds((l, b, h, 1500, d), cfg.dtype),
            "len": _sds((), "int32"),
        }
    if cfg.window is not None:
        cap = min(cap, cfg.window)   # SWA: rotating window-bounded cache
    state = model.init_state(b, cap, device="meta")
    if isinstance(state, dict) and "len" in state:
        state = dict(state, len=_sds((), "int32"))
    return state


def input_specs(cfg: ModelConfig, shape_name: str):
    """(kind, spec tree) for a cell — everything the step function takes
    besides params/opt_state."""
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return "train", train_batch_specs(cfg, shape)
    if shape.kind == "prefill":
        return "prefill", prefill_batch_specs(cfg, shape)
    state = decode_state_specs(build_model(cfg), shape)
    tokens = _sds((shape.global_batch, 1), "int32")
    return "decode", {"state": state, "tokens": tokens}
