"""Shared layers: norms, RoPE, GQA attention, MLPs, init.

The port's copy of ``repro/models/layers.py`` for the dense family:
pure functions over explicit parameter dicts of tensors.  Initialisers
take a ``torch.Generator`` and a ``lead`` shape, so the per-layer leaves
of a model are made stacked on a leading ``L`` axis in one draw (the
JAX package stacks them with ``jax.vmap``).  MoE, M-RoPE and
cross-attention wait for their families.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..kernels import ops as kops

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape: Sequence[int], scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, 1) · scale (default 1/√fan_in, fan_in = shape[-2]) on the
    generator's device, cast to ``dtype``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (torch.randn(tuple(shape), generator=gen, device=gen.device) * s).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalised in f32, cast back to x's dtype, then scaled by ``w`` in
    that dtype (the JAX order)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, unbiased=False, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(d_head: int, theta: float = 10000.0,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
                            / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (B, H, S, D); positions: (B, S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)                 # (D/2,)
    angles = positions[:, None, :, None].float() * freqs             # (B,1,S,D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, optional SWA)
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int, d_head: int,
                   qkv_bias: bool = False, dtype: torch.dtype = torch.float32,
                   lead: Tuple[int, ...] = ()) -> Params:
    p = {
        "wq": dense_init(gen, lead + (d_model, n_heads * d_head), dtype=dtype),
        "wk": dense_init(gen, lead + (d_model, n_kv * d_head), dtype=dtype),
        "wv": dense_init(gen, lead + (d_model, n_kv * d_head), dtype=dtype),
        "wo": dense_init(gen, lead + (n_heads * d_head, d_model), dtype=dtype),
    }
    if qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros(lead + (width * d_head,), dtype=dtype, device=gen.device)
    return p


def _qkv(p: Params, x: torch.Tensor, n_heads: int, n_kv: int, d_head: int):
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, n_heads, d_head).transpose(1, 2)
    k = k.reshape(b, s, n_kv, d_head).transpose(1, 2)
    v = v.reshape(b, s, n_kv, d_head).transpose(1, 2)
    return q, k, v


def attention_block(p: Params, x: torch.Tensor, positions: torch.Tensor, *,
                    n_heads: int, n_kv: int, d_head: int,
                    causal: bool = True, window: Optional[int] = None,
                    rope_theta: float = 10000.0,
                    attn_mode: Union[str, Callable] = "chunked") -> torch.Tensor:
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, n_heads, n_kv, d_head)
    if rope_theta > 0:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    o = kops.attention(q, k, v, causal=causal, window=window, mode=attn_mode)
    o = o.transpose(1, 2).reshape(b, s, n_heads * d_head)
    return o @ p["wo"]


def decode_attention_block(p: Params, x: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, cache_len: int, *,
                           n_heads: int, n_kv: int, d_head: int,
                           window: Optional[int] = None, rope_theta: float = 10000.0):
    """One-token decode: returns (out, k cache, v cache).  The new key and
    value are written in place at ``cache_len % cap`` (a rotating write for
    a window-bounded cache, a plain append otherwise), which is what the
    JAX package's mask-and-where over the whole cache computes; the first
    ``min(cache_len + 1, cap)`` positions are then valid."""
    b = x.shape[0]
    cap = cache_k.shape[2]
    q, k, v = _qkv(p, x, n_heads, n_kv, d_head)
    if rope_theta > 0:
        pos = torch.full((b, 1), cache_len, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    write_pos = cache_len % cap
    cache_k[:, :, write_pos] = k[:, :, 0].to(cache_k.dtype)
    cache_v[:, :, write_pos] = v[:, :, 0].to(cache_v.dtype)
    o = kops.decode_attention(q, cache_k, cache_v, min(cache_len + 1, cap))
    o = o.transpose(1, 2).reshape(b, 1, n_heads * d_head)
    return o @ p["wo"], cache_k, cache_v


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, mlp_type: str = "swiglu",
             dtype: torch.dtype = torch.float32, lead: Tuple[int, ...] = ()) -> Params:
    if mlp_type == "swiglu":
        return {
            "w_gate": dense_init(gen, lead + (d_model, d_ff), dtype=dtype),
            "w_up": dense_init(gen, lead + (d_model, d_ff), dtype=dtype),
            "w_down": dense_init(gen, lead + (d_ff, d_model), dtype=dtype),
        }
    return {
        "w_up": dense_init(gen, lead + (d_model, d_ff), dtype=dtype),
        "w_down": dense_init(gen, lead + (d_ff, d_model), dtype=dtype),
    }


def mlp_block(p: Params, x: torch.Tensor, mlp_type: str = "swiglu") -> torch.Tensor:
    if mlp_type == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    # jax.nn.gelu is the tanh approximation by default
    return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]


def unstack_layers(tree: Union[Params, torch.Tensor], n: int) -> List[Any]:
    """The ``n`` layers of a tree of stacked (n, ...) leaves, as views made
    by one ``torch.unbind`` per leaf.  Under autograd the backward of an
    unbind stacks the layers' gradients once; indexing ``tree[i]`` per layer
    would build a zero-filled gradient of the whole leaf for every layer."""
    if isinstance(tree, dict):
        per_key = {k: unstack_layers(v, n) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))
