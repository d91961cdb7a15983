"""Shared layers: norms, RoPE/M-RoPE, GQA attention, MLPs, MoE, init.

The port's copy of ``repro/models/layers.py``: pure functions over
explicit parameter dicts of tensors.  Initialisers take a
``torch.Generator`` and a ``lead`` shape, so the per-layer leaves of a
model are made stacked on a leading ``L`` axis (the JAX package stacks
them with ``jax.vmap``), each stacked leaf drawn one leading index at a
time (``stacked_init``).  On DTensors (the sharded train
step) the attention's head views and the attention itself go through
``models/sharding.py``'s helpers; on plain tensors they are the plain
reshapes and call.
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .sharding import (group_heads, merge_heads, per_rank_attention, per_rank_moe, placed_like,
                       split_heads, tp_input, write_position)

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


def stacked_init(gen: torch.Generator, lead: Tuple[int, ...], shape: Sequence[int],
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``dense_init`` of ``lead + shape``, drawn one leading index at a
    time into a leaf of ``dtype``: the f32 draw is one index's, not the
    whole leaf's (at Moonlight's width one stacked expert leaf is 8.86 G
    elements, a 35.4 GB f32 draw; Granite-34B's stacked ``w_up`` is a
    53.15 GB one, and a layer of it 0.60 GB)."""
    shape = tuple(shape)
    if not lead:
        return dense_init(gen, shape, dtype=dtype)
    out = torch.empty(tuple(lead) + shape, dtype=dtype, device=gen.device)
    for idx in itertools.product(*(range(n) for n in lead)):
        out[idx] = dense_init(gen, shape, dtype=dtype)
    return out


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


def _section_ids(sections: Sequence[int], n: int, device) -> torch.Tensor:
    """``jnp.repeat(arange(len(sections)), sections, total_repeat_length=n)``:
    stream i for ``sections[i]`` slots, cut to ``n`` or padded with the
    last stream."""
    ids = torch.repeat_interleave(torch.arange(len(sections)), torch.tensor(list(sections)))[:n]
    if ids.numel() < n:
        ids = torch.cat([ids, ids[-1:].expand(n - ids.numel())])
    return ids.to(device)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, sections: Sequence[int],
                theta: float = 10000.0) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): 3 position streams (t, h, w).

    x: (B, H, S, D); positions3: (3, B, S).  ``sections`` partitions the D/2
    frequency slots among the three streams (sum(sections) == D/2)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                           # (D/2,)
    sec_id = _section_ids(sections, d // 2, x.device)                # (D/2,)
    pos_per_slot = positions3.float()[sec_id]                        # (D/2, B, S)
    angles = pos_per_slot.permute(1, 2, 0)[:, None] * freqs          # (B,1,S,D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, optional SWA / M-RoPE)
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int, d_head: int,
                   qkv_bias: bool = False, dtype: torch.dtype = torch.float32,
                   lead: Tuple[int, ...] = ()) -> Params:
    p = {
        "wq": stacked_init(gen, lead, (d_model, n_heads * d_head), dtype),
        "wk": stacked_init(gen, lead, (d_model, n_kv * d_head), dtype),
        "wv": stacked_init(gen, lead, (d_model, n_kv * d_head), dtype),
        "wo": stacked_init(gen, lead, (n_heads * d_head, d_model), dtype),
    }
    if qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros(lead + (width * d_head,), dtype=dtype, device=gen.device)
    return p


def _qkv(p: Params, x: torch.Tensor, n_heads: int, n_kv: int, d_head: int):
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = split_heads(q, n_heads, d_head).transpose(1, 2)
    k = split_heads(k, n_kv, d_head).transpose(1, 2)
    v = split_heads(v, n_kv, d_head).transpose(1, 2)
    return q, k, v


def attention_block(p: Params, x: torch.Tensor, positions: torch.Tensor, *,
                    n_heads: int, n_kv: int, d_head: int,
                    causal: bool = True, window: Optional[int] = None,
                    rope_theta: float = 10000.0,
                    mrope_sections: Optional[Sequence[int]] = None,
                    positions3: Optional[torch.Tensor] = None,
                    attn_mode: Union[str, Callable] = "chunked") -> torch.Tensor:
    """Self-attention on x (B, S, D).  On DTensors x's gradient is summed to
    x's placements once (``tp_input``: the column-split QKV products give
    partial gradients), and the output comes back in x's placements (the
    row-split ``wo``'s partial sums all-reduced: Megatron's layout)."""
    x = tp_input(x)
    q, k, v = _qkv(p, x, n_heads, n_kv, d_head)
    if mrope_sections is not None:
        q = apply_mrope(q, positions3, mrope_sections, rope_theta)
        k = apply_mrope(k, positions3, mrope_sections, rope_theta)
    elif rope_theta > 0:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    o = per_rank_attention(lambda q, k, v: kops.attention(
        q, k, v, causal=causal, window=window, mode=attn_mode), group_heads(q, n_kv), k, v)
    return placed_like(merge_heads(o.transpose(1, 2), n_kv) @ p["wo"], x)


def decode_attention_block(p: Params, x: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, cache_len: int, *,
                           n_heads: int, n_kv: int, d_head: int,
                           window: Optional[int] = None, rope_theta: float = 10000.0,
                           mrope_sections: Optional[Sequence[int]] = None,
                           positions3: Optional[torch.Tensor] = None):
    """One-token decode: returns (out, k cache, v cache).  The new key and
    value are written in place at ``cache_len % cap`` (a rotating write for
    a window-bounded cache, a plain append otherwise), which is what the
    JAX package's mask-and-where over the whole cache computes; the first
    ``min(cache_len + 1, cap)`` positions are then valid.  On DTensors the
    attention runs per rank (``sharding.per_rank_attention``), as a
    prefill's does."""
    b = x.shape[0]
    cap = cache_k.shape[2]
    q, k, v = _qkv(p, x, n_heads, n_kv, d_head)
    if mrope_sections is not None:
        q = apply_mrope(q, positions3, mrope_sections, rope_theta)
        k = apply_mrope(k, positions3, mrope_sections, rope_theta)
    elif rope_theta > 0:
        pos = torch.full((b, 1), cache_len, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    write_pos = cache_len % cap
    write_position(cache_k, write_pos, k[:, :, 0])
    write_position(cache_v, write_pos, v[:, :, 0])
    n = min(cache_len + 1, cap)
    o = per_rank_attention(lambda q, k, v: kops.decode_attention(q, k, v, n),
                           group_heads(q, n_kv), cache_k, cache_v)
    return merge_heads(o.transpose(1, 2), n_kv) @ p["wo"], cache_k, cache_v


def cross_attention_block(p: Params, x: torch.Tensor, enc_k: torch.Tensor,
                          enc_v: torch.Tensor, *, n_heads: int, n_kv: int,
                          d_head: int) -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V (B, Hkv,
    S_enc, D): no RoPE, and ``chunked_attention`` whatever the config's
    attention mode, as JAX's (so its blocks, taken from x's length, see the
    first S encoder positions only: ROADMAP Queue 3 item 30)."""
    q = split_heads(x @ p["wq"], n_heads, d_head).transpose(1, 2)
    o = per_rank_attention(lambda q, k, v: kops.attention(q, k, v, causal=False, mode="chunked"),
                           group_heads(q, n_kv), enc_k, enc_v)
    return merge_heads(o.transpose(1, 2), n_kv) @ p["wo"]


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, mlp_type: str = "swiglu",
             dtype: torch.dtype = torch.float32, lead: Tuple[int, ...] = ()) -> Params:
    if mlp_type == "swiglu":
        return {
            "w_gate": stacked_init(gen, lead, (d_model, d_ff), dtype),
            "w_up": stacked_init(gen, lead, (d_model, d_ff), dtype),
            "w_down": stacked_init(gen, lead, (d_ff, d_model), dtype),
        }
    return {
        "w_up": stacked_init(gen, lead, (d_model, d_ff), dtype),
        "w_down": stacked_init(gen, lead, (d_ff, d_model), dtype),
    }


def mlp_block(p: Params, x: torch.Tensor, mlp_type: str = "swiglu") -> torch.Tensor:
    """The dense MLP on x; on DTensors placed as ``attention_block``'s."""
    x = tp_input(x)
    if mlp_type == "swiglu":
        y = (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    else:  # jax.nn.gelu is the tanh approximation by default
        y = F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]
    return placed_like(y, x)


# ---------------------------------------------------------------------------
# MoE (capacity-based index dispatch: static shapes, batched expert products)
# ---------------------------------------------------------------------------


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             dtype: torch.dtype = torch.float32, lead: Tuple[int, ...] = ()) -> Params:
    """The router (D, E) in f32 whatever ``dtype`` is, as JAX makes it; the
    experts' SwiGLU weights (E, D, F), (E, D, F), (E, F, D) in ``dtype``,
    drawn one leading index at a time (``stacked_init``)."""
    return {
        "router": dense_init(gen, lead + (d_model, n_experts), dtype=torch.float32),
        "w_gate": stacked_init(gen, lead, (n_experts, d_model, d_ff), dtype),
        "w_up": stacked_init(gen, lead, (n_experts, d_model, d_ff), dtype),
        "w_down": stacked_init(gen, lead, (n_experts, d_ff, d_model), dtype),
    }


def moe_capacity(t: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    """Slots per expert for ``t`` tokens: JAX's Python-float expression."""
    return max(int(t * top_k / n_experts * capacity_factor), 4)


def moe_route(p: Params, xf: torch.Tensor, *, n_experts: int, top_k: int, capacity: int):
    """The router and the capacity dispatch of ``moe_block`` for xf (T, D):
    (probs (T, E), topw (T, K) renormalised, topi (T, K), pos (T·K,) each
    choice's place in its expert, keep (T·K,) = pos < capacity).

    The router's product is taken in the wider of x's and the router's
    dtypes (bf16 × f32 is an f32 product, as JAX promotes it) and the
    routing in at least f32.  The top k is a stable descending sort's
    first k, so among equal probabilities the lower expert wins, as
    ``jax.lax.top_k`` picks (``torch.topk`` picks any).  Each choice's
    place in its expert comes from a stable argsort of the expert ids, in
    token order, as JAX counts it."""
    dt = torch.promote_types(xf.dtype, p["router"].dtype)
    logits = (xf.to(dt) @ p["router"].to(dt)).to(torch.promote_types(dt, torch.float32))
    probs = torch.softmax(logits, dim=-1)                            # (T, E)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :top_k], topi[:, :top_k]                    # (T, K)
    topw = topw / torch.sum(topw, dim=-1, keepdim=True)
    flat_e = topi.reshape(-1)                                        # (T·K,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    start = torch.searchsorted(sorted_e, torch.arange(n_experts, device=xf.device))
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(flat_e.numel(), device=xf.device) - start[sorted_e]
    return probs, topw, topi, pos, pos < capacity


def moe_block(p: Params, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25,
              first_expert: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k capacity MoE.  x: (B, S, D) → (out (B, S, D), Switch's aux loss).

    Each (token, k) choice takes its place in its expert (``moe_route``);
    choices past the capacity C are dropped (Switch/GShard semantics), and
    T counts every row of x, a wave's padding rows too.  The kept rows are
    placed into an (E·C + 1, D) buffer at their slots, which are unique:
    JAX adds them into zeros, which gives the same values.  Dropped
    choices all go to the last row, which is discarded.  The experts run as
    batched products over E, (E, C, D) × (E, D, F).  The combine adds each
    token's K weighted rows in k order in x's dtype, ``0 + y_0 + y_1 +
    …``, which gives the bits of JAX's ``segment_sum`` on the CPU and, on
    the card, the same bits run to run (no atomics).

    ``p``'s experts may be the range ``first_expert`` onwards of the
    ``n_experts`` (``p["w_gate"].shape[0]`` of them): the routing is the
    whole one, and ``out`` adds only the choices of the experts held (a
    part of the sum that ``sharding.per_rank_moe`` completes).  On DTensors
    the block runs per rank (``sharding.per_rank_moe``)."""
    if hasattr(x, "placements"):
        return per_rank_moe(moe_block, p, x, n_experts=n_experts, top_k=top_k,
                            capacity_factor=capacity_factor)
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    capacity = moe_capacity(t, top_k, n_experts, capacity_factor)
    probs, topw, topi, pos, keep = moe_route(p, xf, n_experts=n_experts, top_k=top_k,
                                             capacity=capacity)
    held = p["w_gate"].shape[0]
    local_e = topi.reshape(-1) - first_expert
    if held < n_experts:  # the other experts' choices are another rank's
        keep = keep & (local_e >= 0) & (local_e < held)
    slot = torch.where(keep, local_e * capacity + pos, held * capacity)     # (T·K,)
    tok_idx = torch.arange(t, device=x.device).repeat_interleave(top_k)
    expert_in = xf.new_zeros((held * capacity + 1, d)).index_put((slot,), xf[tok_idx])
    expert_in = expert_in[:-1].reshape(held, capacity, d)

    h = F.silu(torch.bmm(expert_in, p["w_gate"])) * torch.bmm(expert_in, p["w_up"])
    out_e = torch.bmm(h, p["w_down"])                                 # (E, C, D)

    y = moe_combine(out_e, slot, topw, keep)

    # load-balancing aux loss (Switch): E · Σ_e f_e · P_e
    me = torch.mean(F.one_hot(topi[:, 0], n_experts).to(probs.dtype), dim=0)
    ce = torch.mean(probs, dim=0)
    aux = n_experts * torch.sum(me * ce)
    return y.reshape(b, s, d), aux


def moe_combine(out_e: torch.Tensor, slot: torch.Tensor, topw: torch.Tensor,
                keep: torch.Tensor) -> torch.Tensor:
    """The weighted combine of ``moe_block``: out_e (E, C, D), each choice's
    slot (T·K,), weights topw (T, K), keep (T·K,) → (T, D) in out_e's dtype.
    Each token's K rows, weighted in that dtype, are added in k order into
    zeros: ``0 + y_0 + y_1 + …``."""
    e, c, d = out_e.shape
    t, top_k = topw.shape
    out_flat = torch.cat([out_e.reshape(e * c, d), out_e.new_zeros((1, d))])
    w = (topw.reshape(-1)[:, None] * keep[:, None]).to(out_e.dtype)
    yk = (out_flat[slot] * w).reshape(t, top_k, d)
    y = torch.zeros((t, d), dtype=yk.dtype, device=yk.device)
    for k in range(top_k):
        y = y + yk[:, k]
    return y


def unstack_layers(tree: Union[Params, torch.Tensor], n: int) -> List[Any]:
    """The ``n`` layers of a tree of stacked (n, ...) leaves, as views made
    by one ``torch.unbind`` per leaf.  Under autograd the backward of an
    unbind stacks the layers' gradients once; indexing ``tree[i]`` per layer
    would build a zero-filled gradient of the whole leaf for every layer."""
    if isinstance(tree, dict):
        per_key = {k: unstack_layers(v, n) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))
