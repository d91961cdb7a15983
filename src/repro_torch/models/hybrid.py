"""Zamba2-style hybrid: a Mamba2 backbone with one *shared* attention + MLP
block (one set of weights) applied before every ``attn_every``-th layer.

The port's copy of ``repro/models/hybrid.py``.  JAX's layer scan with a
``lax.cond`` becomes a loop over the layers with ``if i % attn_every ==
0``; ``jax.checkpoint`` around the scan body becomes
``torch.utils.checkpoint`` per layer when a gradient is being recorded.
JAX's prefill and decode scan over groups of ``attn_every`` layers, each
group the shared block then its Mamba layers, and unroll the trailing
partial group (at Zamba2-7B: 13 groups of 6 and a tail of 3); here the
same order is one loop over the layers, the shared block at each layer
``i`` with ``i % attn_every == 0``, which is attention point
``i // attn_every``.  The serving state has the per-layer conv and SSM
states and one KV cache per attention point, ``n_attn_points`` of them.
Decode writes each step's key and value into that cache in place (as
``lm.decode_step`` does) and returns the conv and SSM states anew, as JAX
returns them.  Prefill computes the shared block's QKV twice at each
attention point, once for the cache (``_shared_kv``) and once inside the
block, as JAX does.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from . import layers as L
from . import ssm
from .lm import chunked_ce_loss, embed
from .sharding import zeros_placed_like


def init_hybrid(cfg, gen: torch.Generator) -> Dict[str, Any]:
    dt = cfg.param_dtype
    dev = gen.device
    lead = (cfg.n_layers,)
    return {
        "emb": L.dense_init(gen, (cfg.vocab, cfg.d_model), scale=0.02, dtype=dt),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        # one SHARED attention + MLP block
        "shared_attn": L.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.d_head, dtype=dt),
        "shared_attn_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "shared_mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, "swiglu", dtype=dt),
        "shared_mlp_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "layers": {
            "mamba": ssm.init_mamba2(gen, cfg.d_model, cfg.d_inner, cfg.ssm_state, dtype=dt,
                                     lead=lead),
            "norm": torch.ones(lead + (cfg.d_model,), dtype=dt, device=dev),
        },
    }


def _shared_block(p, cfg, x, positions):
    h = x + L.attention_block(
        p["shared_attn"], L.rmsnorm(x, p["shared_attn_norm"]), positions,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
        causal=True, rope_theta=cfg.rope_theta, attn_mode=cfg.attn_mode)
    return h + L.mlp_block(p["shared_mlp"], L.rmsnorm(h, p["shared_mlp_norm"]), "swiglu")


def _mamba(cfg, lp, x, state=None):
    """One Mamba layer on the residual stream: (x + y, its new state)."""
    kw = dict(d_inner=cfg.d_inner, ssm_state=cfg.ssm_state)
    xn = L.rmsnorm(x, lp["norm"])
    if state is None:
        y, st = ssm.mamba2_block(lp["mamba"], xn, chunk=cfg.ssm_chunk, **kw)
    else:
        y, st = ssm.mamba2_decode(lp["mamba"], xn, state, **kw)
    return x + y, st


def _layer(params, cfg, lp, x, positions, i):
    if i % cfg.attn_every == 0:
        x = _shared_block(params, cfg, x, positions)
    return _mamba(cfg, lp, x)[0]


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def backbone(params, cfg, x, positions):
    """The Mamba layers with the shared block every ``attn_every`` layers;
    returns the final-normed x."""
    remat = cfg.remat and torch.is_grad_enabled()
    for i, lp in enumerate(L.unstack_layers(params["layers"], cfg.n_layers)):
        args = (params, cfg, lp, x, positions, i)
        x = checkpoint(_layer, *args, use_reentrant=False) if remat else _layer(*args)
    return L.rmsnorm(x, params["final_norm"])


def lm_loss(params, cfg, batch):
    x = embed(params, cfg, batch["tokens"])
    xf = backbone(params, cfg, x, _positions(x.shape[0], x.shape[1], x.device))
    return chunked_ce_loss(params, cfg, xf, batch["labels"], batch["mask"],
                           chunk=cfg.loss_chunk)


# ---------------------------------------------------------------------------
# serving: recurrent decode state + shared-attn KV cache
# ---------------------------------------------------------------------------


def _shared_kv(params, cfg, x, positions):
    """K/V of the shared attention block for the prefill cache."""
    xn = L.rmsnorm(x, params["shared_attn_norm"])
    _, k, v = L._qkv(params["shared_attn"], xn, cfg.n_heads, cfg.n_kv_heads, cfg.d_head)
    if cfg.rope_theta > 0:
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return k, v


def _logits(params, x):
    xf = L.rmsnorm(x, params["final_norm"])
    return xf[:, -1].float() @ params["emb"].float().T


def init_decode_state(params, cfg, batch_size: int, cache_capacity: int,
                      device=None) -> Dict[str, Any]:
    """The empty serving state: conv (L, B, 3, Di) and SSM (L, B, H, N, 64)
    states, one (B, Hkv, cap, Dh) K and V cache per attention point, len
    0.  ``params`` is not read (JAX's signature)."""
    h = cfg.d_inner // ssm.MAMBA_HEAD
    kv = (cfg.n_attn_points, batch_size, cfg.n_kv_heads, cache_capacity, cfg.d_head)
    return {
        "conv": torch.zeros((cfg.n_layers, batch_size, 3, cfg.d_inner), dtype=cfg.param_dtype,
                            device=device),
        "ssm": torch.zeros((cfg.n_layers, batch_size, h, cfg.ssm_state, ssm.MAMBA_HEAD),
                           dtype=ssm._math_dtype(cfg.param_dtype), device=device),
        "k": torch.zeros(kv, dtype=cfg.param_dtype, device=device),
        "v": torch.zeros(kv, dtype=cfg.param_dtype, device=device),
        "len": 0,
    }


def prefill(params, cfg, tokens, cache_capacity: int):
    """The prompt pass building the whole decode state: (last-position
    logits (B, V) f32, {"conv", "ssm": per layer, "k", "v": per attention
    point, positions past S zero, "len": S})."""
    x = embed(params, cfg, tokens)
    b, s, _ = x.shape
    if cache_capacity < s:
        raise ValueError(f"cache capacity {cache_capacity} below the prompt length {s}")
    positions = _positions(b, s, x.device)
    state = init_decode_state(params, cfg, b, cache_capacity, x.device)
    convs, ssms = [], []
    for i, lp in enumerate(L.unstack_layers(params["layers"], cfg.n_layers)):
        if i % cfg.attn_every == 0:
            point = i // cfg.attn_every
            k, v = _shared_kv(params, cfg, x, positions)
            if point == 0 and isinstance(k, DTensor):  # the caches on the mesh, split as k is
                kv = tuple(state["k"].shape)
                state["k"], state["v"] = (zeros_placed_like(kv, cfg.param_dtype, k, lead=1)
                                          for _ in range(2))
            state["k"][point, :, :, :s] = k
            state["v"][point, :, :, :s] = v
            x = _shared_block(params, cfg, x, positions)
        x, (conv, st) = _mamba(cfg, lp, x)
        convs.append(conv)
        ssms.append(st)
    state.update(conv=torch.stack(convs), ssm=torch.stack(ssms), len=s)
    return _logits(params, x), state


def _decode_attn(params, cfg, x, ck, cv, clen):
    xn = L.rmsnorm(x, params["shared_attn_norm"])
    att, _, _ = L.decode_attention_block(
        params["shared_attn"], xn, ck, cv, clen,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
        rope_theta=cfg.rope_theta)
    x = x + att
    return x + L.mlp_block(params["shared_mlp"], L.rmsnorm(x, params["shared_mlp_norm"]),
                           "swiglu")


def decode_step(params, cfg, state, tokens):
    """One-token decode. tokens: (B, 1) → (logits (B, V), the state with
    this step's keys and values written into its caches in place, new conv
    and SSM states, ``len`` one more)."""
    x = embed(params, cfg, tokens)
    clen = state["len"]
    convs, ssms = [], []
    for i, lp in enumerate(L.unstack_layers(params["layers"], cfg.n_layers)):
        if i % cfg.attn_every == 0:
            point = i // cfg.attn_every
            x = _decode_attn(params, cfg, x, state["k"][point], state["v"][point], clen)
        x, (conv, st) = _mamba(cfg, lp, x, (state["conv"][i], state["ssm"][i]))
        convs.append(conv)
        ssms.append(st)
    new_state = {"conv": torch.stack(convs), "ssm": torch.stack(ssms), "k": state["k"],
                 "v": state["v"], "len": clen + 1}
    return _logits(params, x), new_state
