"""Decoder-only transformer LM, dense family, forward and serving only.

The port's copy of ``repro/models/lm.py``.  Parameters are a dict shaped
like the JAX tree, ``{"emb", "final_norm", "layers": {...}}``, with the
per-layer leaves stacked on a leading ``L`` axis; the layer ``scan``
becomes a Python loop over ``L`` that takes views of the stacked leaves.
Remat has no counterpart in a forward pass (callers run under
``torch.inference_mode()``).  The dense family has no auxiliary loss, so
``forward`` returns the logits alone.  Decode carries an (L, B, Hkv, cap,
D) KV cache and writes each step's keys and values into it in place (the
JAX package returns a new cache; its serve step donates the old one).

The logits are ``x.float() @ emb.float().T`` as in JAX: at Qwen2-1.5B's
width that makes a 0.93 GB f32 copy of ``emb`` on every call.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from . import layers as L


def init_lm(cfg, gen: torch.Generator) -> Dict[str, Any]:
    dt = cfg.param_dtype
    dev = gen.device
    lead = (cfg.n_layers,)
    p: Dict[str, Any] = {
        "emb": L.dense_init(gen, (cfg.vocab, cfg.d_model), scale=0.02, dtype=dt),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }
    if cfg.is_moe:
        raise NotImplementedError("MoE layers are not ported yet (ROADMAP Queue 1 item 8)")
    p["layers"] = {
        "attn": L.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                                 cfg.qkv_bias, dtype=dt, lead=lead),
        "attn_norm": torch.ones(lead + (cfg.d_model,), dtype=dt, device=dev),
        "mlp_norm": torch.ones(lead + (cfg.d_model,), dtype=dt, device=dev),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype=dt, lead=lead),
    }
    return p


def _layer_fwd(cfg, lp, x, positions):
    h = x + L.attention_block(
        lp["attn"], L.rmsnorm(x, lp["attn_norm"]), positions,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
        causal=cfg.causal, window=cfg.window, rope_theta=cfg.rope_theta,
        attn_mode=cfg.attn_mode,
    )
    z = L.rmsnorm(h, lp["mlp_norm"])
    return h + L.mlp_block(lp["mlp"], z, cfg.mlp_type)


def backbone(params, cfg, x, positions):
    """Run all layers. x: (B, S, D) → the final-normed hidden states."""
    for i in range(cfg.n_layers):
        x = _layer_fwd(cfg, L.select_layer(params["layers"], i), x, positions)
    return L.rmsnorm(x, params["final_norm"])


def embed(params, cfg, tokens=None, embeds=None):
    if embeds is not None:
        return embeds.to(cfg.param_dtype)
    return params["emb"][tokens]


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def forward(params, cfg, tokens=None, embeds=None, positions=None):
    """Full forward → logits (B, S, V). For tests/small shapes only."""
    x = embed(params, cfg, tokens, embeds)
    b, s, _ = x.shape
    if positions is None:
        positions = _positions(b, s, x.device)
    x = backbone(params, cfg, x, positions)
    return x.float() @ params["emb"].float().T


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg, bsz: int, cap: int, device=None) -> Dict[str, Any]:
    shape = (cfg.n_layers, bsz, cfg.n_kv_heads, cap, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=cfg.param_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.param_dtype, device=device),
            "len": 0}


def _layer_kv(cfg, lp, x, positions):
    """Recompute K/V for the cache during prefill."""
    xn = L.rmsnorm(x, lp["attn_norm"])
    _, k, v = L._qkv(lp["attn"], xn, cfg.n_heads, cfg.n_kv_heads, cfg.d_head)
    if cfg.rope_theta > 0:
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return k, v


def prefill(params, cfg, tokens=None, embeds=None, cache_capacity: Optional[int] = None):
    """Process the prompt; returns (last-position logits (B, V) f32, kv
    cache {"k", "v": (L, B, Hkv, cap, D), "len": S}), positions past S
    zero."""
    x = embed(params, cfg, tokens, embeds)
    b, s, _ = x.shape
    cap = cache_capacity or s
    if cap < s:
        raise ValueError(f"cache capacity {cap} below the prompt length {s}")
    positions = _positions(b, s, x.device)
    cache = init_cache(cfg, b, cap, x.device)
    for i in range(cfg.n_layers):
        lp = L.select_layer(params["layers"], i)
        k, v = _layer_kv(cfg, lp, x, positions)
        cache["k"][i, :, :, :s] = k
        cache["v"][i, :, :, :s] = v
        x = _layer_fwd(cfg, lp, x, positions)
    xf = L.rmsnorm(x, params["final_norm"])
    cache["len"] = s
    logits = xf[:, -1].float() @ params["emb"].float().T
    return logits, cache


def decode_step(params, cfg, cache, tokens):
    """One decode step. tokens: (B, 1) → (logits (B, V), the cache with this
    step's keys and values written in and ``len`` one more)."""
    x = embed(params, cfg, tokens)
    clen = cache["len"]
    for i in range(cfg.n_layers):
        lp = L.select_layer(params["layers"], i)
        xn = L.rmsnorm(x, lp["attn_norm"])
        att, _, _ = L.decode_attention_block(
            lp["attn"], xn, cache["k"][i], cache["v"][i], clen,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
            window=cfg.window, rope_theta=cfg.rope_theta,
        )
        h = x + att
        z = L.rmsnorm(h, lp["mlp_norm"])
        x = h + L.mlp_block(lp["mlp"], z, cfg.mlp_type)
    x = L.rmsnorm(x, params["final_norm"])
    logits = x[:, -1].float() @ params["emb"].float().T
    return logits, {"k": cache["k"], "v": cache["v"], "len": clen + 1}
