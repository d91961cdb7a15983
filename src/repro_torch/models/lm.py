"""Decoder-only transformer LM, dense family: forward, loss and serving.

The port's copy of ``repro/models/lm.py``.  Parameters are a dict shaped
like the JAX tree, ``{"emb", "final_norm", "layers": {...}}``, with the
per-layer leaves stacked on a leading ``L`` axis; the layer ``scan``
becomes a Python loop over ``L``.  The backbone takes the layers with one
``torch.unbind`` per leaf (``layers.unstack_layers``); with ``cfg.remat``
and a gradient being recorded, each layer (or each group of
``cfg.remat_group`` layers, under JAX's conditions) runs under
``torch.utils.checkpoint``, as JAX's ``jax.checkpoint`` around the scan
body.  The dense family has no auxiliary loss, so ``forward`` returns the
logits alone and ``lm_loss`` the chunked cross-entropy.  Decode carries
an (L, B, Hkv, cap, D) KV cache and writes each step's keys and values
into it in place (the JAX package returns a new cache; its serve step
donates the old one).

The logits are ``x.float() @ emb.float().T`` as in JAX: at Qwen2-1.5B's
width that makes a 0.93 GB f32 copy of ``emb`` on every call (once per
loss, shared by its chunks).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

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


def _layers_fwd(cfg, layers, x, positions):
    for lp in layers:
        x = _layer_fwd(cfg, lp, x, positions)
    return x


def backbone(params, cfg, x, positions):
    """Run all layers. x: (B, S, D) → the final-normed hidden states.

    ``remat_group`` g > 1 checkpoints *groups* of g layers (when g divides
    the depth and ``remat`` is on, as in JAX): only L/g boundary
    activations are saved, each layer is still recomputed once."""
    layers = L.unstack_layers(params["layers"], cfg.n_layers)
    remat = cfg.remat and torch.is_grad_enabled()
    g = cfg.remat_group
    if g < 1 or cfg.n_layers % g or cfg.scan_unroll:
        g = 1
    for i in range(0, cfg.n_layers, g):
        group = layers[i:i + g]
        if remat:
            x = checkpoint(_layers_fwd, cfg, group, x, positions, use_reentrant=False)
        else:
            x = _layers_fwd(cfg, group, x, positions)
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


def _ce_chunk(emb32, xs, ls, ms):
    logits = xs.float() @ emb32.T                                   # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, ls.long()[..., None])[..., 0]
    return torch.sum((lse - ll) * ms), torch.sum(ms)


def chunked_ce_loss(params, cfg, x_final, labels, mask, chunk: int = 512):
    """Next-token CE without materializing full logits.

    x_final: (B, S, D); labels, mask: (B, S).  A loop over sequence chunks,
    each checkpointed when a gradient is being recorded, so backward
    recomputes each chunk's logits."""
    b, s, d = x_final.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"chunked_ce_loss: sequence {s} is not a multiple of chunk {chunk}")
    emb = params["emb"].float()
    tot = torch.zeros((), dtype=torch.float32, device=x_final.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x_final.device)
    remat = torch.is_grad_enabled()
    for i in range(0, s, chunk):
        args = (emb, x_final[:, i:i + chunk], labels[:, i:i + chunk], mask[:, i:i + chunk])
        t, c = (checkpoint(_ce_chunk, *args, use_reentrant=False) if remat
                else _ce_chunk(*args))
        tot = tot + t
        cnt = cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(params, cfg, batch):
    """batch: {tokens|embeds, labels, mask} → scalar f32 loss (the dense
    family has no auxiliary loss)."""
    x = embed(params, cfg, batch.get("tokens"), batch.get("embeds"))
    b, s = x.shape[0], x.shape[1]
    xf = backbone(params, cfg, x, _positions(b, s, x.device))
    return chunked_ce_loss(params, cfg, xf, batch["labels"], batch["mask"],
                           chunk=cfg.loss_chunk)


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
    for i, lp in enumerate(L.unstack_layers(params["layers"], cfg.n_layers)):
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
    for i, lp in enumerate(L.unstack_layers(params["layers"], cfg.n_layers)):
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
