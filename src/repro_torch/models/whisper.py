"""Whisper-style encoder-decoder backbone (conv audio frontend stubbed).

The port's copy of ``repro/models/whisper.py``.  The encoder takes
precomputed frame embeddings (B, S_enc, D) in place of the conv frontend;
its self-attention is non-causal at the config's attention mode, with RoPE
at positions ``arange(S_enc)`` as JAX's stub encoder has it (not Whisper's
sinusoids).  The decoder is a causal stack with cross-attention, which runs
``chunked_attention`` whatever the mode, as JAX's does (ROADMAP Queue 3
item 30).  Per-layer leaves are stacked on a leading axis
(``enc_layers``, ``dec_layers``); JAX's layer scans become loops over
``layers.unstack_layers``, each layer under ``torch.utils.checkpoint``
when ``cfg.remat`` is on and a gradient is being recorded.

Serving: ``prefill`` encodes the frames and stacks every decoder layer's
cross K/V (L, B, H, S_enc, Dh) beside an empty self-attention cache; it
returns the cache only, with no logits, as JAX's.  ``decode_step`` writes
each step's keys and values into the self cache in place (as
``lm.decode_step`` does).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L


def init_encdec(cfg, gen: torch.Generator) -> Dict[str, Any]:
    dt = cfg.param_dtype
    dev = gen.device
    d = cfg.d_model

    def ones(lead):
        return torch.ones(lead + (d,), dtype=dt, device=dev)

    def attention(lead, n_kv):
        return L.init_attention(gen, d, cfg.n_heads, n_kv, cfg.d_head, dtype=dt, lead=lead)

    def mlp(lead):
        return L.init_mlp(gen, d, cfg.d_ff, "gelu", dtype=dt, lead=lead)

    enc, dec = (cfg.n_enc_layers,), (cfg.n_layers,)
    return {
        "emb": L.dense_init(gen, (cfg.vocab, d), scale=0.02, dtype=dt),
        "enc_final_norm": ones(()),
        "final_norm": ones(()),
        "enc_layers": {"attn": attention(enc, cfg.n_kv_heads), "attn_norm": ones(enc),
                       "mlp": mlp(enc), "mlp_norm": ones(enc)},
        # the cross block has as many kv heads as query heads, as JAX makes it
        "dec_layers": {"attn": attention(dec, cfg.n_kv_heads), "attn_norm": ones(dec),
                       "cross": attention(dec, cfg.n_heads), "cross_norm": ones(dec),
                       "mlp": mlp(dec), "mlp_norm": ones(dec)},
    }


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _run_layers(cfg, layers, n: int, layer, x, *args):
    """``layer(cfg, lp, x, *args)`` over the ``n`` stacked layers, each under
    a checkpoint when ``cfg.remat`` is on and a gradient is being recorded."""
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in L.unstack_layers(layers, n):
        x = (checkpoint(layer, cfg, lp, x, *args, use_reentrant=False) if remat
             else layer(cfg, lp, x, *args))
    return x


def _enc_layer(cfg, lp, x, positions):
    h = x + L.attention_block(
        lp["attn"], L.rmsnorm(x, lp["attn_norm"]), positions,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
        causal=False, rope_theta=cfg.rope_theta, attn_mode=cfg.attn_mode)
    return h + L.mlp_block(lp["mlp"], L.rmsnorm(h, lp["mlp_norm"]), "gelu")


def encode(params, cfg, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S_enc, D) stubbed conv-frontend output → encoder states."""
    x = frames.to(cfg.param_dtype)
    b, s, _ = x.shape
    x = _run_layers(cfg, params["enc_layers"], cfg.n_enc_layers, _enc_layer, x,
                    _positions(b, s, x.device))
    return L.rmsnorm(x, params["enc_final_norm"])


def _cross_kv(lp, enc: torch.Tensor, n_heads: int, d_head: int):
    k = L.split_heads(enc @ lp["cross"]["wk"], n_heads, d_head).transpose(1, 2)
    v = L.split_heads(enc @ lp["cross"]["wv"], n_heads, d_head).transpose(1, 2)
    return k, v


def _cross(cfg, lp, h, ck, cv):
    return h + L.cross_attention_block(lp["cross"], L.rmsnorm(h, lp["cross_norm"]), ck, cv,
                                       n_heads=cfg.n_heads, n_kv=cfg.n_heads,
                                       d_head=cfg.d_head)


def _dec_layer(cfg, lp, x, positions, enc):
    h = x + L.attention_block(
        lp["attn"], L.rmsnorm(x, lp["attn_norm"]), positions,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
        causal=True, rope_theta=cfg.rope_theta, attn_mode=cfg.attn_mode)
    h = _cross(cfg, lp, h, *_cross_kv(lp, enc, cfg.n_heads, cfg.d_head))
    return h + L.mlp_block(lp["mlp"], L.rmsnorm(h, lp["mlp_norm"]), "gelu")


def decode_train(params, cfg, enc: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder forward → final hidden states (B, S_dec, D)."""
    x = params["emb"][tokens]
    b, s, _ = x.shape
    x = _run_layers(cfg, params["dec_layers"], cfg.n_layers, _dec_layer, x,
                    _positions(b, s, x.device), enc)
    return L.rmsnorm(x, params["final_norm"])


def encdec_loss(params, cfg, batch) -> torch.Tensor:
    """batch: {frames (B, S_enc, D), tokens, labels, mask (B, S_dec)} →
    the chunked CE loss of the teacher-forced decoder, f32."""
    from .lm import chunked_ce_loss

    enc = encode(params, cfg, batch["frames"])
    xf = decode_train(params, cfg, enc, batch["tokens"])
    return chunked_ce_loss(params, cfg, xf, batch["labels"], batch["mask"],
                           chunk=cfg.loss_chunk)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def prefill(params, cfg, frames: torch.Tensor, cache_capacity: int) -> Dict[str, Any]:
    """Encode the frames; return the decode cache: the empty self-attention
    cache {"k", "v": (L, B, Hkv, cap, Dh) zeros}, every decoder layer's
    cross K/V {"cross_k", "cross_v": (L, B, H, S_enc, Dh)} and "len" 0.
    No logits, as JAX's."""
    enc = encode(params, cfg, frames)
    kv = [_cross_kv(lp, enc, cfg.n_heads, cfg.d_head)
          for lp in L.unstack_layers(params["dec_layers"], cfg.n_layers)]
    shape = (cfg.n_layers, frames.shape[0], cfg.n_kv_heads, cache_capacity, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=cfg.param_dtype, device=enc.device),
            "v": torch.zeros(shape, dtype=cfg.param_dtype, device=enc.device),
            "cross_k": torch.stack([k for k, _ in kv]),
            "cross_v": torch.stack([v for _, v in kv]),
            "len": 0}


def decode_step(params, cfg, cache, tokens: torch.Tensor):
    """One decode step. tokens: (B, 1) → (logits (B, V) f32, the cache with
    this step's keys and values written in and ``len`` one more)."""
    x = params["emb"][tokens]
    clen = cache["len"]
    for i, lp in enumerate(L.unstack_layers(params["dec_layers"], cfg.n_layers)):
        att, _, _ = L.decode_attention_block(
            lp["attn"], L.rmsnorm(x, lp["attn_norm"]), cache["k"][i], cache["v"][i], clen,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
            rope_theta=cfg.rope_theta)
        h = _cross(cfg, lp, x + att, cache["cross_k"][i], cache["cross_v"][i])
        x = h + L.mlp_block(lp["mlp"], L.rmsnorm(h, lp["mlp_norm"]), "gelu")
    x = L.rmsnorm(x, params["final_norm"])
    logits = x[:, -1].float() @ params["emb"].float().T
    return logits, dict(cache, len=clen + 1)
