"""State-space / linear-recurrence blocks: Mamba2 (SSD) and RWKV6.

The port's copy of ``repro/models/ssm.py``.  Mamba2 uses the chunked SSD
algorithm: intra-chunk work is matmul-shaped and the inter-chunk state is
a short scan (here a loop over chunks).  RWKV6 ("Finch") has a
data-dependent decay with a time scan for the prompt (a loop over time
steps; on the card every step is a handful of small launches, so the
prompt's scan is the host's) and an O(1) recurrent state for decode.

Dtypes follow JAX's explicit casts, since torch would otherwise promote
``bf16 * f32`` to f32 where JAX keeps bf16: the SSD runs in f32 and
returns ``x``'s dtype; ``dt`` and ``D`` are cast to the activations' dtype
before they multiply them; the causal conv adds its K taps in JAX's order
in the parameters' dtype (no ``F.conv1d``, which sums in f32 and on the
card in TF32).  SiLU is ``F.silu`` (one rounding in bf16; ``jax.nn.silu``
rounds twice: ROADMAP Queue 3 item 27).  The leaves that JAX keeps f32
whatever the model's dtype (Mamba2's ``A_log``, ``D``, ``dt_bias``;
RWKV's ``w0``, ``u``) are made f32 here too (``convert.KEEP_F32`` carries
them so).  The f32 math (the SSD, ``dt``, the RWKV decays and scan)
runs in the wider of f32 and the input's dtype (``_math_dtype``), so an
f64 model on the card stays f64 where JAX, which has no f64 with x64 off,
would cast to f32 (ROADMAP Queue 3 item 28).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import layers as L
from .sharding import per_rank_mamba, per_rank_scan

#: Mamba2's head width, fixed as in JAX (``init_decode_state`` and
#: ``mamba2_block``'s default): d_inner / 64 SSM heads
MAMBA_HEAD = 64


def _math_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of the state math: f32 for bf16 and f32 inputs (JAX's
    ``astype(float32)``), f64 for f64 ones."""
    return torch.promote_types(dtype, torch.float32)


# ---------------------------------------------------------------------------
# Mamba2 / SSD
# ---------------------------------------------------------------------------


def init_mamba2(gen: torch.Generator, d_model: int, d_inner: int, ssm_state: int,
                d_head: int = MAMBA_HEAD, d_conv: int = 4, dtype: torch.dtype = torch.float32,
                lead: Tuple[int, ...] = ()) -> Dict[str, Any]:
    """One Mamba2 block's leaves (stacked on ``lead``): the projections
    drawn one leading index at a time (``stacked_init``: at Zamba2-7B's
    width one f32 draw of all 81 ``in_proj`` leaves would be 16.9 GB)."""
    h = d_inner // d_head
    dev = gen.device
    conv = torch.randn(lead + (d_conv, d_inner), generator=gen, device=dev) * 0.1
    return {
        # in_proj → [z (Di), x (Di), B (N), C (N), dt (H)]
        "in_proj": L.stacked_init(gen, lead, (d_model, 2 * d_inner + 2 * ssm_state + h), dtype),
        "conv_w": conv.to(dtype),
        "A_log": torch.zeros(lead + (h,), dtype=torch.float32, device=dev),
        "D": torch.ones(lead + (h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(lead + (h,), dtype=torch.float32, device=dev),
        "norm": torch.ones(lead + (d_inner,), dtype=dtype, device=dev),
        "out_proj": L.stacked_init(gen, lead, (d_inner, d_model), dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d. x: (B, S, Di); w: (K, Di); state: the last
    K − 1 inputs (B, K − 1, Di) or None (zeros).  Returns (silu(y), the new
    state, a copy: a view would keep the whole (B, S + K − 1, Di) input
    alive while a prefill holds every layer's state).  The taps add as
    JAX's ``sum``: 0 + x₀w₀ + x₁w₁ + …, each add in x's dtype."""
    k = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    new_state = xp[:, -(k - 1):].clone() if k > 1 else state
    return F.silu(y), new_state


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                chunk: int = 64, init_state: Optional[torch.Tensor] = None):
    """Chunked SSD. x: (B, S, H, P); a: (B, S, H) log-decay ≤ 0; Bm, Cm:
    (B, S, N).  Returns (y (B, S, H, P) in x's dtype, the final state
    (B, H, N, P) in the math dtype).

    The state math is f32 (f64 for f64 inputs).  ``Lmat`` masks the upper
    triangle of the (i, j) differences to −inf before its ``exp``: JAX's
    values (JAX takes ``exp`` of every difference, then masks to 0), but
    no inf where the decay overflows, whose gradient would be NaN (ROADMAP
    Queue 3).  The three-operand einsums may contract in another order
    than XLA's."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"ssd_chunked: sequence {s} is not a multiple of chunk {c}")
    nc = s // c
    cd = _math_dtype(x.dtype)
    xr = x.reshape(b, nc, c, h, p).to(cd)
    ar = a.reshape(b, nc, c, h).to(cd)
    Br = Bm.reshape(b, nc, c, n).to(cd)
    Cr = Cm.reshape(b, nc, c, n).to(cd)
    acum = torch.cumsum(ar, dim=2)                                   # (B,nc,c,H)

    # intra-chunk (matmul-shaped)
    diff = acum[:, :, :, None, :] - acum[:, :, None, :, :]           # (B,nc,c,c,H)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    Lmat = torch.exp(torch.where(mask[None, None, :, :, None], diff, -math.inf))
    scores = torch.einsum("bniN,bnjN->bnij", Cr, Br)                 # (B,nc,c,c)
    y_intra = torch.einsum("bnij,bnijh,bnjhp->bnihp", scores, Lmat, xr)

    # chunk boundary states
    decay_to_end = torch.exp(acum[:, :, -1:, :] - acum)              # (B,nc,c,H)
    states = torch.einsum("bnjN,bnjh,bnjhp->bnhNp", Br, decay_to_end, xr)  # (B,nc,H,N,P)
    chunk_decay = torch.exp(acum[:, :, -1, :])                       # (B,nc,H)

    st = (init_state.to(cd) if init_state is not None
          else torch.zeros((b, h, n, p), dtype=cd, device=x.device))
    prev = []                                                        # the state BEFORE each chunk
    for i in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                           # (B,nc,H,N,P)

    # inter-chunk contribution
    y_inter = torch.einsum("bniN,bnhNp,bnih->bnihp", Cr, prev_states, torch.exp(acum))
    y = (y_intra + y_inter).reshape(b, s, h, p).to(x.dtype)
    return y, st


def _mamba_mix(u: torch.Tensor, p, state, *, d_inner: int, ssm_state: int, d_head: int,
               chunk: int, heads: Optional[Tuple[int, int]] = None, norm=None):
    """Mamba2's mixer, from ``in_proj``'s output u (B, S, [z (Di), x (Di),
    B (N), C (N), dt (H)]) to the normed y (B, S, h·d_head) that meets
    ``out_proj``, and the new (conv, SSM) state: the causal conv, softplus(dt),
    the SSD, the D skip, the SiLU gate and the norm over d_inner.  ``p``
    holds the mixer's leaves (``conv_w``, ``A_log``, ``D``, ``dt_bias``,
    ``norm``) whole; ``heads`` = (first, h) mixes heads first … first + h − 1
    alone (all by default): their slices of z, x, dt and of the leaves, B
    and C whole.  ``norm(y, w)`` normalises (``L.rmsnorm`` by default).
    ``state`` = (conv (B, K − 1, h·d_head), SSM (B, h, N, d_head)) or None."""
    b, s, _ = u.shape
    n = ssm_state
    first, h = heads if heads is not None else (0, d_inner // d_head)
    c0, c1 = first * d_head, (first + h) * d_head
    dt0 = 2 * d_inner + 2 * n + first
    z, xs = u[..., c0:c1], u[..., d_inner + c0:d_inner + c1]
    Bm, Cm = u[..., 2 * d_inner:2 * d_inner + n], u[..., 2 * d_inner + n:2 * d_inner + 2 * n]
    dt = u[..., dt0:dt0 + h]
    conv_state = state[0] if state is not None else None
    xs, new_conv = _causal_conv(xs, p["conv_w"][..., c0:c1], conv_state)
    dt = F.softplus(dt.to(_math_dtype(u.dtype)) + p["dt_bias"][first:first + h])   # (B,S,h)
    A = -torch.exp(p["A_log"][first:first + h])                      # (h,) < 0
    a = dt * A                                                       # log-decay
    xh = xs.reshape(b, s, h, d_head) * dt[..., None].to(xs.dtype)
    ssm0 = state[1] if state is not None else None
    y, new_ssm = ssd_chunked(xh, a, Bm, Cm, chunk=chunk, init_state=ssm0)
    y = y + xh * p["D"][first:first + h].to(xh.dtype)[None, None, :, None]
    y = y.reshape(b, s, h * d_head) * F.silu(z)
    return (norm or L.rmsnorm)(y, p["norm"][c0:c1]), (new_conv, new_ssm)


def mamba2_block(p, x: torch.Tensor, *, d_inner: int, ssm_state: int,
                 d_head: int = MAMBA_HEAD, chunk: int = 64, state=None):
    """x: (B, S, D) → (y, (conv state, SSM state)); ``state`` = (conv
    state, SSM state) for decode, None for a prompt from zeros.  On
    DTensors the mixer runs per rank, each rank its own sequences and
    heads (``sharding.per_rank_mamba``)."""
    return per_rank_mamba(_mamba_mix, x, p, state, d_inner=d_inner, ssm_state=ssm_state,
                          d_head=d_head, chunk=chunk)


def mamba2_decode(p, x: torch.Tensor, state, *, d_inner: int, ssm_state: int,
                  d_head: int = MAMBA_HEAD):
    """Single-token recurrent step (S = 1): ``mamba2_block`` with
    chunk 1, as JAX defines it."""
    return mamba2_block(p, x, d_inner=d_inner, ssm_state=ssm_state, d_head=d_head,
                        chunk=1, state=state)


# ---------------------------------------------------------------------------
# RWKV6 (Finch)
# ---------------------------------------------------------------------------


def init_rwkv6(gen: torch.Generator, d_model: int, d_ff: int, d_head: int = 64,
               w_lora: int = 64, dtype: torch.dtype = torch.float32,
               lead: Tuple[int, ...] = ()) -> Dict[str, Any]:
    """One RWKV6 layer's leaves (stacked on ``lead``), in JAX's tree: the
    channel mix's ``cm_*`` leaves sit beside the time mix's."""
    h = d_model // d_head
    dev = gen.device

    def dense(shape, scale=None):
        return L.dense_init(gen, lead + shape, scale=scale, dtype=dtype)

    def uniform(shape):
        return (torch.rand(lead + shape, generator=gen, device=dev) * 0.5).to(dtype)

    return {
        "mu": uniform((5, d_model)),                                 # r, k, v, g, w
        "w0": torch.full(lead + (d_model,), -5.0, dtype=torch.float32, device=dev),
        "w1": dense((d_model, w_lora)),
        "w2": dense((w_lora, d_model), scale=0.01),
        "u": torch.randn(lead + (h, d_head), generator=gen, device=dev) * 0.1,
        "wr": dense((d_model, d_model)),
        "wk": dense((d_model, d_model)),
        "wv": dense((d_model, d_model)),
        "wg": dense((d_model, d_model)),
        "wo": dense((d_model, d_model)),
        "ln_x": torch.ones(lead + (d_model,), dtype=dtype, device=dev),
        # channel mix
        "cm_mu": uniform((2, d_model)),
        "cm_k": dense((d_model, d_ff)),
        "cm_v": dense((d_ff, d_model)),
        "cm_r": dense((d_model, d_model)),
    }


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shift the sequence right by one; ``last`` is the previous token (decode)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _wkv_step(rt, kt, vt, wt, u, st):
    """One step of RWKV6's wkv scan, JAX's ``scan_fn``: kv = kᵀv, out =
    r·(s + u·kv), s ← w·s + kv; rt, kt, vt, wt (B, H, P), st (B, H, P, P)."""
    kv = kt[..., None] * vt[..., None, :]                             # (B,H,P,P)
    return torch.einsum("bhp,bhpq->bhq", rt, st + u * kv), wt[..., None] * st + kv


def _wkv_scan(r, k, v, w, u, st):
    """RWKV6's wkv time scan: r, k, v, w (B, S, H, P), u (H, P, 1), the
    state st (B, H, P, P) → (out (B, S, H, P), the last state), a
    :func:`_wkv_step` a position.  One unbind per input: under autograd its
    backward stacks the S steps' gradients once, where x[:, t] would build
    a zero-filled gradient of the whole (B, S, H, P) input at every step
    (quadratic in S)."""
    outs = []
    for rt, kt, vt, wt in zip(*(t.unbind(1) for t in (r, k, v, w))):
        out, st = _wkv_step(rt, kt, vt, wt, u, st)
        outs.append(out)
    return torch.stack(outs, dim=1), st


def rwkv6_time_mix(p, x: torch.Tensor, *, d_head: int = 64, state=None):
    """x: (B, S, D) → (y, (last x (a copy, as in ``_causal_conv``), wkv
    state (B, H, P, P) in the math dtype)).  The time scan
    (:func:`_wkv_scan`) runs in f32 (f64 for f64 inputs); on DTensors each
    rank scans its own sequences and heads (``sharding.per_rank_scan``)."""
    b, s, d = x.shape
    h = d // d_head
    last_x = state[0] if state is not None else None
    xp = _token_shift(x, last_x)

    def mix(i):
        return x + p["mu"][i] * (xp - x)

    r = (mix(0) @ p["wr"]).reshape(b, s, h, d_head)
    k = (mix(1) @ p["wk"]).reshape(b, s, h, d_head)
    v = (mix(2) @ p["wv"]).reshape(b, s, h, d_head)
    g = F.silu(mix(3) @ p["wg"])
    cd = _math_dtype(x.dtype)
    w = p["w0"] + torch.tanh(mix(4) @ p["w1"]) @ p["w2"]            # (B,S,D) f32
    w = torch.exp(-torch.exp(w.to(cd))).reshape(b, s, h, d_head)     # decay ∈ (0, 1)

    st = (state[1] if state is not None
          else torch.zeros((b, h, d_head, d_head), dtype=cd, device=x.device))
    out, st = per_rank_scan(_wkv_scan, r.to(cd), k.to(cd), v.to(cd), w, p["u"][..., None], st)
    y = out.reshape(b, s, d).to(x.dtype)
    y = L.rmsnorm(y, p["ln_x"]) * g
    return y @ p["wo"], (x[:, -1:].clone(), st)


def rwkv6_channel_mix(p, x: torch.Tensor, state: Optional[torch.Tensor] = None):
    """x: (B, S, D) → (y, last x (a copy)); ``state`` is the previous
    token's x."""
    xp = _token_shift(x, state)
    xk = x + p["cm_mu"][0] * (xp - x)
    xr = x + p["cm_mu"][1] * (xp - x)
    k = torch.square(torch.relu(xk @ p["cm_k"]))
    return torch.sigmoid(xr @ p["cm_r"]) * (k @ p["cm_v"]), x[:, -1:].clone()


# ---------------------------------------------------------------------------
# RWKV6 full model
# ---------------------------------------------------------------------------


def init_rwkv_lm(cfg, gen: torch.Generator) -> Dict[str, Any]:
    dt = cfg.param_dtype
    dev = gen.device
    lead = (cfg.n_layers,)
    return {
        "emb": L.dense_init(gen, (cfg.vocab, cfg.d_model), scale=0.02, dtype=dt),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "layers": {
            "tm": init_rwkv6(gen, cfg.d_model, cfg.d_ff, dtype=dt, lead=lead),
            "tm_norm": torch.ones(lead + (cfg.d_model,), dtype=dt, device=dev),
            "cm_norm": torch.ones(lead + (cfg.d_model,), dtype=dt, device=dev),
        },
    }


def _rwkv_layer(lp, x, st_tm, st_cm):
    y, new_tm = rwkv6_time_mix(lp["tm"], L.rmsnorm(x, lp["tm_norm"]), state=st_tm)
    x = x + y
    # the channel mix reads its cm_* leaves from the time mix's dict, as JAX does
    y, new_cm = rwkv6_channel_mix(lp["tm"], L.rmsnorm(x, lp["cm_norm"]), state=st_cm)
    return x + y, new_tm, new_cm


def rwkv_backbone(params, cfg, x: torch.Tensor, state=None):
    """x: (B, S, D) → (the final-normed x, the new state ((last x (L, B, 1,
    D), wkv (L, B, H, P, P)), channel-mix last x (L, B, 1, D))); ``state``
    is such a tree, or None for a prompt from zeros.  With ``cfg.remat``
    and a gradient being recorded each layer runs under
    ``torch.utils.checkpoint``, as JAX's ``jax.checkpoint`` body."""
    layers = L.unstack_layers(params["layers"], cfg.n_layers)
    remat = cfg.remat and torch.is_grad_enabled()
    lx, wkv, cm = [], [], []
    for i, lp in enumerate(layers):
        st_tm = None if state is None else (state[0][0][i], state[0][1][i])
        st_cm = None if state is None else state[1][i]
        if remat:
            x, new_tm, new_cm = checkpoint(_rwkv_layer, lp, x, st_tm, st_cm, use_reentrant=False)
        else:
            x, new_tm, new_cm = _rwkv_layer(lp, x, st_tm, st_cm)
        lx.append(new_tm[0])
        wkv.append(new_tm[1])
        cm.append(new_cm)
    new_state = ((torch.stack(lx), torch.stack(wkv)), torch.stack(cm))
    return L.rmsnorm(x, params["final_norm"]), new_state


def rwkv_lm_loss(params, cfg, batch):
    from .lm import chunked_ce_loss

    x = params["emb"][batch["tokens"]]
    xf, _ = rwkv_backbone(params, cfg, x)
    return chunked_ce_loss(params, cfg, xf, batch["labels"], batch["mask"],
                           chunk=cfg.loss_chunk)


def rwkv_init_state(cfg, batch_size: int, device=None):
    """The empty recurrent state of ``rwkv_backbone`` (head width 64, as JAX)."""
    h = cfg.d_model // 64
    lt = cfg.n_layers
    tm = (torch.zeros((lt, batch_size, 1, cfg.d_model), dtype=cfg.param_dtype, device=device),
          torch.zeros((lt, batch_size, h, 64, 64), dtype=_math_dtype(cfg.param_dtype),
                      device=device))
    cm = torch.zeros((lt, batch_size, 1, cfg.d_model), dtype=cfg.param_dtype, device=device)
    return (tm, cm)


def _logits(params, xf):
    return xf[:, -1].float() @ params["emb"].float().T


def rwkv_decode_step(params, cfg, state, tokens):
    """tokens: (B, 1) → (logits (B, V), the new state). O(1) per token, no KV cache."""
    xf, new_state = rwkv_backbone(params, cfg, params["emb"][tokens], state=state)
    return _logits(params, xf), new_state


def rwkv_prefill(params, cfg, tokens):
    """The prompt in one pass: (last-position logits (B, V), the recurrent
    state: the constant-size 'cache' of an attention-free model)."""
    xf, state = rwkv_backbone(params, cfg, params["emb"][tokens])
    return _logits(params, xf), state
