"""Plain PyTorch versions of the CUDA kernels.

Each function computes what its kernel computes, with ordinary torch
operators, on the same inputs and with the same output layout as the
wrapper in ``ops``: the CPU tests run these, and ``chip_smoke.py`` holds
every kernel against its plain version on the card.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from ..core.expr import AggSpec, Expr
from ..relational import runtime as rt


def segsum(data: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Rows of ``data`` (n, d) f32 summed by segment id (n,) i32 →
    (num_segments, d) f32; ids outside [0, num_segments) are dropped."""
    return rt.segment_sum(data, seg_ids, num_segments)


def cdist2(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared distances (n, k): ‖x‖² − 2·x@cᵀ + ‖c‖², in that expansion,
    the product a full-f32 ``torch.matmul`` (TF32 stays off)."""
    x2 = (x * x).sum(1, keepdim=True)
    c2 = (c * c).sum(1, keepdim=True).T
    return x2 - 2.0 * torch.matmul(x, c.T) + c2


def kmeans_step(x: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One k-means step: (sums (k, d) f32, counts (k,) f32) of the points
    ``x`` (n, d) over their nearest centroid in ``c`` (k, d); the argmin
    takes the first index on ties."""
    k = c.shape[0]
    labels = torch.argmin(cdist2(x, c), dim=1)
    return rt.segment_sum(x, labels, k), rt.segment_count(labels, k)


def fused_select_agg(table: rt.VecTable, pred: Expr,
                     aggs: Sequence[AggSpec]) -> Dict[str, torch.Tensor]:
    """Masked single-pass select + aggregate → {name: 0-dim tensor}; count
    is int32, empty min/max are ±inf."""
    return rt.aggr(rt.mask_select(table, pred), aggs)


def grouped_select_agg(table: rt.VecTable, pred: Optional[Expr], keys: Sequence[str],
                       aggs: Sequence[AggSpec], max_groups: int,
                       key_domains: Sequence[Tuple[int, int]],
                       num_buckets: int) -> rt.VecTable:
    """Predicate + dense-bucket grouped aggregation, compacted to
    ``max_groups`` rows in bucket (key) order."""
    return rt.group_agg_direct(table, keys, aggs, max_groups, key_domains,
                               num_buckets, pred=pred)


def grouped_join_agg(left: rt.VecTable, right: rt.VecTable, *,
                     left_on: Sequence[str], right_on: Sequence[str],
                     join_key_domains: Sequence[Tuple[int, int]],
                     join_num_buckets: int, keys: Sequence[str],
                     aggs: Sequence[AggSpec], max_groups: int,
                     key_domains: Sequence[Tuple[int, int]],
                     num_buckets: int, pred: Optional[Expr] = None) -> rt.VecTable:
    """Probe predicate + direct-table join + grouped aggregation."""
    return rt.fused_join_group_agg(
        left, right, left_on=left_on, right_on=right_on,
        join_key_domains=join_key_domains, join_num_buckets=join_num_buckets,
        keys=keys, aggs=aggs, max_groups=max_groups, key_domains=key_domains,
        num_buckets=num_buckets, pred=pred)


#: the masked-logit sentinel of the Pallas body (``flash_attention.py:25``)
NEG = -1.0e30


def attention_mask(s: int, causal: bool, window: Optional[int],
                   device: torch.device) -> torch.Tensor:
    """(s, s) bool: query row i may attend to key j (kpos ≤ qpos under
    ``causal``; kpos > qpos − window under ``window``)."""
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention as the Pallas kernel computes it: q (B, Hq, S, D),
    k, v (B, Hkv, S, D) → (B, Hq, S, D) in q's dtype.  q, k and v go to f32
    and q is scaled before the product; masked logits are −1e30, the
    softmax is f32, masked weights are 0, and a row with nothing unmasked
    gives 0."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qf = q.float() * scale
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    mask = attention_mask(s, causal, window, q.device)
    logits = torch.matmul(qf, kf.transpose(-1, -2)).masked_fill(~mask, NEG)
    p = torch.exp(logits - logits.amax(-1, keepdim=True)) * mask
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (torch.matmul(p, vf) / l).to(q.dtype)


def flash_attention_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: Optional[int] = None,
                          sm_scale: Optional[float] = None, block_k: int = 128,
                          p_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The tensor-core kernel's arithmetic in plain torch: q·kᵀ of the
    inputs as they are, summed in f32; the scale on the f32 logits; an f32
    online softmax over kv tiles of ``block_k`` (masked weights exactly 0,
    l summing the f32 weights); the weights rounded to ``p_dtype`` before
    the product with v, summed in f32; a row with nothing unmasked gives 0.
    Same shapes and result dtype as ``flash_attention``."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    mask = attention_mask(s, causal, window, q.device)
    m = torch.full((b, hq, s, 1), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, s, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, s, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, s, block_k):
        keep = mask[:, k0:k0 + block_k]
        x = (torch.matmul(qf, kf[:, :, k0:k0 + block_k].transpose(-1, -2)) * scale
             ).masked_fill(~keep, NEG)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(x - m_new) * keep
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(p_dtype).float(), vf[:, :, k0:k0 + block_k])
        m = m_new
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: Union[int, torch.Tensor], *,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """One query position against a (B, Hkv, S, D) cache of which the
    first ``cache_len`` positions are valid (an int, or one per batch row),
    in the grouped-head form: q (B, Hq, 1, D) → (B, Hq, 1, D).  Products
    accumulate in f32; the weights go to the cache's dtype before the
    second product."""
    b, hq, _, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, group, d)
    logits = torch.matmul(qg.float(), k_cache.float().transpose(-1, -2)) * scale
    pos = torch.arange(s, device=q.device)[None, None, None, :]
    if isinstance(cache_len, torch.Tensor):
        valid = pos < cache_len.to(q.device).reshape(-1, 1, 1, 1)
    else:  # a Python int is compared as a scalar: no copy to the device, no wait
        valid = pos < cache_len
    logits = logits.masked_fill(~valid, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(b, hq, 1, d).to(q.dtype)
