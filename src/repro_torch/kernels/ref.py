"""Plain PyTorch versions of the CUDA kernels.

Each function computes what its kernel computes, with ordinary torch
operators, on the same inputs and with the same output layout as the
wrapper in ``ops``: the CPU tests run these, and ``chip_smoke.py`` holds
every kernel against its plain version on the card.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ..core.expr import AggSpec, Expr
from ..relational import runtime as rt


def segsum(data: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Rows of ``data`` (n, d) f32 summed by segment id (n,) i32 →
    (num_segments, d) f32; ids outside [0, num_segments) are dropped."""
    return rt.segment_sum(data, seg_ids, num_segments)


#: the plain version of ``csrc/fixsum.cuh`` (the atomic routes' f32 sums
#: as integers, bit for bit), which the sorted tiers' segment sums run on
#: the card too
fixed_sum = rt.fixed_sum


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


class KmsTiling(NamedTuple):
    """How the tensor-core kernels (kmeans_step's ``kms_tc``, segsum's
    ``seg_tc``; ``csrc/onehot.cuh``) cut their work, which fixes the order
    of their sums: ``tile`` points per tile, cut among ``warps`` consumer
    warps; a grid of ``grid`` blocks, block b taking tiles b, b + grid, …;
    the blocks' partials added in groups of ``group``.  A kernel's own for a
    call come from ``ops.onehot_tiling``."""

    tile: int
    warps: int
    grid: int
    group: int


def tf32(v: torch.Tensor) -> torch.Tensor:
    """f32 ``v`` rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32`` does: add half a TF32 unit to the
    magnitude bits, clear the 13 bits below; infinities and NaN stay."""
    bits = v.float().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(v), rounded, v.float())


def tf32_trunc(v: torch.Tensor) -> torch.Tensor:
    """f32 ``v`` rounded toward zero to TF32 (the 13 low mantissa bits
    cleared): what an mma takes from an f32 operand it reads as TF32."""
    return (v.float().contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def tf32_points(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of the points as the kernel feeds them: hi = tf32(x), lo =
    x − hi passed as it is, so taken as TF32 rounded toward zero."""
    hi = tf32(x)
    return hi, tf32_trunc(x.float() - hi)


def tf32_split(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo), both TF32: hi = tf32(v), lo = tf32(v − hi) (the
    difference is exact in f32); hi + lo is v within one f32 unit of v
    (2^-23·|v|): the rest lies on v's grid with at most 12 significant bits."""
    hi = tf32(v)
    return hi, tf32(v.float() - hi)


def kmeans_norms(c: torch.Tensor) -> torch.Tensor:
    """‖c_j‖² (k,) f32 as the kernel forms it, an f32 fma per dimension in
    index order (emulated in f64), and +inf for every exact copy of an
    earlier centroid, which so never takes a point."""
    k, d = c.shape
    c64 = c.double()
    s = torch.zeros(k, dtype=torch.float64, device=c.device)
    for t in range(d):
        s = (c64[:, t] * c64[:, t] + s).float().double()
    copy = torch.tril((c[:, None, :] == c[None, :, :]).all(-1), -1).any(1)
    return torch.where(copy, torch.full_like(s, float("inf")), s).float()


def kmeans_labels_tiled(x: torch.Tensor, c: torch.Tensor, *, split: bool = True) -> torch.Tensor:
    """Each point's label as the tensor-core kernel picks it: the score
    ‖c_j‖² + x·(−2c_j), ‖c_j‖² first, then the product over 8 dimensions
    at a time in TF32, split three ways (x_lo·b_hi, x_hi·b_lo, x_hi·b_hi
    with b = −2c; ``tf32_points``, ``tf32_split``), summed in f32; the
    first minimum.  ``split=False`` takes one unsplit TF32 pass instead
    (what the kernel must not do)."""
    xs, cs = x.float(), c.float()
    b = -2.0 * cs
    xh, xl = tf32_points(xs)
    bh, bl = tf32_split(b)
    acc = kmeans_norms(cs)[None, :].expand(xs.shape[0], -1)
    for k0 in range(0, cs.shape[1], 8):
        s = slice(k0, k0 + 8)
        if split:
            acc = acc + xl[:, s] @ bh[:, s].T
            acc = acc + xh[:, s] @ bl[:, s].T
        acc = acc + xh[:, s] @ bh[:, s].T
    return torch.argmin(acc, dim=1)


def kmeans_step_tiled(x: torch.Tensor, c: torch.Tensor, tiling: KmsTiling, *,
                      split: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core kmeans_step's arithmetic in plain torch, in the
    order ``tiling`` gives: labels by ``kmeans_labels_tiled``, the sums by
    ``onehot_sums_tiled``.  Counts exact.  Same outputs as
    ``kmeans_step``."""
    k = c.shape[0]
    lab = kmeans_labels_tiled(x, c, split=split)
    return onehot_sums_tiled(x, lab, k, tiling), rt.segment_count(lab, k)


def segsum_tiled(data: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
                 tiling: KmsTiling) -> torch.Tensor:
    """The tensor-core segsum's (``seg_tc``) arithmetic in plain torch, in
    the order ``tiling`` gives: ``onehot_sums_tiled`` with the ids as
    labels, ids outside [0, num_segments) dropped.  Same output as
    ``segsum``."""
    ids = seg_ids.long()
    lab = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    return onehot_sums_tiled(data, lab, num_segments, tiling)


def onehot_sums_tiled(x: torch.Tensor, lab: torch.Tensor, k: int,
                      tiling: KmsTiling) -> torch.Tensor:
    """Rows of ``x`` (n, d) summed by label (n,) into (k, d) as the
    tensor-core kernels add them (``csrc/onehot.cuh``), a label k dropped:
    each warp's slice of each tile summed as one_hot·x_hi + one_hot·x_lo
    (``tf32_points``); each warp's slices added in tile order, a block's
    warps in order, the blocks in groups in order, then the groups in
    order."""
    n, d = x.shape
    kk = k + 1  # the dropped rows' label
    warps, grid, group = tiling.warps, tiling.grid, tiling.group
    per_warp = tiling.tile // warps
    its = max(1, -(-n // (tiling.tile * grid)))
    xh, xl = tf32_points(x.float())
    slot = torch.arange(n, device=x.device) // per_warp * kk + lab
    part = torch.zeros((its * grid * warps * kk, d), dtype=torch.float32, device=x.device)
    lo = torch.zeros_like(part)
    part.index_add_(0, slot, xh)
    lo.index_add_(0, slot, xl)
    part = (part + lo).view(its, grid, warps, kk, d)
    run = part[0]
    for i in range(1, its):
        run = run + part[i]
    blk = run[:, 0]
    for w in range(1, warps):
        blk = blk + run[:, w]
    groups = -(-grid // group)
    padded = torch.zeros((groups * group, kk, d), dtype=torch.float32, device=x.device)
    padded[:grid] = blk
    padded = padded.view(groups, group, kk, d)
    per_group = padded[:, 0]
    for m in range(1, group):
        per_group = per_group + padded[:, m]
    sums = per_group[0]
    for g in range(1, groups):
        sums = sums + per_group[g]
    return sums[:k]


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
