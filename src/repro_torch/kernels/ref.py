"""Plain PyTorch versions of the CUDA kernels.

Each function computes what its kernel computes, with ordinary torch
operators, on the same inputs and with the same output layout as the
wrapper in ``ops``: the CPU tests run these, and ``chip_smoke.py`` holds
every kernel against its plain version on the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

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
