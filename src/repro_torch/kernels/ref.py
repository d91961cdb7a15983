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
