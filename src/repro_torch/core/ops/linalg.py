"""Linear-algebra IR flavor.

The abstract LA types of the paper (Seq⟨Num⟩, 2DSeq⟨Num⟩, kDSeq⟨Num⟩) are
flavored here as ``Tensor`` collections — a kDSeq with static shape +
dtype.  High-level mathematical rewrites (e.g. (AB)ᵀ → BᵀAᵀ, matmul
re-association) happen on this flavor before lowering.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence, Tuple

from ..registry import op
from ..types import Atom, F32, I32, ItemType, Tensor, is_tensor, tensor_dtype, tensor_shape


def _t(x: ItemType) -> Tuple[Tuple[int, ...], Atom]:
    if not is_tensor(x):
        raise TypeError(f"expected Tensor, got {x.render()}")
    return tensor_shape(x), tensor_dtype(x)


def _broadcast(a: Tuple[int, ...], b: Tuple[int, ...]) -> Tuple[int, ...]:
    la, lb = len(a), len(b)
    n = max(la, lb)
    out = []
    for i in range(n):
        da = a[la - n + i] if la - n + i >= 0 else 1
        db = b[lb - n + i] if lb - n + i >= 0 else 1
        if da != db and 1 not in (da, db):
            raise TypeError(f"broadcast mismatch {a} vs {b}")
        out.append(max(da, db))
    return tuple(out)


@op("la.Literal", source=True)
def _literal(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """Literal(shape, dtype[, name]) — tensor source."""
    return [Tensor(params.get("dtype", F32), tuple(params["shape"]))]


@op("la.MMMult", elementwise=True)
def _mmmult(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """MMMult()(A: (m,k), B: (k,n)) → (m,n) — matrix-matrix multiplication."""
    (sa, da), (sb, db) = _t(ins[0]), _t(ins[1])
    if len(sa) != 2 or len(sb) != 2 or sa[1] != sb[0]:
        raise TypeError(f"MMMult shape mismatch {sa} @ {sb}")
    if da != db:
        raise TypeError("MMMult dtype mismatch")
    return [Tensor(da, (sa[0], sb[1]))]


@op("la.Transpose")
def _transpose(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    (s, d) = _t(ins[0])
    if len(s) != 2:
        raise TypeError("Transpose expects a matrix")
    return [Tensor(d, (s[1], s[0]))]


@op("la.Ewise", elementwise=True)
def _ewise(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """Ewise(op)(A[, B]) — broadcasting elementwise arithmetic."""
    (sa, da) = _t(ins[0])
    if len(ins) == 1:
        return [Tensor(da, sa)]
    (sb, db) = _t(ins[1])
    return [Tensor(da, _broadcast(sa, sb))]


@op("la.ReduceSum")
def _reducesum(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """ReduceSum(axis)(A) — sum along one axis."""
    (s, d) = _t(ins[0])
    ax = int(params["axis"]) % len(s)
    return [Tensor(d, tuple(x for i, x in enumerate(s) if i != ax))]


@op("la.CDist2", elementwise=True)
def _cdist2(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """CDist2()(X: (n,d), C: (k,d)) → (n,k) squared euclidean distances.

    The k-means hot loop; lowered to the expansion ‖x‖² − 2XCᵀ + ‖c‖²
    (the product in full f32 ``torch.matmul``).
    """
    (sx, dx), (sc, dc) = _t(ins[0]), _t(ins[1])
    if len(sx) != 2 or len(sc) != 2 or sx[1] != sc[1]:
        raise TypeError(f"CDist2 shape mismatch {sx} vs {sc}")
    return [Tensor(dx, (sx[0], sc[0]))]


@op("la.ArgMinRow", elementwise=True)
def _argminrow(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """ArgMinRow()(A: (n,k)) → (n,) i32 — index of the row-wise minimum."""
    (s, _) = _t(ins[0])
    if len(s) != 2:
        raise TypeError("ArgMinRow expects a matrix")
    return [Tensor(I32, (s[0],))]


@op("la.SegSum", aggregation={"kind": "segmented"})
def _segsum(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """SegSum(k)(X: (n,d), labels: (n,) i32) → (k,d) — sum rows by label.

    Decomposable: per-shard SegSum then elementwise sum of partials — the LA
    counterpart of the relational pre-aggregation rewrite.
    """
    (sx, dx) = _t(ins[0])
    (sl, dl) = _t(ins[1])
    if len(sx) != 2 or sl != (sx[0],):
        raise TypeError(f"SegSum shape mismatch {sx} vs labels {sl}")
    return [Tensor(dx, (int(params["k"]), sx[1]))]


@op("la.SegCount", aggregation={"kind": "segmented"})
def _segcount(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """SegCount(k)(labels: (n,) i32) → (k,) f32 — occurrences per label."""
    (sl, _) = _t(ins[0])
    return [Tensor(F32, (int(params["k"]),))]


@op("la.KMeansStep", aggregation={"kind": "segmented"})
def _kmeans_step(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """KMeansStep()(X: (n,d), C: (k,d)) → (sums: (k,d), counts: (k,)).

    Fused assignment + accumulation — the "run-based aggregation enabled by
    plan analysis" the paper credits for matching hand-written C++ k-means.
    Produced by the fusion rewrite from CDist2+ArgMinRow+SegSum+SegCount;
    lowered to the ``kmeans_step`` CUDA kernel under ``use_kernels``.
    """
    (sx, dx), (sc, dc) = _t(ins[0]), _t(ins[1])
    if len(sx) != 2 or len(sc) != 2 or sx[1] != sc[1]:
        raise TypeError("KMeansStep shape mismatch")
    k = sc[0]
    return [Tensor(dx, (k, sx[1])), Tensor(F32, (k,))]
