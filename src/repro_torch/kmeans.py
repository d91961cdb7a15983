"""k-means workload (paper Fig. 2 right): data, program, numpy f64 reference.

* ``make_data`` makes points and initial centroids as ``examples/kmeans.py``
  does: centres N(0, 5), points centre + N(0, 1), centroids k random points.
* ``program`` builds the step a frontend emits (CDist2 → ArgMinRow → SegSum
  + SegCount), optionally fused and split over the points.
* ``reference_step`` is an f64 step in numpy, with what the tie-margin rule
  needs; ``check_step`` holds a step's (sums, counts) against it.

The tie-margin rule.  A point is *ambiguous* when the f64 d² of some other
centroid j lies within ``TIE``·d·2^-23·(‖x‖² + max(‖c_a‖², ‖c_j‖²)) of its
nearest centroid a's: a few times the f32 rounding of the expansion
‖x‖² − 2·x·c + ‖c‖², so two f32 versions may label it differently.  Exact
copies of a centroid are no tie: every version computes the same d² for
them and keeps the lowest index.  An ambiguous point is a *candidate* of a
and of every such j.  Whatever the ties, the counts add up to n and the sums
over all centroids to Σx; and each centroid's count may differ by at most
its candidates, the counts together by at most twice the ambiguous points,
and each sum by the rounding of f32 sums in another order plus Σ|x| over
its candidates.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

#: the tie margin, in units of d·2^-23·(‖x‖² + ‖c‖²)
TIE = 8
#: of Σ|x| over a centroid: the f32 rounding of a sum in another order
SUM_ABS = 1e-5
#: rows per chunk of the reference step
CHUNK_ROWS = 1 << 20


def make_data(n: int, d: int, k: int, seed: int):
    """Points (n, d) and initial centroids (k, d), f32, as
    ``examples/kmeans.py`` makes them."""
    rng = np.random.default_rng(seed)
    true_centers = rng.normal(0, 5, (k, d)).astype(np.float32)
    x = (true_centers[rng.integers(0, k, n)] + rng.normal(0, 1, (n, d))).astype(np.float32)
    return x, x[rng.choice(n, k, replace=False)]


def near_ties(k: int, pairs: int, spread: int, seed: int):
    """Adversarial d = 1 data for the tensor-core kernel's TF32 split:
    ``k`` centroids in [4, 8) whose 13 low mantissa bits lie within a few
    units of half a TF32 unit (so TF32 rounding errs by nearly its most and
    the rest is as large as it gets), and, for ``pairs`` pairs of them that
    share bit 13 (so their midpoint's low bits lie near half a unit too),
    the ``2·spread + 1`` consecutive f32 values around the midpoint: points
    whose two nearest scores differ by a few f32 units.  Returns (x
    (pairs·(2·spread + 1), 1), c (k, 1)), f32."""
    rng = np.random.default_rng(seed)
    bits = rng.uniform(4.0, 8.0, k).astype(np.float32).view(np.int32)
    bits = (bits & ~0x1FFF) | (0x1000 + rng.integers(-3, 4, k)).astype(np.int32)
    c = bits.view(np.float32)
    side = (bits >> 13) & 1
    a = rng.integers(0, k, 4 * pairs)
    b = rng.integers(0, k, 4 * pairs)
    keep = (side[a] == side[b]) & (a != b)
    a, b = a[keep][:pairs], b[keep][:pairs]
    mid = ((c[a].astype(np.float64) + c[b]) / 2).astype(np.float32)
    steps = np.arange(-spread, spread + 1, dtype=np.int32)
    x = (mid.view(np.int32)[:, None] + steps[None, :]).view(np.float32)
    return x.reshape(-1, 1), c.reshape(-1, 1)


def program(n: int, d: int, k: int, parallel: int = 0):
    """The k-means step over X (n, d) and C (k, d); ``parallel`` > 0 adds
    ``FuseKMeansStep`` and ``Parallelize`` over X into that many chunks."""
    from .core import Builder, verify
    from .core.passes import FuseKMeansStep, Parallelize
    from .core.types import F32, Tensor

    b = Builder("kmeans_iter")
    xr = b.input("X", Tensor(F32, (n, d)))
    cr = b.input("C", Tensor(F32, (k, d)))
    lab = b.emit1("la.ArgMinRow", [b.emit1("la.CDist2", [xr, cr])])
    prog = b.finish(b.emit1("la.SegSum", [xr, lab], {"k": k}),
                    b.emit1("la.SegCount", [lab], {"k": k}))
    if parallel:
        prog = FuseKMeansStep().apply(prog)
        prog = Parallelize(n=parallel, targets={xr.name}).apply(prog)
    verify(prog)
    return prog


class Reference(NamedTuple):
    """An f64 step and its tie margins; per centroid unless said."""

    sums: np.ndarray       # (k, d)
    counts: np.ndarray     # (k,)
    abs_sums: np.ndarray   # (k, d) Σ|x| over the centroid's points
    cand: np.ndarray       # (k,) ambiguous points that are its candidates
    cand_abs: np.ndarray   # (k, d) Σ|x| over those
    n_amb: int             # ambiguous points
    n: int                 # points


def reference_step(x: np.ndarray, c: np.ndarray, map=map) -> Reference:
    """An f64 k-means step from centroids ``c``, in chunks of CHUNK_ROWS rows
    with ``np.bincount`` weighted per dimension; ``map`` may be a pool's."""
    k, d = c.shape
    c64 = c.astype(np.float64)
    cn = (c64 * c64).sum(1)
    _, first = np.unique(c64, axis=0, return_index=True)
    copies = np.setdiff1d(np.arange(k), first)

    def chunk(lo):
        xs = x[lo:lo + CHUNK_ROWS].astype(np.float64)
        rows = np.arange(len(xs))
        x2 = (xs * xs).sum(1)
        d2 = x2[:, None] - 2.0 * (xs @ c64.T) + cn[None, :]
        d2[:, copies] = np.inf
        lab = d2.argmin(1)
        gap = d2 - d2[rows, lab][:, None]
        gap[rows, lab] = np.inf
        margin = TIE * d * 2.0 ** -23 * (x2[:, None] + np.maximum(cn[lab][:, None], cn[None, :]))
        near = gap < margin
        amb = near.any(1)
        near[rows, lab] = True
        near &= amb[:, None]
        ax = np.abs(xs)
        return (np.stack([np.bincount(lab, xs[:, t], k) for t in range(d)], 1),
                np.bincount(lab, minlength=k).astype(np.float64),
                np.stack([np.bincount(lab, ax[:, t], k) for t in range(d)], 1),
                near.sum(0).astype(np.float64), near.T.astype(np.float64) @ ax,
                int(amb.sum()))

    parts = list(map(chunk, range(0, len(x), CHUNK_ROWS)))
    return Reference(*(sum(p[i] for p in parts) for i in range(6)), n=len(x))


def check_step(what: str, got, want, ref: Reference, rtol: float) -> float:
    """Hold (sums, counts) ``got`` against ``want`` (another version's, or
    ``ref``'s own) by the tie-margin rule (module docstring), both from the
    points and centroids of ``ref``.  Raises AssertionError; returns the
    largest absolute difference of a sum."""
    (gs, gc), (ws, wc) = [[np.asarray(v.cpu() if hasattr(v, "cpu") else v, np.float64)
                           for v in pair] for pair in (got, want)]
    if gs.shape != ws.shape or gc.shape != wc.shape or ws.shape != ref.sums.shape:
        raise AssertionError(f"{what}: shapes {gs.shape}, {gc.shape} vs {ws.shape}, {wc.shape}")
    total, total_abs = ref.sums.sum(0), ref.abs_sums.sum(0)
    for side, s, cnt in (("got", gs, gc), ("want", ws, wc)):
        if cnt.sum() != ref.n:
            raise AssertionError(f"{what}: {side} counts add up to {cnt.sum()}, not {ref.n}")
        off = np.abs(s.sum(0) - total)
        if not np.all(off <= SUM_ABS * total_abs):
            raise AssertionError(f"{what}: {side} sums add up to Σx ± {off.max()}")
    dc = np.abs(gc - wc)
    if dc.sum() > 2 * ref.n_amb or not np.all(dc <= ref.cand):
        raise AssertionError(f"{what}: counts differ by {dc.tolist()} (in all {dc.sum()}), "
                             f"with {ref.n_amb} ambiguous points, {ref.cand.tolist()} "
                             "candidates per centroid")
    err = np.abs(gs - ws)
    tol = rtol * np.abs(ws) + SUM_ABS * ref.abs_sums + ref.cand_abs
    if not np.all(err <= tol):
        raise AssertionError(f"{what}: sums differ by up to {err.max()} "
                             f"(worst over tolerance {(err - tol).max()})")
    return float(err.max())


def loop_program(n: int, d: int, k: int, steps: int, parallel: int = 0):
    """``steps`` k-means iterations as one ``cf.Loop`` over the centroids C
    (k, d).  The body reads the points X (n, d) as the source ``"X"``
    (``la.Literal(name="X")``), runs the step of :func:`program` and returns
    the updated centroids Transpose(Transpose(sums) / (counts + 1e-9)).
    ``parallel`` > 0 adds ``FuseKMeansStep`` and ``Parallelize`` over X to
    the loop body.  Call it as ``compiled({"X": x}, c)``."""
    from .core import Builder, subprogram, verify
    from .core.passes import FuseKMeansStep, Parallelize
    from .core.types import F32, Tensor

    tc = Tensor(F32, (k, d))
    names = {}

    def step(b, regs):
        (cr,) = regs
        xr = b.emit1("la.Literal", [], {"name": "X", "shape": (n, d), "dtype": F32})
        names["X"] = xr.name
        lab = b.emit1("la.ArgMinRow", [b.emit1("la.CDist2", [xr, cr])])
        sums = b.emit1("la.SegSum", [xr, lab], {"k": k})
        counts = b.emit1("la.SegCount", [lab], {"k": k})
        eps = b.emit1("la.Literal", [], {"value": 1e-9, "shape": (), "dtype": F32})
        denom = b.emit1("la.Ewise", [counts, eps], {"op": "add"})
        mean = b.emit1("la.Ewise", [b.emit1("la.Transpose", [sums]), denom], {"op": "div"})
        return [b.emit1("la.Transpose", [mean])]

    body = subprogram("kmeans_body", [("C", tc)], step)
    b = Builder("kmeans_loop")
    prog = b.finish(*b.emit("cf.Loop", [b.input("C", tc)], {"n": steps, "P": body}))
    if parallel:
        # FuseKMeansStep recurses into the loop body; Parallelize does not
        # (``recurse = False``), so it is applied to the body itself
        split = Parallelize(n=parallel, targets={names["X"]})
        prog = FuseKMeansStep().apply(prog).map_instructions(
            lambda ins: [ins.map_nested(split.apply)])
    verify(prog)
    return prog
