"""Multi-pod dry-run: prove the distribution config is coherent + roofline.

The port's copy of ``repro/launch/dryrun.py``.  For every (architecture ×
input shape × mesh) cell it runs the step function (train, prefill or
serve step) once on DTensors placed by the sharding table
(``models/sharding.py``), with every tensor a FakeTensor and the ranks a
fake process group of the mesh's size (256 or 512): nothing is allocated
and no device is used.  One rank (rank 0) traces; the mesh is symmetric.

What it records per cell, per device:

* ``flops_per_device``: the FLOPs of the local ops rank 0 dispatches (the
  products ``torch.utils.flop_counter`` knows), not of the logical ops —
  ``FlopCounterMode`` around DTensor ops counts the whole mesh's work;
* ``bytes_per_device_accessed``: the inputs and outputs of each local
  ``aten`` op that is not a view (every op unfused: XLA counts a fused
  loop's operands once);
* ``collective_by_kind``: calls and bytes (each collective's output, as
  JAX parses them from the HLO) from ``CommDebugMode``;
* ``device_mem_gib``: the peak that ``MemTracker`` saw, the placed
  parameters and optimizer state included;
* ``roofline_terms`` with an H100's constants.

JAX's layer probes (``corrected_vector``) are not needed: XLA counts a
``while`` body once, while the port's loops run eagerly and every layer,
microbatch and kv block is counted.  RWKV's time scan is a loop of local
ops, each counted, but the flop registry counts products only: the scan's
elementwise FLOPs are added analytically (:func:`rwkv_scan_flops`, the
port's ``_rwkv_wkv_correction``).  Other elementwise work is counted as
bytes only (ROADMAP Queue 3 records how these numbers differ from XLA's).

RWKV's train and prefill cells are traced with a time scan that runs only
its first n steps (each a few local ops on every rank, since the scan runs
per rank, ``sharding.per_rank_scan``; the rest of its output zeros made
from the rest of its inputs in a few ops): all of the step but the scan is
traced at the cell's own shapes and so with DTensor's own placements, and
the scan's steps are alike and local.  The counts are affine in n, and at
n = S the stand-in is the scan itself; a train step's microbatches are
alike too.  So :func:`trace_affine` traces the cell at n =
``SCAN_PROBE_STEPS`` (a train step at 2 and 3 microbatches of the cell's
rows) and solves for the cell: the FLOPs, bytes and collective calls and
bytes exactly, the peak by the same lines (an estimate).  This is the
move of JAX's layer probes (XLA counts a ``lax.scan`` body once;
``repro/launch/dryrun.py``), over the scan's steps.  The whole scan would
take hours: some 60 local ops a (position, layer, microbatch) in train,
each through the counting modes.

The hybrid family's train cells (Zamba2-7B: 81 layers, 16 or 8
microbatches a step) are solved over their microbatches and their depth,
as JAX's layer probes solve the hybrid (``corrected_vector`` with
``attn_every``): traced at 2 and 3 microbatches of the cell's rows and at
two depths of the cell's residue modulo ``attn_every`` (so that the shared
block's points grow by one with each ``attn_every`` layers: 9 and 15 of
Zamba2-7B's 81), whose layers are alike (stacked leaves, placed by their
trailing dims), and solved for the cell's m and depth.  Traced whole the 16 × 16 cell
took about 2,000 s on one CPU core, longer than ``CELL_TIMEOUT_S``; its
probes take about 130 s.  On 2 × 16 × 16 a single probe still does not
end within ``CELL_TIMEOUT_S`` (a trace of 3 layers and 2 microbatches ran
past 28 minutes): DTensor plans the redistributions of the SSD's
strided-shard specs on the 3-D mesh by a graph search, once per new spec
in a process, and that planning, not the layers, takes the time.

A cell that traces for more than ``CELL_TIMEOUT_S`` is recorded as failed.

Artifacts: ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --skip-existing
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
import traceback
from dataclasses import replace
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..configs import ARCH_IDS, SHAPES, cell_applicable, get_config, input_specs
from ..frontends.tensor import ShardedStep
from ..models import sharding as shd
from ..models.api import build_model, make_prefill_step, make_serve_step, make_train_step
from ..train.optimizer import AdamW, tree_leaves
from .mesh import PRODUCTION_MESHES, make_mesh

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

# NVIDIA H100 SXM (data sheet, dense, at its 700 W limit)
PEAK_FLOPS = 989e12          # bf16 FLOP/s on the tensor cores
HBM_BW = 3.35e12             # bytes/s
# bytes/s a GPU sends off its node: one ConnectX-7 NDR 400 Gb/s port per
# H100 in a DGX H100 (NVIDIA DGX H100 user guide); a 16 × 16 mesh spans 32
# such nodes.  Inside a node NVLink 4 gives 450 GB/s per direction.
LINK_BW = 50e9
#: seconds a cell may trace before it is recorded as failed: the slowest
#: cell traced for about 29 minutes on one CPU core (RWKV6-1.6B's train
#: step on 2 × 16 × 16, its probes one after another)
CELL_TIMEOUT_S = 1800
#: the time-scan steps at which trace_affine traces RWKV's cells
SCAN_PROBE_STEPS = (2, 4)


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks, this process rank 0, for the
    span of the block: collectives return at once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry-run makes its own fake process group; this process "
                           "already has one")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _bookkeeping_marked(flag: list):
    """``flag[0]`` true while DTensor moves a local tensor between
    placements (``redistribute_local_tensor``, reached from a DTensor op's
    argument and from ``redistribute``) or propagates an op's sharding on a
    cache miss (``propagate_op_sharding_non_cached``): the local ops run
    there are the moves' own (the fake world's all-to-all runs as an
    all-gather, a ``cat`` and chunks) or DTensor's bookkeeping (shard
    offsets by ``arange``, once per new shape in a process), not the
    step's."""
    import torch.distributed.tensor._dispatch as dispatch
    import torch.distributed.tensor._redistribute as redist
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    def marked(inner):
        def run(*args, **kwargs):
            outer, flag[0] = flag[0], True
            try:
                return inner(*args, **kwargs)
            finally:
                flag[0] = outer
        return run

    move = redist.redistribute_local_tensor
    owners = [(m, "redistribute_local_tensor", move) for m in (redist, dispatch)
              if getattr(m, "redistribute_local_tensor", None) is move]
    if hasattr(ShardingPropagator, "propagate_op_sharding_non_cached"):
        owners.append((ShardingPropagator, "propagate_op_sharding_non_cached",
                       ShardingPropagator.propagate_op_sharding_non_cached))
    for owner, name, inner in owners:
        setattr(owner, name, marked(inner))
    try:
        yield
    finally:
        for owner, name, inner in owners:
            setattr(owner, name, inner)


def _local_ops():
    """A dispatch mode that adds up the FLOPs and bytes of the local ops
    under it (DTensor ops are let through, to come back as local ops); the
    local ops of a redistribution (its collectives are counted) and of
    DTensor's bookkeeping are not counted."""
    from torch._guards import active_fake_mode
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode

    class LocalOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.registry = FlopCounterMode(display=False).flop_registry
            self.flops = 0
            self.bytes = 0
            self._entry = None
            self._moving = [False]
            self._marks = None

        def __enter__(self):
            self._entry = active_fake_mode()
            self._marks = _bookkeeping_marked(self._moving)
            self._marks.__enter__()
            return super().__enter__()

        def __exit__(self, *exc):
            try:
                return super().__exit__(*exc)
            finally:
                self._marks.__exit__(*exc)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if isinstance(func, torch._ops.HigherOrderOperator):
                return func(*args, **kwargs)
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **kwargs)
            if active_fake_mode() is not self._entry or self._moving[0]:
                return out  # DTensor's propagation on global shapes, a move, bookkeeping
            packet = func._overloadpacket
            if packet in self.registry:
                self.flops += int(self.registry[packet](*args, **kwargs, out_val=out))
            if func.namespace == "aten" and not func.is_view:
                flat = list(args) + list(kwargs.values()) + [out]
                self.bytes += sum(_nbytes(x) for x in flat)
            return out

    return LocalOps()


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0


def _mesh_name(shape: Sequence[int]) -> str:
    return "x".join(str(s) for s in shape)


def _on_meta(tree):
    """A tree of tensors (or specs) as meta-device tensors of their shapes
    and dtypes: nothing is allocated, and no op reads a value."""
    if isinstance(tree, dict):
        return {k: _on_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_meta(v) for v in tree)
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def param_shapes(model):
    """The parameter tree of ``model.init`` as FakeTensors: shapes and dtypes,
    nothing drawn or allocated (a ``meta`` device around ``init`` would
    still draw every random number)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return model.init(torch.Generator())


def trace_cell(cfg, shape_name: str, mesh_shape: Sequence[int], axes: Sequence[str], *,
               microbatch: Optional[int] = None, zero1: bool = True,
               batch_override: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Run one cell's step on a fake world of ``prod(mesh_shape)`` ranks:
    (flops, bytes, collective records and bytes by kind, peak memory) per
    device.  ``batch_override`` replaces the shape's batch specs (a cut
    cell, as ``chip_smoke.py`` runs one)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    t0 = time.perf_counter()
    with fake_world(math.prod(mesh_shape)):
        mesh = make_mesh(mesh_shape, axes, device="cpu")
        dmesh = shd.device_mesh(mesh)
        model = build_model(cfg)
        kind, specs = input_specs(cfg, shape_name)
        if batch_override is not None:
            specs = batch_override
        params = _on_meta(param_shapes(model))
        pspecs = shd.tree_param_specs(params, mesh)
        placed = shd.shard_tree(params, pspecs, dmesh)
        held = [t.to_local() for t in tree_leaves(placed)]
        args: Tuple[Any, ...]
        if kind == "train":
            sh = SHAPES[shape_name]
            m = microbatch
            if m is None:
                m = max(1, sh.global_batch // shd._dp_size(mesh))
            gspecs = shd.tree_grad_specs(params, pspecs, mesh)
            opt = AdamW()
            opt_state = opt.init(params)
            ospecs = shd.tree_opt_specs(opt_state, pspecs, mesh, zero1=zero1)
            opt_placed = shd.shard_tree(opt_state, ospecs, dmesh)
            step = ShardedStep(make_train_step(  # the constraint places the accumulator when m > 1
                model, shd.zero1_optimizer(opt, pspecs, ospecs, dmesh), microbatch=m,
                grad_constraint=lambda tree: shd.redistribute_tree(tree, gspecs, dmesh))[0],
                dmesh, {})  # called as lower_to_pjit's step is
            held += [t.to_local() for t in tree_leaves(opt_placed)]
            batch = _on_meta(specs)
            bspecs = shd.batch_specs({k: (v.shape, v.dtype) for k, v in batch.items()}, mesh)
            args = (placed, opt_placed, shd.shard_tree(batch, bspecs, dmesh))
        elif kind == "prefill":
            cap = SHAPES[shape_name].seq_len
            prefill = make_prefill_step(model, cap)

            def step(p, b):
                with shd.dtensor_scope(p):
                    out = prefill(p, b)
                    cache = out[1] if isinstance(out, tuple) else out
                    return shd.redistribute_tree(_as_dtensors(cache, dmesh),
                                                 shd.cache_specs(cache, mesh, cfg), dmesh)

            batch = _on_meta(specs)
            bspecs = shd.batch_specs({k: (v.shape, v.dtype) for k, v in batch.items()}, mesh)
            args = (placed, shd.shard_tree(batch, bspecs, dmesh))
        else:
            serve = make_serve_step(model)
            state = _on_meta(specs["state"])
            # the port's decode takes the cache length as a Python int: the
            # last position, where a step reads the whole cache
            state = _with_len(state, SHAPES[shape_name].seq_len - 1)
            sspecs = shd.cache_specs(state, mesh, cfg)
            tokens = _on_meta(specs["tokens"])
            tspec = shd.batch_specs({"tokens": (tokens.shape, tokens.dtype)}, mesh)

            def step(p, st, tok):
                with shd.dtensor_scope(p):
                    return serve(p, st, tok)

            args = (placed, shd.shard_tree(state, sspecs, dmesh),
                    shd.shard_tree({"tokens": tokens}, tspec, dmesh)["tokens"])
        t_place = time.perf_counter() - t0
        mem = MemTracker()
        mem.track_external(*held)
        comm = shd.comm_bytes()
        ops = _local_ops()
        with mem, comm, ops:
            step(*args)
        peak = mem.get_tracker_snapshot("peak")
        total = max((d.get("Total", 0) for d in peak.values()), default=0)
        return {"kind": kind, "flops": ops.flops, "bytes": ops.bytes,
                "collective_by_kind": comm.by_kind(), "collectives": comm.records,
                "peak_bytes": total, "place_s": t_place,
                "trace_s": time.perf_counter() - t0 - t_place}


def traced_affine(cfg, shape_name: str) -> bool:
    """Whether ``run_cell`` traces the cell through :func:`trace_affine`:
    RWKV's train and prefill cells (a time scan over S positions) and the
    hybrid family's train cells (its microbatches)."""
    kind = SHAPES[shape_name].kind
    return ((cfg.family == "rwkv" and kind in ("train", "prefill"))
            or (cfg.family == "hybrid" and kind == "train"))


@contextlib.contextmanager
def _scan_steps(n: int):
    """Within the block RWKV's time scan runs its first ``n`` steps and
    fills the rest of its output with zeros made from the rest of its
    inputs in a few ops (so every step's gradient is defined, as in the
    scan), stacked with them as the scan stacks its steps."""
    from ..models import ssm

    scan = ssm._wkv_scan

    def first_steps(r, k, v, w, u, st):
        steps = list(zip(*(t.unbind(1) for t in (r, k, v, w))))
        outs = []
        for rt, kt, vt, wt in steps[:n]:
            out, st = ssm._wkv_step(rt, kt, vt, wt, u, st)
            outs.append(out)
        if steps[n:]:
            rest = [torch.stack(list(x)) for x in zip(*steps[n:])]
            outs += list(((rest[0] + rest[1] + rest[2] + rest[3]) * 0).unbind(0))
        return torch.stack(outs, dim=1), st

    ssm._wkv_scan = first_steps
    try:
        yield
    finally:
        ssm._wkv_scan = scan


def _probe(cfg, shape, mesh_shape: Sequence[int], axes: Sequence[str],
           n: Optional[int], m: Optional[int], rows: Optional[int]) -> Dict[str, Any]:
    """One of :func:`trace_affine`'s traces of the cell of ``shape`` (a
    ``Shape``, registered in ``SHAPES`` here if a spawned process lacks
    it) for the model ``cfg`` (a probe's depth): RWKV's time scan cut to
    its first ``n`` steps (``None``: no scan to cut), a train step of ``m``
    microbatches of ``rows`` rows (``None``: the cell's own batch)."""
    shape_name = shape.name
    SHAPES.setdefault(shape_name, shape)
    _, specs = input_specs(cfg, shape_name)
    batch = specs
    if m is not None:
        batch = {k: torch.empty((rows * m,) + tuple(v.shape[1:]), dtype=v.dtype,
                                device="meta") for k, v in specs.items()}
    with _scan_steps(n) if n is not None else contextlib.nullcontext():
        return trace_cell(cfg, shape_name, mesh_shape, axes, microbatch=m,
                          batch_override=batch)


def trace_affine(cfg, shape_name: str, mesh_shape: Sequence[int],
                 axes: Sequence[str]) -> Dict[str, Any]:
    """``trace_cell``'s counts of a cell that :func:`traced_affine` names,
    solved from shorter traces (the module's docstring).  RWKV's time scan
    runs only ``SCAN_PROBE_STEPS`` = (n1, n2) of its S steps: a prefill's
    count is affine in n, f(S) = f(n1) + (f(n2) − f(n1))·(S − n1)/(n2 −
    n1).  A train step's m microbatches are alike, so its count is A + m·B
    + m·n·K: it is traced at (m, n) = (2, n1), (2, n2), (3, n1), each
    microbatch of the cell's rows, and solved for the cell's m and S.  The
    hybrid family's train step is A + m·B + L·C + m·L·D over its depth L
    on the cell's residue modulo ``attn_every``: traced at m = 2, 3 and L
    = L1, L1 + ``attn_every`` (``_hybrid_depths``) and solved for the
    cell's m and L.  So for the FLOPs, bytes and each collective kind's
    calls and bytes, and the peak (an estimate).  (RWKV's layers are not alike enough
    to probe: a layer's cost moves with the depth.)  The traces run at
    once, each in a process of its own (spawned, so each has its own fake
    world): the wall time is the longest trace's, which ``trace_s`` records."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from fractions import Fraction

    n1, n2 = SCAN_PROBE_STEPS
    kind, specs = input_specs(cfg, shape_name)
    s = next(iter(specs.values())).shape[1]
    scan = cfg.family == "rwkv"
    dp = math.prod(n for a, n in zip(axes, mesh_shape) if a in ("pod", "data"))
    b = next(iter(specs.values())).shape[0]
    m = max(1, b // dp)
    rows = b // m
    if kind == "train" and scan:
        probes = [(n1, 2), (n2, 2), (n1, 3)]

        def solve(f1, f2, f3):  # A + m·B + m·n·K
            k = Fraction(f2 - f1, 2 * (n2 - n1))
            return f1 + (m - 2) * (f3 - f1) + k * m * (s - n1)
    elif kind == "train":
        l1, l2 = _hybrid_depths(cfg)
        probes = [(None, 2, l1), (None, 3, l1), (None, 2, l2), (None, 3, l2)]

        def solve(a, b, c, e):  # A + m·B + L·C + m·L·D
            t = Fraction(cfg.n_layers - l1, l2 - l1)
            return a + (c - a) * t + (m - 2) * ((b - a) + ((e - c) - (b - a)) * t)
    else:
        probes = [(n1, None), (n2, None)]

        def solve(f1, f2):
            return f1 + Fraction(f2 - f1, n2 - n1) * (s - n1)

    calls = [(replace(cfg, n_layers=p[2]) if len(p) > 2 else cfg, SHAPES[shape_name],
              tuple(mesh_shape), tuple(axes), p[0], p[1], rows if p[1] else None)
             for p in probes]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(len(calls), mp_context=multiprocessing.get_context("spawn")) as pool:
        got = list(pool.map(_probe, *zip(*calls)))
    wall = time.perf_counter() - t0

    def exact(*fs):
        v = solve(*fs)
        if v.denominator != 1:
            raise ValueError(f"the counts {fs} are not affine in the scan's steps")
        return int(v)

    kinds = sorted(set().union(*(g["collective_by_kind"] for g in got)))
    by_kind = {k: {q: exact(*(g["collective_by_kind"].get(k, {}).get(q, 0) for g in got))
                   for q in ("calls", "bytes")} for k in kinds}
    return {"kind": kind, "flops": exact(*(g["flops"] for g in got)),
            "bytes": exact(*(g["bytes"] for g in got)), "collective_by_kind": by_kind,
            "collectives": None, "peak_bytes": int(solve(*(g["peak_bytes"] for g in got))),
            "place_s": max(g["place_s"] for g in got),
            "trace_s": wall - max(g["place_s"] for g in got),
            "method": (f"the time scan traced at {n1} and {n2} of its {s} steps"
                       + (" and 2, 3 microbatches" if kind == "train" else "")
                       + ", solved for the cell") if scan
                      else (f"the train step traced at 2 and 3 microbatches and {l1} and "
                            f"{l2} layers, solved for the cell's m and {cfg.n_layers} layers; "
                            "the peak an estimate")}


def _hybrid_depths(cfg) -> Tuple[int, int]:
    """The two depths ``trace_affine`` probes a hybrid train cell at: the
    least above ``attn_every`` on the cell's residue modulo ``attn_every``
    (two points of the shared block at least), and ``attn_every`` more."""
    k = cfg.attn_every
    l1 = k + (cfg.n_layers % k or k)
    return l1, l1 + k


def rwkv_scan_flops(cfg, shape_name: str, mesh_shape: Sequence[int],
                    axes: Sequence[str]) -> int:
    """The elementwise FLOPs per device of RWKV's wkv time scan, which the
    flop registry does not count (its product r·(s + u·kv) is counted): per
    token, layer and head kᵀv, u·kv, s + u·kv, w·s and + kv, 5 P² with
    P = 64; ×3 in train (backward ≈ 2 forwards), ×4 under remat.  Tokens
    are split over the data axes as ``batch_specs`` splits them, heads over
    "model" where they divide (the column-split r, k, v).  0 for other
    families."""
    if cfg.family != "rwkv":
        return 0
    sh = SHAPES[shape_name]
    size = dict(zip(axes, mesh_shape))
    dp, m = size.get("pod", 1) * size.get("data", 1), size.get("model", 1)
    b, s = sh.global_batch, 1 if sh.kind == "decode" else sh.seq_len
    if b % dp == 0 and b >= dp:
        b //= dp
    elif sh.kind != "decode" and s % dp == 0:
        s //= dp
    p = 64
    h = cfg.d_model // p
    heads = h // m if h % m == 0 else h
    factor = (4 if cfg.remat else 3) if sh.kind == "train" else 1
    return factor * 5 * b * s * cfg.n_layers * heads * p * p


def _with_len(state, n: int):
    if isinstance(state, dict) and "len" in state:
        return dict(state, len=n)
    return state


def _as_dtensors(tree, dmesh):
    """A prefill's cache leaves as DTensors (a leaf the step built as a plain
    tensor is the same on every rank: replicated)."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(tree, dict):
        return {k: _as_dtensors(v, dmesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_dtensors(v, dmesh) for v in tree)
    if isinstance(tree, torch.Tensor) and not isinstance(tree, DTensor):
        return DTensor.from_local(tree, dmesh, [Replicate()] * dmesh.ndim, run_check=False)
    return tree


def roofline_terms(vec, meta, seq, batch, chips):
    flops_dev, bytes_dev, coll_dev = [float(x) for x in vec]
    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    t_coll = coll_dev / LINK_BW
    dominant = max([("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)], key=lambda kv: kv[1])[0]
    n = meta["n_active_params"]
    if meta["kind"] == "train":
        model_flops = 6.0 * n * seq * batch
    elif meta["kind"] == "prefill":
        model_flops = 2.0 * n * seq * batch
    else:
        model_flops = 2.0 * n * batch
    model_flops_dev = model_flops / chips
    return {
        "flops_per_device": flops_dev,
        "bytes_per_device_accessed": bytes_dev,
        "collective_bytes_per_device": coll_dev,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_global": model_flops,
        "model_flops_per_device": model_flops_dev,
        "useful_fraction": (model_flops_dev / flops_dev) if flops_dev else 0.0,
        "roofline_fraction": (model_flops_dev / PEAK_FLOPS) /
                             max(t_compute, t_memory, t_coll)
                             if max(t_compute, t_memory, t_coll) > 0 else 0.0,
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False, save: bool = True,
             verbose: bool = True, out_dir: Path = ARTIFACTS) -> Dict[str, Any]:
    cfg = get_config(arch)
    mesh_shape, axes = PRODUCTION_MESHES[multi_pod]
    mesh_name = _mesh_name(mesh_shape)
    ok, reason = cell_applicable(cfg, shape_name)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "skipped": reason}
        if save:
            _save(rec, out_dir)
        if verbose:
            print(f"[dryrun] {arch} × {shape_name} × {mesh_name}: SKIP ({reason})")
        return rec

    trace = trace_affine if traced_affine(cfg, shape_name) else trace_cell
    got = trace(cfg, shape_name, mesh_shape, axes)
    chips = math.prod(mesh_shape)
    sh = SHAPES[shape_name]
    scan = rwkv_scan_flops(cfg, shape_name, mesh_shape, axes)
    rec = {"arch": arch, "shape": shape_name, "kind": got["kind"], "mesh": mesh_name,
           "chips": chips, "n_params": cfg.n_params(),
           "n_active_params": cfg.n_active_params(), "scan_flops_per_device": scan}
    coll = sum(v["bytes"] for v in got["collective_by_kind"].values())
    rec.update(roofline_terms((got["flops"] + scan, got["bytes"], coll), rec, sh.seq_len,
                              sh.global_batch, chips))
    rec["collective_by_kind"] = got["collective_by_kind"]
    rec["peak_bytes_per_device"] = got["peak_bytes"]
    rec["device_mem_gib"] = round(got["peak_bytes"] / 2 ** 30, 3)
    rec["place_s"] = round(got["place_s"], 1)
    rec["trace_s"] = round(got["trace_s"], 1)
    if "method" in got:
        rec["method"] = got["method"]
    if save:
        _save(rec, out_dir)
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} × {mesh_name}: OK "
              f"dev_mem={rec['device_mem_gib']}GiB dominant={rec['dominant']} "
              f"roofline={rec['roofline_fraction']:.3f} (trace {rec['trace_s']:.0f}s)")
        print(f"  per device: flops={rec['flops_per_device']:.4g} "
              f"bytes={rec['bytes_per_device_accessed']:.4g} "
              f"coll={rec['collective_bytes_per_device']:.4g} "
              f"{json.dumps(rec['collective_by_kind'])}")
    return rec


@contextlib.contextmanager
def _time_limit(seconds: int):
    """Raise ``TimeoutError`` in the block after ``seconds`` (main thread)."""
    import signal

    def fire(signum, frame):
        raise TimeoutError(f"the cell traced for more than {seconds} s")

    old = signal.signal(signal.SIGALRM, fire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _save(rec, out_dir: Path) -> None:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    (out_dir / name).write_text(json.dumps(rec, indent=2, default=str))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="every cell on both meshes")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", type=Path, default=ARTIFACTS)
    args = ap.parse_args(argv)

    meshes = [False, True] if args.all else [args.multi_pod]
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    failures = []
    for a, s in cells:
        for mp in meshes:
            mesh_name = _mesh_name(PRODUCTION_MESHES[mp][0])
            out = args.out / f"{a}__{s}__{mesh_name}.json"
            if args.skip_existing and out.exists():
                print(f"[dryrun] {a} × {s} × {mesh_name}: cached")
                continue
            try:
                with _time_limit(CELL_TIMEOUT_S):
                    run_cell(a, s, multi_pod=mp, out_dir=args.out)
            except Exception as e:  # a failed cell is recorded; the others still run
                failures.append((a, s, mesh_name, repr(e)))
                print(f"[dryrun] {a} × {s} × {mesh_name}: FAIL {e}")
                traceback.print_exc()
                _save({"arch": a, "shape": s, "mesh": mesh_name,
                       "failed": f"{type(e).__name__}: {e}"[:2000]}, args.out)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print("\nall requested dry-run cells OK")


if __name__ == "__main__":
    main()
