"""SPMD mesh backend on ``torch.distributed`` — the Modularis analogue.

The JAX package's ``backends/spmd.py`` is single-controller: one process
owns the mesh and ``shard_map`` runs a ``mesh.MeshExecute`` body once per
device.  This backend is multi-controller, as the paper's Modularis
backend (MPI) and PyTorch on GPUs are: every rank of the mesh runs the same
lowered plan, called with the same full sources, and the mesh instructions
become collectives between the ranks (ROADMAP Queue 3 lists the
divergence).

Value model on one rank (the local backend's, plus two wrappers):

  * a value outside a MeshExecute is whole and the same on every rank;
  * ``cf.Split(n)`` keeps this rank's chunk — the same contiguous rows as
    the ``local`` target's chunk ``r`` — as a :class:`Shard`;
  * ``cf.Broadcast`` marks its value :class:`Replica`: each rank passes it
    whole into the body;
  * a ``mesh.MeshExecute`` output is a :class:`Shard`, replicated where the
    body ends in a collective that leaves every rank the same value.

The collectives, per rank and in rank order:

  * ``mesh.AllReduce`` (``sum``/``min``/``max``, ``combine_aggs``) →
    ``dist.all_reduce`` with ``ReduceOp.SUM/MIN/MAX``;
  * ``mesh.AllGatherVec`` and ``cf.Merge`` → an all-gather into one table;
  * ``cf.TakeChunk(i)`` of a value not replicated → a broadcast from rank i;
  * ``cf.CombineChunks`` and ``rel.CombinePartials`` left outside the body
    (``collectives=False``) → an all-gather, then the ``local`` target's
    fold in rank order, so such a plan gives ``local``'s bits;
  * ``mesh.ExchangeByKey`` → JAX's histogram partition (key mod n as
    uint32, invalid rows to bucket n, a stable sort, ``per`` slots a
    destination) and ``dist.all_to_all_single`` with equal splits.

On a card, a gloo group takes the CUDA tensors as they are for all four
collectives (torch 2.11 on an H100, f32/i32/i64/bool; ``chip_smoke.py``
probes each and fails if one is refused): gloo's own CUDA path copies them
through host memory, so this backend stages nothing itself.  NCCL, which
does not place two ranks on one card, needs no change here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Set, Tuple

import torch

from ..core.passes.mesh_lower import LowerToMesh, PushCombineIntoMesh
from ..core.program import Program
from ..launch.mesh import Mesh
from ..relational import runtime as rt
from ..robust.inject import maybe_inject
from . import emit as base_emit
from .emit import EvalCtx, read_taps
from .local import _on

__all__ = ["SpmdBackend", "SpmdCompiled", "Collectives", "Shard", "Replica",
           "evaluate_spmd_program", "exchange_by_key", "CALLS", "SIZES", "reset_calls"]

#: the collectives of this module, by the name its counters use
OPS = ("all_reduce", "all_gather", "all_to_all", "broadcast")

#: collective calls issued by this process, per op, since :func:`reset_calls`
CALLS: Dict[str, int] = {}

#: the same calls by size: ``(op, shape, dtype, bytes)`` -> calls, in the
#: order first seen
SIZES: Dict[Tuple[str, Tuple[int, ...], str, int], int] = {}


def reset_calls() -> None:
    CALLS.clear()
    SIZES.clear()


class Collectives:
    """The collectives of one plan over one mesh, each counted in
    :data:`CALLS`.  A mesh of one rank runs no collective at all."""

    def __init__(self, mesh: Mesh) -> None:
        self.mesh = mesh
        self.n = mesh.size
        self.group = mesh.group
        self.ranks = mesh.ranks

    def _count(self, op: str, t: torch.Tensor) -> None:
        CALLS[op] = CALLS.get(op, 0) + 1
        key = (op, tuple(t.shape), str(t.dtype).removeprefix("torch."),
               t.numel() * t.element_size())
        SIZES[key] = SIZES.get(key, 0) + 1

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``t`` reduced over the mesh (``sum``, ``min`` or ``max``); a new
        tensor, ``t`` stays as it was."""
        if self.n == 1:
            return t.clone()
        import torch.distributed as dist

        self._count("all_reduce", t)
        red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}[op]
        buf = t.clone().reshape(-1)
        dist.all_reduce(buf, op=red, group=self.group)
        return buf.reshape(t.shape)

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t``, in rank order."""
        if self.n == 1:
            return [t]
        import torch.distributed as dist

        self._count("all_gather", t)
        src = t.contiguous().reshape(-1)
        bufs = [torch.empty_like(src) for _ in range(self.n)]
        dist.all_gather(bufs, src, group=self.group)
        return [b.reshape(t.shape) for b in bufs]

    def broadcast(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """Rank ``i``'s ``t`` on every rank."""
        if self.n == 1:
            return t
        import torch.distributed as dist

        self._count("broadcast", t)
        buf = (t.contiguous() if self.mesh.index == i
               else torch.empty(t.shape, dtype=t.dtype, device=t.device))
        dist.broadcast(buf, src=self.ranks[i], group=self.group)
        return buf

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s ``n`` equal row blocks exchanged: block ``j`` of the
        result is rank ``j``'s block for this rank."""
        if self.n == 1:
            return t
        import torch.distributed as dist

        self._count("all_to_all", t)
        out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
        dist.all_to_all_single(out, t.contiguous(), group=self.group)
        return out


# ---------------------------------------------------------------------------
# value model
# ---------------------------------------------------------------------------


@dataclass
class Shard:
    """This rank's chunk of a split ``Seq[n]`` value; ``replicated`` where
    every rank holds the same value (a collective's result)."""

    local: Any
    n: int
    replicated: bool = False


@dataclass
class Replica:
    """A ``cf.Broadcast`` value: passed whole into a MeshExecute body."""

    value: Any


@dataclass
class SpmdCtx(EvalCtx):
    """The evaluation context of a rank: the mesh, its axis and the plan's
    collectives."""

    comm: Optional[Collectives] = None
    #: tap keys of MeshExecute outputs, which count this rank's chunk and
    #: are summed over the mesh when the traced run ends
    shard_taps: Set[str] = field(default_factory=set)


def _tree_map(fn: Callable[[torch.Tensor], Any], v: Any) -> Any:
    """``fn`` applied to every tensor of a value tree (a tensor, a VecTable,
    a dict, a list or a tuple of them)."""
    if isinstance(v, rt.VecTable):
        return rt.VecTable({k: fn(a) for k, a in v.cols.items()}, fn(v.valid))
    if isinstance(v, dict):
        return {k: _tree_map(fn, a) for k, a in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_tree_map(fn, a) for a in v)
    return fn(v)


def _gather(comm: Collectives, v: Any) -> List[Any]:
    """Every rank's value ``v``, in rank order (one all-gather per tensor)."""
    if isinstance(v, rt.VecTable):
        cols = {k: comm.all_gather(a) for k, a in v.cols.items()}
        valid = comm.all_gather(v.valid)
        return [rt.VecTable({k: c[i] for k, c in cols.items()}, valid[i])
                for i in range(comm.n)]
    if isinstance(v, dict):
        parts = {k: comm.all_gather(a) for k, a in v.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(comm.n)]
    return comm.all_gather(v)


def _gathered(ctx: SpmdCtx, v: Any) -> List[Any]:
    if not isinstance(v, Shard):
        raise TypeError(f"spmd backend: expected a split value, got {type(v).__name__}")
    return _gather(ctx.comm, v.local)


# ---------------------------------------------------------------------------
# emitters
# ---------------------------------------------------------------------------

_SPMD_EMIT: Dict[str, Callable[..., List[Any]]] = {}


def spmd_emitter(opcode: str):
    def deco(fn):
        _SPMD_EMIT[opcode] = fn
        return fn
    return deco


@spmd_emitter("cf.Split")
def _split(ctx, ins, args):
    n = int(ins.param("n"))
    if n != ctx.comm.n:
        raise ValueError(f"cf.Split into {n} chunks on a mesh of {ctx.comm.n} ranks")
    return [Shard(base_emit._split_value(args[0], n)[ctx.mesh.index], n)]


@spmd_emitter("cf.Broadcast")
def _broadcast(ctx, ins, args):
    return [Replica(args[0])]


@spmd_emitter("cf.Merge")
def _merge(ctx, ins, args):
    return [base_emit._merge_value(_gathered(ctx, args[0]))]


@spmd_emitter("cf.TakeChunk")
def _take(ctx, ins, args):
    (v,) = args
    if isinstance(v, Replica):
        return [v.value]
    if not isinstance(v, Shard):
        raise TypeError(f"spmd backend: cf.TakeChunk of {type(v).__name__}")
    if v.replicated:
        return [v.local]
    i = int(ins.param("i", 0))
    return [_tree_map(lambda a: ctx.comm.broadcast(a, i), v.local)]


@spmd_emitter("cf.CombineChunks")
def _combine(ctx, ins, args):
    return base_emit._EMIT["cf.CombineChunks"](ctx, ins, [_gathered(ctx, args[0])])


@spmd_emitter("rel.CombinePartials")
def _combine_partials(ctx, ins, args):
    return base_emit._EMIT["rel.CombinePartials"](ctx, ins, [_gathered(ctx, args[0])])


#: body results that leave every rank the same value
_REPLICATING = ("mesh.AllReduce", "mesh.AllGatherVec")


@spmd_emitter("mesh.MeshExecute")
def _mesh_execute(ctx, ins, args):
    """Run the nested program on this rank's chunk."""
    p: Program = ins.param("P")
    axis = ins.param("axis", "workers")
    local, n = [], None
    for a in args:
        if isinstance(a, Shard):
            n = a.n if n is None else n
            local.append(a.local)
        elif isinstance(a, Replica):
            local.append(a.value)
        else:
            raise TypeError(f"spmd backend: MeshExecute input {type(a).__name__}")
    if n != ctx.comm.n:
        raise ValueError(f"MeshExecute over {n} chunks on a mesh of {ctx.comm.n} ranks")
    inner = SpmdCtx(sources=ctx.sources, use_kernels=ctx.use_kernels, device=ctx.device,
                    consts=ctx.consts, mesh=ctx.mesh, axis=axis, comm=ctx.comm)
    outs = evaluate_spmd_program(inner, p, *local)
    producers = p.producers()
    return [Shard(o, n, getattr(producers.get(r.name), "opcode", None) in _REPLICATING)
            for o, r in zip(outs, p.results)]


@spmd_emitter("mesh.AllReduce")
def _allreduce(ctx, ins, args):
    (x,) = args
    op = ins.param("op", "sum")
    if op == "combine_aggs":
        return [{a.name: ctx.comm.all_reduce(x[a.name], a.combine_fn)
                 for a in ins.param("aggs")}]
    return [_tree_map(lambda a: ctx.comm.all_reduce(a, op), x)]


@spmd_emitter("mesh.AllGatherVec")
def _allgather(ctx, ins, args):
    return [_tree_map(lambda a: torch.cat(ctx.comm.all_gather(a)), args[0])]


def exchange_slots(key: torch.Tensor, valid: torch.Tensor, n: int, per: int):
    """JAX's histogram partition of one rank's rows: destination ``key mod
    n`` (the key as uint32), invalid rows to bucket ``n``; rows in a stable
    sort by destination, each taking the next of its destination's ``per``
    slots.  Returns (order, slot of each sorted row — ``n·per`` for a row
    dropped — and whether it is kept)."""
    cap = key.shape[0]
    if key.is_floating_point():
        # XLA's float → uint32 saturates, NaN to 0
        k64 = torch.nan_to_num(key.to(torch.float64), nan=0.0).clamp(0, 2.0 ** 32 - 1)
        k64 = k64.to(torch.int64)
    else:
        k64 = key.to(torch.int64) & 0xFFFFFFFF
    dest = torch.where(valid, k64 % n, torch.full_like(k64, n))
    order = torch.argsort(dest, stable=True)
    sorted_dest = dest[order]
    start = torch.searchsorted(sorted_dest, torch.arange(n + 1, device=key.device))
    pos = torch.arange(cap, device=key.device) - start[sorted_dest]
    keep = (pos < per) & (sorted_dest < n)
    slot = torch.where(keep, sorted_dest * per + pos, torch.full_like(pos, n * per))
    return order, slot, keep


def exchange_by_key(comm: Collectives, v: rt.VecTable, key: str, n: int,
                    skew: float = 2.0) -> rt.VecTable:
    """Histogram partition + all-to-all: rows with equal keys land on the
    same rank (MPIHistogram + MPIExchange).  Block ``j`` of the result (of
    ``per`` rows) holds rank ``j``'s rows for this rank, in their order;
    a destination's rows past ``per`` are dropped, as in JAX."""
    per = int(v.capacity * skew) // n * n // n  # per-destination slots
    order, slot, keep = exchange_slots(v.cols[key], v.valid, n, per)

    def scatter(col, values):
        buf = torch.zeros((n * per + 1,), dtype=col.dtype, device=col.device)
        buf[slot] = values
        return comm.all_to_all(buf[:-1])

    cols = {k: scatter(a, a[order]) for k, a in v.cols.items()}
    return rt.VecTable(cols, scatter(v.valid, keep))


@spmd_emitter("mesh.ExchangeByKey")
def _exchange(ctx, ins, args):
    return [exchange_by_key(ctx.comm, args[0], ins.param("key"), int(ins.param("n")),
                            float(ins.param("skew", 2.0)))]


def evaluate_spmd_program(ctx: SpmdCtx, program: Program, *args: Any) -> List[Any]:
    """Run a lowered program on this rank: the mesh instructions as
    collectives, every other opcode through the local backend's emitter."""
    maybe_inject("spmd.shard", program=program.name)
    env: Dict[str, Any] = {r.name: v for r, v in zip(program.inputs, args)}
    for i, ins in enumerate(program.body):
        fn = _SPMD_EMIT.get(ins.opcode) or base_emit._EMIT.get(ins.opcode)
        if fn is None:
            raise NotImplementedError(f"spmd backend: no emitter for {ins.opcode}")
        ins_args = [env[r.name] for r in ins.inputs]
        outs = fn(ctx, ins, ins_args)
        if ctx.taps is not None:
            # top-level only: MeshExecute bodies run with a tap-free context;
            # an output tap counts this rank's chunk and is summed over the
            # mesh at the end, so every rank reports the whole table's rows
            # as the JAX package's stacked outputs do
            if ins.opcode == "mesh.MeshExecute":
                ctx.shard_taps.add(_tap_key(program, i, ins))
            base_emit.record_tap(ctx, program, i, ins, [_local(a) for a in ins_args],
                                 [_local(o) for o in outs])
        for r, v in zip(ins.outputs, outs):
            env[r.name] = v
    return [env[r.name] for r in program.results]


def _local(v: Any) -> Any:
    if isinstance(v, Shard):
        return v.local
    if isinstance(v, Replica):
        return v.value
    return v


def _tap_key(program: Program, index: int, ins: Any) -> str:
    from ..obs.feedback import tap_key

    return tap_key(program.name, index, ins.opcode, ins.outputs[0].name)


# ---------------------------------------------------------------------------
# backend facade
# ---------------------------------------------------------------------------


@dataclass
class SpmdCompiled:
    """A plan for one rank of ``mesh``: call it on every rank of the mesh
    with the same full sources; every rank returns the same result."""

    program: Program
    mesh: Mesh
    comm: Collectives
    use_kernels: bool = True
    #: the plan's constants on the device, filled at the first call
    consts: Dict[Any, Any] = field(default_factory=dict)

    def _run(self, sources: Optional[Mapping[str, Any]], args: Any,
             taps: Optional[Dict[str, List[Any]]]):
        if self.mesh.index is None:
            raise ValueError(f"this rank is not one of the mesh's ranks {self.mesh.ranks}")
        dev = rt.resolve_device(self.mesh.device)
        srcs = {k: _on(dev, v, f"source {k!r}") for k, v in dict(sources or {}).items()}
        ins = [_on(dev, a, f"input {i}") for i, a in enumerate(args)]
        ctx = SpmdCtx(sources=srcs, use_kernels=self.use_kernels, device=dev,
                      consts=self.consts, taps=taps, mesh=self.mesh, axis=self.mesh.axis,
                      comm=self.comm)
        outs = evaluate_spmd_program(ctx, self.program, *ins)
        # a split value left as a result comes back as its n chunks, in
        # rank order, as the local backend returns a Seq
        return [_gathered(ctx, o) if isinstance(o, Shard) else _local(o) for o in outs], ctx

    def __call__(self, sources: Optional[Mapping[str, Any]] = None, *args: Any) -> List[Any]:
        return self._run(sources, args, None)[0]

    def run_traced(self, sources: Optional[Mapping[str, Any]] = None, *args: Any):
        """Execute and measure: ``(results, {tap key → TapRecord}, {})``;
        the MeshExecute taps summed over the mesh with one all-reduce."""
        from ..obs.feedback import TapRecord

        taps: Dict[str, List[Any]] = {}
        outs, ctx = self._run(sources, args, taps)
        host = read_taps(taps)
        keys = sorted(k for k in ctx.shard_taps if k in host)
        if keys:
            rows = torch.tensor([[host[k][1] or 0, host[k][2]] for k in keys],
                                dtype=torch.int64, device=ctx.device)
            rows = self.comm.all_reduce(rows, "sum").tolist()
            for k, (ri, ro) in zip(keys, rows):
                host[k] = [host[k][0], None if host[k][1] is None else ri, ro]
        cards = {k: TapRecord(int(occ), None if ri is None else int(ri), int(ro))
                 for k, (occ, ri, ro) in host.items()}
        return outs, cards, {}


class SpmdBackend:
    """Compile a parallelized CVM program for one rank of a mesh."""

    name = "spmd"

    def __init__(self, mesh: Mesh, axis: str = "workers", use_kernels: bool = True,
                 collectives: bool = True, rewrite: bool = True) -> None:
        self.mesh = mesh
        self.axis = axis
        self.use_kernels = use_kernels
        self.collectives = collectives
        # standalone use still rewrites here; the compilation driver runs the
        # same rules as pipeline stages and passes rewrite=False
        self.rewrite = rewrite

    def compile(self, program: Program) -> SpmdCompiled:
        if self.rewrite:
            program = LowerToMesh(self.axis).apply(program)
            if self.collectives:
                program = PushCombineIntoMesh().apply(program)
        return SpmdCompiled(program, self.mesh, Collectives(self.mesh), self.use_kernels)
