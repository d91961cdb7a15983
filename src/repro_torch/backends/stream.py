"""Streaming backend: micro-batched incremental execution of a split plan.

The port's copy of ``repro/backends/stream.py``.  ``StreamBackend.compile``
runs :func:`~repro_torch.core.passes.lower_stream.lower_stream` on the
lowered vec program and compiles each segment through the ordinary
:class:`~repro_torch.backends.local.LocalBackend` on the plan's device
(``cuda`` unless the caller names another), so the batch segment launches
the same kernels as the local target.  The resulting
:class:`StreamExecutable` exposes two faces:

* the **batch face** — ``executable(sources)`` folds the full stream table
  as a sequence of micro-batches and finalizes, so a stream plan is a
  drop-in :class:`~repro_torch.backends.local.Compiled` replacement: the
  driver's dispatch, the exec-guard fallback chain, and
  ``Context.execute`` all work unchanged, and the result is
  element-identical to the batch targets (the exactly-once oracle);
* the **incremental face** — ``bind(sources)`` → ``init_state()`` →
  ``step(state, batch)`` per micro-batch → ``finalize(state)`` on demand,
  which is what :class:`~repro_torch.launch.serve.StreamConsumer` drives,
  with ``state_to_tree``/``state_from_tree`` converting the carried
  accumulator to a plain dict of numpy arrays for
  :class:`~repro_torch.distributed.checkpoint.CheckpointManager`.

The carried state is the terminal aggregation's own output collection — a
``GroupAggDirect``/``GroupAggSorted`` grouped VecTable or an ``AggrVec``
scalar dict — and stays on the device between batches; the initial state
is the batch segment applied to an all-invalid batch, which yields the
aggregation identities (sum 0, count 0, min +inf, max −inf) with the exact
state structure for free.  Each micro-batch arrives from the host and is
copied to the device once (:meth:`StreamExecutable.as_batch`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Mapping, Optional

import numpy as np
import torch

from ..core.passes.lower_stream import StreamPlan, lower_stream
from ..core.program import Program
from ..relational import runtime as rt
from ..relational.runtime import VecTable
from .local import Compiled, LocalBackend

__all__ = ["StreamBackend", "StreamExecutable"]


def _host(v: torch.Tensor) -> np.ndarray:
    return v.detach().cpu().numpy()


@dataclass
class StreamExecutable:
    """A compiled stream plan: fold micro-batches, snapshot-able state."""

    program: Program                  # full lowered program (provenance)
    plan: StreamPlan
    stream_table: str
    batch_rows: int
    _static: Optional[Compiled]
    _batch: Compiled
    _merge: Compiled
    _finalize: Optional[Compiled]
    #: the device every segment runs on, as the caller named it
    device: Any = None
    #: boundary values from the one-shot static segment (build tables,
    #: encode dictionaries, ...), split per consuming segment
    _batch_args: Optional[List[Any]] = None
    _finalize_args: Optional[List[Any]] = None
    #: stream column dtypes, captured at bind() for empty/padded batches
    _schema: Optional[Dict[str, torch.dtype]] = None

    # -- the incremental face ------------------------------------------------

    def bind(self, sources: Mapping[str, Any]) -> "StreamExecutable":
        """Run the static segment once and capture the stream schema.

        ``sources`` must hold every non-stream table the plan scans plus
        the stream table itself (possibly with zero valid rows — only its
        column dtypes are read).  The static results — including join
        build tables — are carried across every subsequent micro-batch.
        """
        src = dict(sources)
        tmpl = src.get(self.stream_table)
        if tmpl is None:
            raise KeyError(
                f"bind() needs the stream table {self.stream_table!r} in "
                f"sources (its dtypes type the micro-batches); got "
                f"{sorted(src)}")
        self._schema = {k: v.dtype for k, v in tmpl.cols.items()}
        if self._static is not None:
            outs = self._static(src)
            by_name = {r.name: v for r, v in
                       zip(self.plan.static_program.results, outs)}
            self._batch_args = [by_name[r.name]
                                for r in self.plan.batch_boundary]
            self._finalize_args = [by_name[r.name]
                                   for r in self.plan.finalize_boundary]
        else:
            self._batch_args = []
            self._finalize_args = []
        return self

    def _require_bound(self) -> None:
        if self._batch_args is None:
            raise RuntimeError("StreamExecutable is unbound; call "
                               "bind(sources) before init_state/step")

    def empty_batch(self) -> VecTable:
        """An all-invalid micro-batch (the aggregation identity input)."""
        self._require_bound()
        n, dev = self.batch_rows, rt.resolve_device(self.device)
        return VecTable({k: torch.zeros((n,), dtype=dt, device=dev)
                         for k, dt in self._schema.items()},
                        torch.zeros((n,), dtype=torch.bool, device=dev))

    def as_batch(self, batch: Any) -> VecTable:
        """Coerce one micro-batch to a VecTable at batch capacity on the
        plan's device (a host batch is copied there once)."""
        if isinstance(batch, VecTable):
            if batch.capacity != self.batch_rows:
                batch = VecTable.from_numpy(batch.to_numpy(), self.batch_rows,
                                            device=self.device)
            return batch
        return VecTable.from_numpy(dict(batch), self.batch_rows, device=self.device)

    def init_state(self) -> Any:
        self._require_bound()
        (state,) = self._batch({self.stream_table: self.empty_batch()},
                               *self._batch_args)
        return state

    def step(self, state: Any, batch: Any) -> Any:
        """Fold one micro-batch into the carried state (pure)."""
        self._require_bound()
        vt = self.as_batch(batch)
        (delta,) = self._batch({self.stream_table: vt}, *self._batch_args)
        (merged,) = self._merge({}, state, delta)
        return merged

    def finalize(self, state: Any) -> List[Any]:
        """Answer the query from the current state (decode, avg, sort...)."""
        self._require_bound()
        if self._finalize is None:
            return [state]
        return self._finalize({}, state, *self._finalize_args)

    # -- snapshot conversion (stable tree paths for the checkpointer) -------

    def state_to_tree(self, state: Any) -> Dict[str, Any]:
        """The state as numpy leaves on the host: what the checkpointer
        writes, the same tree the JAX package's executable gives."""
        if self.plan.state_kind == "grouped":
            return {"cols": {k: _host(v) for k, v in state.cols.items()},
                    "valid": _host(state.valid)}
        return {k: _host(v) for k, v in state.items()}

    def state_from_tree(self, tree: Mapping[str, Any]) -> Any:
        """A restored tree back on the plan's device."""
        dev = rt.resolve_device(self.device)

        def put(v: Any) -> torch.Tensor:
            return torch.as_tensor(np.asarray(v), device=dev)

        if self.plan.state_kind == "grouped":
            return VecTable({k: put(v) for k, v in tree["cols"].items()},
                            put(tree["valid"]))
        return {k: put(v) for k, v in tree.items()}

    # -- the batch face ------------------------------------------------------

    def batches_of(self, table: VecTable) -> Iterator[Dict[str, np.ndarray]]:
        """Split a full table's valid rows into micro-batch column dicts
        (on the host, as an upstream log delivers them)."""
        rows = table.to_numpy()
        n = len(next(iter(rows.values()))) if rows else 0
        for lo in range(0, n, self.batch_rows):
            yield {k: v[lo:lo + self.batch_rows] for k, v in rows.items()}
        if n == 0:
            yield {k: v[:0] for k, v in rows.items()}

    def __call__(self, sources: Optional[Mapping[str, Any]] = None,
                 *args: Any) -> List[Any]:
        src = dict(sources or {})
        self.bind(src)
        state = self.init_state()
        for batch in self.batches_of(src[self.stream_table]):
            state = self.step(state, batch)
        return self.finalize(state)


class StreamBackend:
    name = "stream"

    def __init__(self, opts: Any) -> None:
        self.opts = opts

    def compile(self, program: Program) -> StreamExecutable:
        stream_table = self.opts.stream_table
        if not stream_table:
            raise ValueError(
                "the stream target needs stream_table=... (the table "
                "delivered as micro-batches)")
        batch_rows = int(self.opts.batch_rows or 256)
        plan = lower_stream(program, stream_table)
        local = LocalBackend(use_kernels=self.opts.use_kernels,
                             device=self.opts.device)
        return StreamExecutable(
            program=program,
            plan=plan,
            stream_table=stream_table,
            batch_rows=batch_rows,
            _static=(local.compile(plan.static_program)
                     if plan.static_program is not None else None),
            _batch=local.compile(plan.batch_program),
            _merge=local.compile(plan.merge_program),
            _finalize=(local.compile(plan.finalize_program)
                       if plan.finalize_program is not None else None),
            device=self.opts.device,
        )
