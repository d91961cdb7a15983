"""Meshes of ranks for the ``spmd`` and ``multipod`` targets.

The JAX package's mesh (``repro/launch/mesh.py``) is a grid of devices that
one controller owns; ``shard_map`` runs a body once per device.  The port is
multi-controller, PyTorch's idiom on GPUs and the paper's Modularis backend
(MPI): one process per rank, each running the same plan on its own chunk,
with ``torch.distributed`` collectives between them.  A :class:`Mesh` names
the ranks that take part, the process group they talk over, the axis name
the lowered program uses, and the device this rank computes on.

A function builds it, so importing this module touches no process group.
``make_production_mesh`` lays out the production target, 256 ranks
(16 × 16, ``data`` × ``model``) or two pods of them (2 × 16 × 16, the
``pod`` axis first), over the world that ``launch/dryrun.py`` fakes.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

__all__ = ["Mesh", "make_mesh", "make_production_mesh", "subgroup", "world_size",
           "resolve_rank_device", "PRODUCTION_MESHES"]

#: (shape, axes) of the production mesh, keyed by ``multi_pod``
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclass(frozen=True, eq=False)
class Mesh:
    """Ranks of one process group laid out along named axes.

    ``group`` is ``None`` for a mesh of one rank that needs no process
    group (the ``parallel=None``/``1`` plans); ``ranks`` are global ranks in
    mesh order; ``device`` is where this rank computes."""

    group: Any
    ranks: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    device: torch.device
    #: the group's backend (``gloo``, ``nccl``), ``None`` without a group
    backend: Optional[str] = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def axis(self) -> str:
        return self.axis_names[0]

    @property
    def index(self) -> Optional[int]:
        """This process's position along the mesh, ``None`` outside it."""
        import torch.distributed as dist

        if self.group is None or not dist.is_initialized():
            return 0
        me = dist.get_rank()
        return self.ranks.index(me) if me in self.ranks else None

    def key(self) -> Tuple:
        """What a plan compiled for this mesh depends on: an equally shaped
        mesh over other ranks, another backend or device is another plan."""
        return (self.axis_names, self.shape, self.ranks, self.backend, str(self.device))


def world_size() -> int:
    """Ranks of the default process group; 1 where none is initialised."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def resolve_rank_device(device: Any = None) -> torch.device:
    """This rank's device: ``cuda`` (the default) becomes
    ``cuda:{LOCAL_RANK % device_count()}``, so ranks on one card share it and
    ranks on as many cards take one each.  Where no card is visible the
    name stays unresolved and the plan raises ``NoCardError`` when it runs."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


#: sub-groups made by :func:`make_mesh`, one per tuple of ranks: every rank
#: of the world makes each once, in the same order (``dist.new_group`` is a
#: collective call over the whole world)
_SUBGROUPS: Dict[Tuple[int, ...], Any] = {}


def subgroup(ranks: Sequence[int]) -> Any:
    """The process group over ``ranks``, made once per process.  Every rank
    of the world must call this for the same ranks in the same order."""
    import torch.distributed as dist

    ranks = tuple(int(r) for r in ranks)
    if ranks == tuple(range(dist.get_world_size())):
        return dist.group.WORLD
    got = _SUBGROUPS.get(ranks)
    if got is None:
        got = _SUBGROUPS[ranks] = dist.new_group(list(ranks))
    return got


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, group: Any = None,
              device: Any = None) -> Mesh:
    """A mesh of ``prod(shape)`` ranks named by ``axes``.

    Over ``group`` when given (its size must match), else over the first
    ``prod(shape)`` ranks of the initialised default group (a sub-group when
    fewer than the world, made collectively by every rank).  A mesh of one
    rank needs no process group.  Raises ``ValueError`` where there are too
    few ranks, rather than waiting in a rendezvous."""
    import torch.distributed as dist

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    n = math.prod(shape)
    dev = resolve_rank_device(device)
    if group is not None:
        ranks = tuple(dist.get_process_group_ranks(group))
        if len(ranks) != n:
            raise ValueError(f"a {n}-rank mesh over a group of {len(ranks)} ranks")
        return Mesh(group, ranks, axes, shape, dev, str(dist.get_backend(group)))
    if n == 1:
        return Mesh(None, (0 if world_size() == 1 else dist.get_rank(),), axes, shape, dev)
    available = world_size()
    if n > available:
        raise ValueError(
            f"a {n}-rank mesh needs {n} device processes but only {available} "
            "rank(s) are running; start them with torchrun (or "
            "torch.distributed.init_process_group) before building the mesh")
    # a sub-group takes the world's backend; a rank outside it holds no
    # handle to ask, so the world is asked
    return Mesh(subgroup(range(n)), tuple(range(n)), axes, shape, dev,
                str(dist.get_backend()))


def make_production_mesh(*, multi_pod: bool = False, device: Any = None) -> Mesh:
    """The production mesh over the first 256 (512) ranks of the
    initialised default group."""
    shape, axes = PRODUCTION_MESHES[multi_pod]
    return make_mesh(shape, axes, device=device)
