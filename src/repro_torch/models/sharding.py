"""Sharding rules: parameter/batch/cache specs per mesh, placed as DTensors.

The port's copy of ``repro/models/sharding.py``.  This is the SPMD
backend's decision table — what the CVM parallelization rewrite decides
abstractly (Split over "data", weight-Split over "model", pre-aggregation
= a sum) is realized here as one spec per leaf:

  * TP (Megatron): attention qkv column-split / wo row-split; MLP in/out;
    embeddings vocab-split (the loss's logsumexp becomes a model-axis
    all-reduce of per-row statistics, ``models/lm.py``);
  * EP: expert dim over "model" when divisible, else TP over expert d_ff;
  * DP: batch over ("pod", "data");
  * SP (decode): sequence-split KV caches when batch or heads can't fill
    the mesh (long-context decode);
  * ZeRO-1: optimizer moments additionally sharded over "data".

Every rule checks divisibility and falls back to replication.

A spec is a :class:`P`: one entry per tensor dimension, each ``None``, a
mesh axis name or a tuple of names, as JAX's ``PartitionSpec``.  The rules
read only a mesh's ``axis_names`` and ``shape`` (``launch/mesh.py:Mesh``).
Where JAX hands a spec to GSPMD through ``NamedSharding``, the port turns
it into DTensor placements over a ``DeviceMesh`` (:func:`placements`,
:func:`device_mesh`, :func:`shard_tree`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional, Tuple

import torch


class P(tuple):
    """A partition spec: ``P("model", None)``, one entry per dimension."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[mesh.axis_names.index(name)] if name in mesh.axis_names else 1


def _dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _dp_size(mesh) -> int:
    out = 1
    for a in _dp_axes(mesh):
        out *= _axis_size(mesh, a)
    return out


def _dp_entry(mesh):
    dp = _dp_axes(mesh)
    return dp if len(dp) > 1 else dp[0]


def _shard_dim(shape: Tuple[int, ...], dim: int, size: int) -> bool:
    return len(shape) > 0 and shape[dim] % size == 0 and shape[dim] >= size


# name-keyed rules: (which dim to shard over "model") given the leaf name
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "cm_k", "in_proj", "wr", "wg", "w1"}
_ROW = {"wo", "w_down", "cm_v", "out_proj", "cm_r", "wvv"}


def param_spec(path: str, leaf, mesh, zero1_axis: Optional[str] = None) -> P:
    m = _axis_size(mesh, "model")
    shape = tuple(leaf.shape)
    rank = len(shape)
    name = path.split("/")[-1]
    spec = [None] * rank

    if name == "emb" and _shard_dim(shape, 0, m):
        spec[0] = "model"                      # vocab-sharded embedding
    elif name in ("router", "conv_w", "A_log", "D", "dt_bias", "mu", "u", "w0",
                  "cm_mu", "w2"):
        pass                                    # replicated (small)
    elif "moe" in path and name in ("w_gate", "w_up", "w_down") and rank >= 3:
        e_dim = rank - 3                        # (L, E, D, F) or (E, D, F)
        if _shard_dim(shape, e_dim, m):
            spec[e_dim] = "model"               # expert parallelism
        elif name in ("w_gate", "w_up") and _shard_dim(shape, rank - 1, m):
            spec[rank - 1] = "model"            # fall back to TP over d_ff
        elif name == "w_down" and _shard_dim(shape, rank - 2, m):
            spec[rank - 2] = "model"
    elif name in _COL and rank >= 2 and _shard_dim(shape, rank - 1, m):
        spec[rank - 1] = "model"
    elif name in _ROW and rank >= 2 and _shard_dim(shape, rank - 2, m):
        spec[rank - 2] = "model"
    # anything else (a small kv projection that did not divide) is replicated

    if zero1_axis is not None:
        z = _axis_size(mesh, zero1_axis)
        for d in range(rank - 1, -1, -1):       # prefer trailing (largest) dims
            if spec[d] is None and shape[d] % z == 0 and shape[d] >= z:
                spec[d] = zero1_axis
                break
    return P(*spec)


def _map_specs(fn, spec_node, *trees):
    """``fn(spec, *leaves)`` over a spec tree and trees of its structure."""
    if isinstance(spec_node, P):
        return fn(spec_node, *trees)
    if isinstance(spec_node, dict):
        return {k: _map_specs(fn, v, *(t[k] for t in trees)) for k, v in spec_node.items()}
    return type(spec_node)(_map_specs(fn, v, *(t[i] for t in trees))
                           for i, v in enumerate(spec_node))


def _with_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples, the path
    its keys joined by "/", as JAX's walk names them."""
    if isinstance(tree, dict):
        return {k: _with_paths(fn, v, f"{prefix}/{k}" if prefix else k) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_with_paths(fn, v, f"{prefix}/{i}") for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_param_specs(params, mesh, zero1: bool = False):
    """Tree of specs mirroring ``params`` (``zero1`` is not read, as in JAX)."""
    return _with_paths(lambda path, leaf: param_spec(path, leaf, mesh), params)


def _add_dp(spec: P, leaf, mesh) -> P:
    """``spec`` plus a data-axes shard on the trailing free dim that divides
    (ZeRO-1 for moments, ZeRO-2 for the gradient accumulator)."""
    z = _dp_size(mesh)
    if z <= 1:
        return spec
    shape = tuple(leaf.shape)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for d in range(len(shape) - 1, -1, -1):
        if parts[d] is None and shape[d] % z == 0 and shape[d] >= z:
            parts[d] = _dp_entry(mesh)
            return P(*parts)
    return spec


def tree_opt_specs(opt_state, params_specs, mesh, zero1: bool = True):
    """Moments follow the weight specs; ZeRO-1 adds a "data" shard when it fits."""

    def rec(spec_node, state_node):
        if isinstance(state_node, dict):
            return {k: rec(spec_node.get(k) if isinstance(spec_node, dict) else spec_node,
                           v) for k, v in state_node.items()}
        if isinstance(state_node, (tuple, list)):
            t = type(state_node)
            return t(rec(spec_node[i] if isinstance(spec_node, (tuple, list)) else spec_node, v)
                     for i, v in enumerate(state_node))
        if hasattr(state_node, "shape") and state_node.ndim > 0 and isinstance(spec_node, P):
            return _add_dp(spec_node, state_node, mesh) if zero1 else spec_node
        return P()

    return {key: rec(params_specs, opt_state[key]) if key in ("m", "v", "mom") else P()
            for key in opt_state}


def tree_grad_specs(params_shapes, param_specs, mesh):
    """ZeRO-2-style specs for the f32 gradient accumulator: weight specs
    plus a data-axis shard on the largest free dim (same rule as ZeRO-1)."""
    return _map_specs(lambda spec, leaf: _add_dp(spec, leaf, mesh), param_specs, params_shapes)


def batch_specs(batch_shapes: Dict[str, Tuple[Tuple[int, ...], Any]], mesh):
    """Specs for a training/serving batch: shard dim 0 (batch) over DP axes,
    falling back to sequence sharding (dim 1) for batch-1 long-context."""
    n = _dp_size(mesh)
    out = {}
    for name, (shape, _) in batch_shapes.items():
        spec = [None] * len(shape)
        bdim = 1 if name == "positions3" else 0
        if len(shape) > bdim and shape[bdim] % n == 0 and shape[bdim] >= n:
            spec[bdim] = _dp_entry(mesh)
        elif len(shape) > bdim + 1 and shape[bdim + 1] % n == 0:
            spec[bdim + 1] = _dp_entry(mesh)    # sequence sharding
        out[name] = P(*spec)
    return out


def cache_specs(cache_shapes, mesh, cfg) -> Any:
    """KV-cache/state sharding for decode.

    Preference order per leaf (L, B, H, S, D)-like: batch over DP;
    heads over "model" when divisible; otherwise sequence over "model"
    (flash-decoding style split).  A leaf that is not a tensor (the port's
    cache length is a Python int) gets ``P()``.
    """
    m = _axis_size(mesh, "model")
    n = _dp_size(mesh)

    def spec_for(path: str, leaf) -> P:
        shape = tuple(getattr(leaf, "shape", ()))
        rank = len(shape)
        spec = [None] * rank
        if rank == 0:
            return P()
        # caches are stacked (L, B, ...): dim 1 is batch
        bdim = 1 if rank >= 2 else 0
        if shape[bdim] % n == 0 and shape[bdim] >= n:
            spec[bdim] = _dp_entry(mesh)
        if rank >= 5:
            hdim, sdim = 2, 3                   # (L, B, H, S, D)
            if shape[hdim] % m == 0 and shape[hdim] >= m:
                spec[hdim] = "model"
            elif shape[sdim] % m == 0 and shape[sdim] >= m:
                spec[sdim] = "model"            # sequence-sharded cache
        elif rank == 4:                          # e.g. conv state (L, B, K, Di)
            if shape[3] % m == 0 and shape[3] >= m:
                spec[3] = "model"
        return P(*spec)

    return _with_paths(spec_for, cache_shapes)


# ---------------------------------------------------------------------------
# DTensor placements (what JAX's ``named`` hands GSPMD)
# ---------------------------------------------------------------------------


def device_mesh(mesh, device_type: Optional[str] = None):
    """The ``DeviceMesh`` over ``mesh``'s ranks, laid out along its axes.
    Every rank of the default group must call it (it makes a process
    group per mesh dimension).  Over gloo on CUDA tensors DTensor's
    all-gathers go through :func:`gather_through_c10d`."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dev = device_type or mesh.device.type
    if dev == "cuda":
        # the rank's own card, set before DeviceMesh would set LOCAL_RANK's
        # (ranks sharing one card have no card of that number)
        torch.cuda.set_device(mesh.device)
        torch.cuda.init()
        if dist.is_initialized() and dist.get_backend() == "gloo":
            gather_through_c10d("CUDA")
    ranks = torch.tensor(mesh.ranks, dtype=torch.int64).reshape(mesh.shape)
    return DeviceMesh(dev, ranks, mesh_dim_names=tuple(mesh.axis_names))


#: dispatch keys whose functional all-gather goes through c10d's (the
#: registrations live as long as the process)
_GATHER_OVERRIDES: Dict[str, Any] = {}


def gather_through_c10d(key: str) -> None:
    """Route ``_c10d_functional.all_gather_into_tensor`` on ``key``'s tensors
    through c10d's ``all_gather_into_tensor``, once per process.

    DTensor gathers with the functional op, which reaches gloo's coalesced
    all-gather; on CUDA tensors that crashes the process (torch 2.11 on the
    H100: a segfault), while c10d's own all-gather of the same tensors runs
    (``chip_smoke.py``'s probe).  The override makes the same collective,
    synchronously; ``wait_tensor`` then finds no pending work and returns
    the gathered tensor."""
    if key in _GATHER_OVERRIDES:
        return
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    def all_gather(inp, group_size, group_name):
        group = (_resolve_process_group(group_name) if isinstance(group_name, str)
                 else group_name)
        out = inp.new_empty((inp.shape[0] * group_size,) + tuple(inp.shape[1:]))
        dist.all_gather_into_tensor(out, inp.contiguous(), group=group)
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", all_gather, key)
    _GATHER_OVERRIDES[key] = lib


def placements(dmesh, spec: P) -> tuple:
    """DTensor placements of ``spec`` over ``dmesh``: a mesh dimension
    named in entry d shards tensor dim d, else it replicates.  A dim split
    over ("pod", "data") is sharded by both, in mesh order: JAX's
    major-to-minor split."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in dmesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def redistribute_tree(tree, specs, dmesh):
    """Each DTensor leaf of ``tree`` redistributed to its spec's placements
    (JAX's ``with_sharding_constraint``)."""
    return _map_specs(lambda spec, leaf: placed_to(leaf, placements(dmesh, spec))
                      if isinstance(leaf, torch.Tensor) else leaf, specs, tree)


def placed_to(x, target):
    """The DTensor ``x`` redistributed to the placements ``target``; itself
    where it already has them."""
    if tuple(x.placements) == tuple(target):
        return x
    return x.redistribute(x.device_mesh, target)


def zero1_optimizer(opt, param_specs, opt_specs, dmesh):
    """``opt`` with ZeRO-1's placements made explicit around its update:
    the gradients reduced to their moments' placements (a reduce-scatter
    over the data axes), the parameters sliced to them (nothing is sent),
    the update run there, and the new parameters gathered back to
    ``param_specs`` (an all-gather).  Without moments, ``opt`` itself."""
    key = next((k for k in ("m", "mom") if k in opt_specs), None)
    if key is None:
        return opt
    from ..train.optimizer import Optimizer

    mspecs = opt_specs[key]

    def update(grads, state, params):
        new, state = opt.update(redistribute_tree(grads, mspecs, dmesh), state,
                                redistribute_tree(params, mspecs, dmesh))
        return redistribute_tree(new, param_specs, dmesh), state

    return Optimizer(opt.init, update)


def shard_tree(tree, specs, dmesh):
    """Each tensor leaf of ``tree`` (the full tensor, the same on every
    rank) as a DTensor placed by its spec: every rank keeps its own slice,
    nothing is sent.  Other leaves (a cache length) pass as they are."""
    from torch.distributed.tensor import distribute_tensor

    return _map_specs(lambda spec, leaf: distribute_tensor(
        leaf, dmesh, placements(dmesh, spec), src_data_rank=None)
        if isinstance(leaf, torch.Tensor) else leaf, specs, tree)


def _whole(x, n: int, dim: int = -1):
    """A DTensor ``x`` whose shard of ``dim`` splits one of ``n`` heads (or
    is uneven), gathered on that dim (DTensor cannot view such a shard;
    GSPMD can); else ``x`` as it is."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, dim = x.device_mesh, dim % x.ndim
    on = [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim % x.ndim == dim]
    if n % math.prod(mesh.size(i) for i in on) == 0:
        return x
    return x.redistribute(mesh, tuple(Replicate() if i in on else p
                                      for i, p in enumerate(x.placements)))


class _SplitHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n, d):
        ctx.shape = x.shape
        return _whole(x, n).reshape(*x.shape[:-1], n, d)

    @staticmethod
    def backward(ctx, g):
        return _whole(g, g.shape[-2], -2).reshape(ctx.shape), None, None


class _MergeHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n_kv):
        ctx.shape, ctx.n_kv = x.shape, n_kv
        return _whole(x, x.shape[-2], -2).reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])

    @staticmethod
    def backward(ctx, g):
        # the gradient goes on to attention's (Hkv, H/Hkv) view of the heads
        return _whole(g, ctx.n_kv).reshape(ctx.shape), None


def group_heads(q, n_kv: int):
    """The DTensor ``q`` (B, H, S, D) ready for attention's (B, Hkv, H/Hkv,
    S, D) view: where its heads' shard does not divide the ``n_kv`` groups,
    its heads are gathered (the KV heads, too few to shard, were gathered
    by :func:`split_heads`).  A plain tensor comes back as it is."""
    if isinstance(q, torch.Tensor) and hasattr(q, "placements"):
        return _whole(q, n_kv, 1)
    return q


def per_rank_attention(fn, q, k, v):
    """``fn(q, k, v)`` for attention over (B, H, S, D): on DTensors, each rank
    runs ``fn`` on its own tensors, since attention is independent per
    sequence and per (group of) heads.  On a mesh dim where q, k and v are
    split alike on B or on H they stay split; on any other (the sequence
    split, heads split in one and not another) all three are gathered
    first.  DTensor itself cannot run the attention's (B, Hkv, G, S, D)
    products with B and Hkv both split in torch 2.11 ("flatten multiple
    dimensions")."""
    if not (isinstance(q, torch.Tensor) and hasattr(q, "placements")):
        return fn(q, k, v)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    keep = []
    for pq, pk, pv in zip(q.placements, k.placements, v.placements):
        same = pq == pk == pv and (pq.is_replicate()
                                   or (isinstance(pq, Shard) and pq.dim in (0, 1)))
        keep.append(pq if same else Replicate())
    keep = tuple(keep)
    q, k, v = (placed_to(t, keep) for t in (q, k, v))
    return local_map(fn, out_placements=(keep,), in_placements=(keep, keep, keep),
                     in_grad_placements=(keep, keep, keep), device_mesh=q.device_mesh)(q, k, v)


def per_rank_moe(block, p, x, **kw):
    """``block(p, x, **kw)`` (``layers.moe_block``) on DTensors: the MoE of
    the whole batch, as GSPMD runs JAX's, with each rank computing its own
    experts.

    x is gathered whole on every rank (an all-gather of (B, S, D) over the
    mesh dims that split it): the capacity comes from the global T, and
    each choice's place in its expert from one stable sort over all T·K
    choices in (B, S) order, so every rank routes every token as one
    device does.  Each rank then runs ``block`` on its own tensors: its
    slice of the experts (expert-split over a mesh dim where E divides,
    ``first_expert`` its first), or every expert with its slice of d_ff
    (the fallback).  Its ``out`` holds its experts' or its d_ff slice's
    part of each token's sum; the parts are summed over those mesh dims
    (one all-reduce of (B, S, D) in x's dtype), so the combine's order
    differs from one device's by the order of that sum.  Every rank of
    the other mesh dims computes the same (GSPMD replicates these dispatch
    buffers too).  ``out`` comes back split as x (a partial x's sum is
    taken first).

    Under autograd each rank's gradients of x and of the router are its
    experts' part, summed over the experts' mesh dims; the aux loss,
    which every rank computes whole, sends its gradient from the first
    rank of those dims only.  The experts' gradients keep their leaves'
    placements."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    w = p["w_gate"]
    split = [i for i, pl in enumerate(w.placements) if isinstance(pl, Shard)
             and mesh.size(i) > 1]
    whole = (Replicate(),) * mesh.ndim
    part = tuple(Partial() if i in split else Replicate() for i in range(mesh.ndim))
    e_dim = w.ndim - 3
    _, offset = compute_local_shape_and_global_offset(w.shape, mesh, w.placements)
    groups = [mesh.get_group(i) for i in split]
    first = all(mesh.get_local_rank(i) == 0 for i in split)
    names = sorted(p)

    def local(xl, *leaves):
        y, aux = block(dict(zip(names, leaves)), xl, first_expert=offset[e_dim], **kw)
        for group in groups:
            y = _SumOver.apply(y, group)
        return y, (aux if first else aux.detach())

    pl = [p[k].placements for k in names]
    grad = [part if k == "router" else p[k].placements for k in names]
    y, aux = local_map(local, out_placements=(whole, whole), in_placements=(whole, *pl),
                       in_grad_placements=(part, *grad), device_mesh=mesh,
                       redistribute_inputs=True)(placed_to(x, whole), *(p[k] for k in names))
    return placed_to(y, tuple(Replicate() if q.is_partial() else q for q in x.placements)), aux


def per_rank_scan(fn, r, k, v, w, u, st):
    """``fn(r, k, v, w, u, st)``, RWKV's time scan over (B, S, H, P) inputs,
    u (H, P, 1) and the state st (B, H, P, P): on DTensors each rank scans
    its own sequences and heads through ``local_map``, since the scan is
    independent per sequence and per head (else every step of it would be
    a handful of DTensor ops).  w is placed as r; on a mesh dim where r, k
    and v are not split alike on B or on H (the sequence split, a partial
    sum) the four are gathered.  Under autograd u's gradient is a partial
    sum over the mesh dims that split B.  A plain call is ``fn`` itself."""
    if not hasattr(r, "placements"):
        return fn(r, k, v, w, u, st)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = r.device_mesh
    keep = []
    for pr, pk, pv in zip(r.placements, k.placements, v.placements):
        same = pr == pk == pv and (pr.is_replicate() or (isinstance(pr, Shard) and pr.dim in (0, 2)))
        keep.append(pr if same else Replicate())
    keep = tuple(keep)
    heads = tuple(Shard(0) if p == Shard(2) else Replicate() for p in keep)
    state = tuple(Shard(1) if p == Shard(2) else p for p in keep)
    u_grad = tuple(Partial() if p == Shard(0) else q for p, q in zip(keep, heads))
    if not isinstance(st, DTensor):  # a state of zeros made on every rank
        st = DTensor.from_local(st, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    args = [placed_to(t, keep) for t in (r, k, v, w)] + [placed_to(u, heads),
                                                        placed_to(st, state)]
    return local_map(fn, out_placements=(keep, state),
                     in_placements=(keep,) * 4 + (heads, state),
                     in_grad_placements=(keep,) * 4 + (u_grad, state),
                     device_mesh=mesh)(*args)


#: the leaves of a Mamba2 block that its mixer reads, each replicated by
#: the sharding table (``norm`` by no rule, the rest as small)
MAMBA_MIXER_LEAVES = ("conv_w", "A_log", "D", "dt_bias", "norm")


def per_rank_mamba(fn, x, p, state=None, *, d_inner: int, d_head: int, ssm_state: int, **kw):
    """A Mamba2 block on x (B, S, D): u = x @ ``in_proj``, then ``fn(u, p,
    state, …)``, Mamba2's mixer (``ssm._mamba_mix``) from u (B, S, 2·Di +
    2·N + H) to the normed y (B, S, Di) and the new (conv, SSM) state, then
    (y @ ``out_proj``) in x's dtype.  On plain tensors that and nothing
    else.  On DTensors x's gradient is summed to its placement once
    (``tp_input``) and the output comes back in x's placement (the partial
    sums of the row-split ``out_proj`` all-reduced), as the dense blocks'.

    On DTensors each rank mixes its own sequences and its own contiguous
    heads through ``local_map``, since the conv is per channel and the SSD
    per sequence and per head.  u, column-split over ``model`` (where
    ``in_proj`` divides), is first gathered over ``model`` (one all-gather
    of (B/dp, S, 2·Di + 2·N + H)): split on the local tensor, its z, x and
    dt keep no strided placement.  Each rank keeps the z, x and dt of its
    H/m heads and B and C whole, and slices the replicated leaves
    (``MAMBA_MIXER_LEAVES``) to its heads and channels.  The norm over Di
    sums its squares over ``model`` (one all-reduce of (B/dp, S, 1) f32
    partial sums, also in backward: each rank normalises its own channels
    by the sum), so its mean differs from one device's by that sum's order.
    y comes back split on Di over ``model`` in contiguous heads, as the
    row-split ``out_proj`` takes it without a gather.  On a mesh dim where u
    is not split on B (``model``, a sequence split) it is gathered.

    The state comes in and goes out in ``cache_specs``' placements, per
    layer: the batch split as u's, the SSM state (B, H, N, P) on H over
    ``model`` and the conv state (B, K − 1, Di) on Di, which contiguous
    heads give as they are.  Where H does not divide over ``model``, every
    ``model`` rank mixes every head (y replicated over ``model``, the norm
    its own); the state is gathered in and sliced out to ``cache_specs``'
    placements (the SSM state then on N where N divides).

    Under autograd u's gradient is a partial sum over ``model`` (each
    rank's heads, and B's and C's parts), and each leaf's a partial sum
    over ``model`` (each rank's own slice, zeros elsewhere) and over the
    mesh dims that split B, so each reaches its replicated leaf as one
    device's autograd gives it."""
    kw.update(d_inner=d_inner, d_head=d_head, ssm_state=ssm_state)
    if not hasattr(x, "placements"):
        y, new_state = fn(x @ p["in_proj"], p, state, **kw)
        return (y @ p["out_proj"]).to(x.dtype), new_state
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    u = tp_input(x) @ p["in_proj"]
    h = d_inner // d_head
    mdim = next((i for i, name in enumerate(mesh.mesh_dim_names or ())
                 if name == "model" and mesh.size(i) > 1), None)
    m = mesh.size(mdim) if mdim is not None else 1
    split = mdim is not None and h % m == 0
    keep = tuple(pl if pl == Shard(0) and i != mdim else Replicate()
                 for i, pl in enumerate(u.placements))

    def on(dim):
        """keep, with the ``model`` dim splitting tensor dim ``dim`` (None: none)."""
        return tuple(Shard(dim) if i == mdim and dim is not None else pl
                     for i, pl in enumerate(keep))

    conv_out = on(2 if mdim is not None and d_inner % m == 0 else None)
    ssm_out = on(1 if mdim is not None and h % m == 0
                 else 2 if mdim is not None and ssm_state % m == 0 else None)
    conv_in, ssm_in = (conv_out, ssm_out) if split else (on(None), on(None))
    whole = (Replicate(),) * mesh.ndim
    part = tuple(Partial() if pl == Shard(0) or (split and i == mdim) else Replicate()
                 for i, pl in enumerate(keep))
    u_grad = tuple(Partial() if split and i == mdim else pl for i, pl in enumerate(keep))
    if split:
        group = mesh.get_group(mdim)
        kw["heads"] = (mesh.get_local_rank(mdim) * (h // m), h // m)

        def norm(y, w, eps: float = 1e-6):  # L.rmsnorm, its mean of squares over all of Di
            y32 = y.float()
            var = _SumEverywhere.apply(torch.sum(y32 * y32, dim=-1, keepdim=True), group) / d_inner
            return (y32 * torch.rsqrt(var + eps)).to(y.dtype) * w

        kw["norm"] = norm
    st = ()
    if state is not None:
        st = tuple(t if isinstance(t, DTensor) else  # a state of zeros made on every rank
                   DTensor.from_local(t, mesh, whole, run_check=False) for t in state)
        st = (placed_to(st[0], conv_in), placed_to(st[1], ssm_in))

    def local(ul, *args):
        leaves = dict(zip(MAMBA_MIXER_LEAVES, args[:len(MAMBA_MIXER_LEAVES)]))
        y, (conv, ssm) = fn(ul, leaves, args[len(MAMBA_MIXER_LEAVES):] or None, **kw)
        return y, conv, ssm

    n_st = len(st)
    y, conv, ssm = local_map(
        local, out_placements=(on(2) if split else keep, conv_in, ssm_in),
        in_placements=(keep,) + (whole,) * len(MAMBA_MIXER_LEAVES) + (conv_in, ssm_in)[:n_st],
        in_grad_placements=(u_grad,) + (part,) * len(MAMBA_MIXER_LEAVES)
        + (conv_in, ssm_in)[:n_st],
        device_mesh=mesh, redistribute_inputs=True)(
            placed_to(u, keep), *(p[k] for k in MAMBA_MIXER_LEAVES), *st)
    out = placed_to((y @ p["out_proj"]).to(x.dtype), x.placements)
    return out, (placed_to(conv, conv_out), placed_to(ssm, ssm_out))


class _SumEverywhere(torch.autograd.Function):
    """All-reduce (sum) over ``group`` forward and backward: every rank goes
    on with the same sum into a computation of its own, so each part's
    gradient is the sum of the ranks' gradients of the sum.
    ``torch.distributed.nn.functional.all_reduce`` computes the same, but
    torch 2.13 deprecates it with a FutureWarning on every call."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def write_position(cache, pos: int, value) -> None:
    """``cache[:, :, pos] = value`` in place, cache (B, H, cap, D), value
    (B, H, D) cast to its dtype.  On a DTensor whose positions are split
    (a sequence-split decode cache) an index there would write into a
    gathered copy and leave the cache as it was; it takes JAX's
    mask-and-where over the whole cache instead, each rank on its own
    positions."""
    from torch.distributed.tensor import Shard

    value = value.to(cache.dtype)
    if hasattr(cache, "placements") and any(isinstance(p, Shard) and p.dim % cache.ndim == 2
                                            for p in cache.placements):
        at = torch.arange(cache.shape[2], device=cache.device) == pos
        cache.copy_(torch.where(at[:, None], value[:, :, None, :], cache))
    else:
        cache[:, :, pos] = value


def replicated(x):
    """The DTensor ``x`` gathered whole on every rank (a plain tensor as it is)."""
    if isinstance(x, torch.Tensor) and hasattr(x, "placements"):
        from torch.distributed.tensor import Replicate

        return placed_to(x, (Replicate(),) * x.device_mesh.ndim)
    return x


def split_heads(x, n: int, d: int):
    """(..., n·d) → (..., n, d).  A DTensor sharded inside a head is
    gathered on that dim first."""
    if isinstance(x, torch.Tensor) and hasattr(x, "placements"):
        return _SplitHeads.apply(x, n, d)
    return x.reshape(*x.shape[:-1], n, d)


def merge_heads(x, n_kv: int):
    """(..., n, d) → (..., n·d).  Under a DTensor the gradient, which the
    row-split output projection shards on n·d, is gathered first where its
    shard splits one of the ``n_kv`` groups of heads."""
    if isinstance(x, torch.Tensor) and hasattr(x, "placements"):
        return _MergeHeads.apply(x, n_kv)
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over ``group`` forward, identity backward: every
    rank of the group goes on with the same sum, so each part's gradient is
    the sum's (Megatron's reduce from the model-parallel region)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _vocab_split(emb):
    """(the mesh dim that splits ``emb``'s rows or None, its group, rows per
    rank); a mesh dim of one rank splits nothing."""
    from torch.distributed.tensor import Shard

    vocab = [i for i, p in enumerate(emb.placements)
             if isinstance(p, Shard) and p.dim == 0 and emb.device_mesh.size(i) > 1]
    if len(vocab) > 1:
        raise ValueError(f"the vocabulary is split over {len(vocab)} mesh dims; one at most")
    if not vocab:
        return None, None, emb.shape[0]
    return vocab[0], emb.device_mesh.get_group(vocab[0]), emb.to_local().shape[0]


def vocab_parallel_embedding(emb, tokens):
    """``emb[tokens]`` on DTensors whose table may be split by rows over a
    mesh dim: each rank looks up the tokens in its slice (zeros elsewhere)
    and the rows are summed over that dim — an all-reduce of the (B, S, D)
    activations, never a gather of the table."""
    import torch.nn.functional as F
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = emb.device_mesh
    vdim, group, width = _vocab_split(emb)
    rows = tuple(tokens.placements)
    batch = [i for i, p in enumerate(rows) if isinstance(p, Shard)]

    def local(e, tok):
        if group is None:  # the whole table on this rank: the plain lookup's bits
            return e[tok]
        idx = tok.long() - mesh.get_local_rank(vdim) * width
        inside = (idx >= 0) & (idx < width)
        out = F.embedding(torch.where(inside, idx, 0), e)
        return _SumOver.apply(torch.where(inside[..., None], out, torch.zeros_like(out)), group)

    e_grad = [Partial() if i in batch else p for i, p in enumerate(emb.placements)]
    return local_map(local, out_placements=(rows,), in_placements=(emb.placements, rows),
                     in_grad_placements=(e_grad, rows), device_mesh=mesh,
                     redistribute_inputs=True)(emb, tokens)


def vocab_parallel_ce(plain, emb32, xs, labels, mask):
    """(Σ mask·(logsumexp − label logit), Σ mask) of the logits ``xs @
    emb32ᵀ`` on DTensors whose vocabulary may be sharded (``emb32`` split
    on dim 0 over a mesh dim; where it is not, each rank runs ``plain``, the
    plain chunk, on its tensors): each rank computes its slice of the logits,
    and only per-row statistics cross the vocab's mesh dim — the max, the
    sum of exponentials and the label's logit, one all-reduce of (B, c)
    values each — never the (B, c, V) logits, as GSPMD lowers JAX's
    ``logsumexp`` over a vocab-split embedding.  Both sums come back as
    partial sums over the mesh dims that split the batch."""
    import torch.distributed as dist
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = emb32.device_mesh
    vdim, group, width = _vocab_split(emb32)
    rows = tuple(labels.placements)
    batch = [i for i, p in enumerate(rows) if isinstance(p, Shard)]

    def local(e, x, idx, ms):
        if group is None:  # the whole vocabulary on this rank
            return plain(e, x, idx, ms)
        logits = x.float() @ e.T                                    # (b, c, V / n)
        m = torch.amax(logits.detach(), dim=-1, keepdim=True)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        idx = idx.long() - mesh.get_local_rank(vdim) * width
        se = torch.sum(torch.exp(logits - m), dim=-1, keepdim=True)
        inside = (idx >= 0) & (idx < width)
        ll = torch.gather(logits, -1, torch.where(inside, idx, 0)[..., None])[..., 0]
        ll = _SumOver.apply(torch.where(inside, ll, torch.zeros_like(ll)), group)
        lse = (m + torch.log(_SumOver.apply(se, group)))[..., 0]
        return torch.sum((lse - ll) * ms), torch.sum(ms)

    part = [Partial() if i in batch else Replicate() for i in range(mesh.ndim)]
    e_grad = [Partial() if i in batch else p for i, p in enumerate(emb32.placements)]
    x_grad = [Partial() if i == vdim else p for i, p in enumerate(rows)]
    return local_map(local, out_placements=(part, part),
                     in_placements=(emb32.placements, rows, rows, rows),
                     in_grad_placements=(e_grad, x_grad, rows, rows), device_mesh=mesh,
                     redistribute_inputs=True)(emb32, xs, labels, mask)


def vocab_parallel_argmax(logits):
    """``torch.argmax(logits, dim=-1)`` of the DTensor ``logits`` (..., V),
    whose vocabulary may be split over mesh dims: each rank takes the max
    of its own slice and its global index, and the ranks exchange these
    (value, index) pairs over each mesh dim that splits the vocabulary (an
    all-gather of (...,) values) — never the logits.  Among equal maxima
    the lowest global index wins, as ``jnp.argmax``'s first occurrence: a
    vocab rank's slice lies after its lower ranks', ``torch.argmax`` over
    the gathered values takes the first, and the minor mesh dim is reduced
    first (where two split the vocabulary, the major one's slices hold
    the minor one's).  The result is split as the logits' leading dims; on
    a vocabulary split over no mesh dim each rank runs the plain
    ``torch.argmax`` on its rows."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map

    mesh, last = logits.device_mesh, logits.ndim - 1
    keep = tuple(Replicate() if p.is_partial() else p for p in logits.placements)
    vocab = [i for i, p in enumerate(keep) if isinstance(p, Shard) and p.dim % logits.ndim == last
             and mesh.size(i) > 1]
    rows = tuple(Replicate() if i in vocab else p for i, p in enumerate(keep))
    _, offset = compute_local_shape_and_global_offset(logits.shape, mesh, keep)

    def local(x):
        idx = torch.argmax(x, dim=-1)
        if not vocab:  # the whole vocabulary on this rank: the plain argmax's bits
            return idx
        val = torch.gather(x, -1, idx[..., None])[..., 0]
        idx = idx + offset[last]
        for i in reversed(vocab):
            group = mesh.get_group(i)
            vals = val.new_empty((mesh.size(i),) + tuple(val.shape))
            idxs = idx.new_empty((mesh.size(i),) + tuple(idx.shape))
            dist.all_gather_into_tensor(vals, val[None].contiguous(), group=group)
            dist.all_gather_into_tensor(idxs, idx[None].contiguous(), group=group)
            pick = torch.argmax(vals, dim=0, keepdim=True)
            val = torch.gather(vals, 0, pick)[0]
            idx = torch.gather(idxs, 0, pick)[0]
        return idx

    return local_map(local, out_placements=(rows,), in_placements=(keep,),
                     device_mesh=mesh, redistribute_inputs=True)(logits)


def dtensor_scope(tree):
    """Where ``tree`` holds DTensors, a context in which a plain tensor met
    beside one (an arange of positions, a mask, a scalar) counts as
    replicated; else a context that does nothing."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    leaf = tree
    while isinstance(leaf, (dict, list, tuple)) and leaf:
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf[0]
    return implicit_replication() if isinstance(leaf, DTensor) else contextlib.nullcontext()


def tp_input(x):
    """Megatron's f: ``x`` as it is, with its gradient summed to ``x``'s
    own placements in backward (the column-split products that read a
    replicated ``x`` give partial gradients; summed here, once, they do
    not spread into the residual stream's backward).  A plain tensor
    comes back as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return DTensor.from_local(x.to_local(grad_placements=x.placements), x.device_mesh,
                              x.placements, run_check=False)


def zeros_placed_like(shape, dtype, like, lead: int = 0):
    """A DTensor of zeros of ``shape`` whose dims ``lead`` onwards are split
    as the DTensor ``like``'s dims (a stacked cache of one layer's keys)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    pl = tuple(Shard(p.dim % like.ndim + lead) if isinstance(p, Shard) else Replicate()
               for p in like.placements)
    local, _ = compute_local_shape_and_global_offset(shape, like.device_mesh, pl)
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=like.device),
                              like.device_mesh, pl, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def placed_like(x, like):
    """``x`` redistributed to the DTensor ``like``'s placements (a plain
    tensor comes back as it is)."""
    from torch.distributed.tensor import DTensor

    return placed_to(x, like.placements) if isinstance(like, DTensor) else x


#: c10d's own names for the collectives DTensor issues as functional ops
_C10D_KINDS = {"_allgather_base_": "all_gather_into_tensor",
               "_reduce_scatter_base_": "reduce_scatter_tensor"}


def comm_bytes():
    """A ``CommDebugMode`` that also keeps each collective's kind, the
    DTensor op it was issued for, its output shape, dtype and bytes (the
    output's size, as JAX's dry-run counts a collective in the HLO):
    ``.records``, and ``.by_kind()`` →
    {kind: {"calls", "bytes"}}."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.debug._comm_mode import (NATIVE_TO_PY_MAPPING,
                                                           c10d_collective_ops)

    class CommBytes(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.records = []
            self._op = None

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented:  # a DTensor op: its collectives follow
                self._op = str(func)
                return out
            packet = getattr(func, "_overloadpacket", None)
            if out is not NotImplemented and (packet in self.comm_registry
                                              or packet in c10d_collective_ops):
                kind = NATIVE_TO_PY_MAPPING.get(packet, packet).__name__.split(".")[-1]
                kind = _C10D_KINDS.get(kind, kind)
                t = out[0] if isinstance(out, (list, tuple)) else out
                if isinstance(t, torch.Tensor):
                    self.records.append({"kind": kind, "for": self._op, "shape": tuple(t.shape),
                                         "dtype": str(t.dtype).replace("torch.", ""),
                                         "bytes": t.numel() * t.element_size()})
            return out

        def by_kind(self) -> Dict[str, Dict[str, int]]:
            out: Dict[str, Dict[str, int]] = {}
            for r in self.records:
                d = out.setdefault(r["kind"], {"calls": 0, "bytes": 0})
                d["calls"] += 1
                d["bytes"] += r["bytes"]
            return out

    return CommBytes()
