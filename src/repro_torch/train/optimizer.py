"""Optimizers as pure transforms of tensor trees (the port's copy of
``repro/train/optimizer.py``).

A tree is nested dicts (and lists or tuples) of tensors, walked in the
JAX package's leaf order (sorted dict keys).  State layout mirrors the
parameter tree: f32 moments and an int32 ``step``, on the parameters'
device.  ``update`` returns new tensors and leaves its inputs as they were.

JAX promotes ``bf16 * f32[]`` to f32 where torch keeps bf16 for a 0-d f32
tensor, so every gradient is taken to f32 before it is scaled: the clipped
gradient reaches ``m`` and ``v`` unrounded, as in JAX.  AdamW updates one
leaf at a time, so only one leaf's f32 gradient exists at once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Tuple

import torch


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``, in :func:`tree_leaves`' order; the result has
    ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_like(tree: Any, leaves: List[Any]) -> Any:
    """``tree``'s structure holding ``leaves`` (in :func:`tree_leaves`' order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _step0(params: Any) -> torch.Tensor:
    leaves = tree_leaves(params)
    return torch.zeros((), dtype=torch.int32, device=leaves[0].device if leaves else None)


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params) → (new_params, new_state)


def clip_scale(g_leaves: List[torch.Tensor], grad_clip: float) -> torch.Tensor:
    """AdamW's gradient-clip factor min(1, clip / (‖g‖ + 1e-9)), f32, with
    ‖g‖ the correctly rounded sqrt of the f32 sum of squares, as XLA takes
    it: torch's f32 sqrt on the CPU misses by an ulp on some inputs, and the
    f64 sqrt rounded to f32 is exact (CUDA's f32 sqrt already is)."""
    ss = torch.sum(torch.square(g_leaves[0].float()))
    for g in g_leaves[1:]:  # on DTensors a partial sum, all-reduced once below
        ss = ss + torch.sum(torch.square(g.float()))
    gnorm = torch.sqrt(ss.double()).float()
    return torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)


def AdamW(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, grad_clip: float = 1.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": _step0(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        g_leaves = tree_leaves(grads)
        scale = None if grad_clip is None else clip_scale(g_leaves, grad_clip)

        bc1 = 1.0 - b1 ** step.float()
        bc2 = 1.0 - b2 ** step.float()

        def leaf(g, m, v, p):
            g = g.float() if scale is None else g.float() * scale
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p.float()
            return m, v, (p.float() - lr * delta).to(p.dtype)

        # one leaf at a time: a leaf's f32 gradient lives only while its
        # update is computed (JAX fuses the whole update)
        new = [leaf(*x) for x in zip(g_leaves, tree_leaves(state["m"]), tree_leaves(state["v"]),
                                     tree_leaves(params))]
        new_m, new_v, new_p = (tree_like(params, [x[i] for x in new]) for i in range(3))
        return new_p, {"m": new_m, "v": new_v, "step": step}

    return Optimizer(init, update)


def SGD(lr: float = 1e-2, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"mom": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                      device=p.device), params),
                "step": _step0(params)}

    def update(grads, state, params):
        new_m = tree_map(lambda g, m: momentum * m + g.float(), grads, state["mom"])
        new_params = tree_map(lambda p, m: (p.float() - lr * m).to(p.dtype), params, new_m)
        return new_params, {"mom": new_m, "step": state["step"] + 1}

    return Optimizer(init, update)
