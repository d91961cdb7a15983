"""Sharded, atomic, elastic checkpointing (no external deps).

The port's copy of ``repro/distributed/checkpoint.py`` without JAX: the
tree flattener below names leaves as ``jax.tree_util.keystr`` names the
paths of ``tree_flatten_with_path`` (sorted dict keys as ``['k']``,
sequence items as ``[0]``, named-tuple fields as ``.f``, ``None`` an
empty subtree), so the manifests and npz keys are the JAX package's and
a snapshot written by either package restores under the other.

Layout::

    <dir>/step_<N>/
        manifest.json        # tree structure, shapes, dtypes, shard map, hashes
        shard_<i>.npz        # leaf arrays, chunked along dim 0 per shard

Properties needed at 1000+ nodes:
  * **atomic**: written to ``step_<N>.tmp`` then os.rename'd — a crash
    mid-write never corrupts the latest checkpoint;
  * **sharded**: leaves split into ``n_shards`` files so hosts write/read in
    parallel (here one process writes all shards; the layout is the same);
  * **elastic reshard**: restore() takes the *target* tree structure and
    re-slices shards onto whatever shape the new job uses — a 2-shard
    checkpoint restores under a 1-shard manager and vice versa; a leaf
    whose target is a torch tensor goes to that tensor's device, a bf16
    leaf as a bf16 tensor (the JAX package's restore hands back its raw
    ``V2`` bits);
  * **integrity**: content hashes per shard, verified on load — a failed
    verification (or an unreadable manifest) quarantines the step directory
    (renamed ``step_<N>.corrupt``, matching the PlanStore idiom) and
    restore falls back to the previous step with a ``warn_event`` instead
    of raising; ``restore(..., strict=True)`` keeps the raising behavior;
  * **gc**: keep the most recent ``keep`` checkpoints.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _flatten(tree) -> Tuple[List[Tuple[str, Any]], Any]:
    """``(path name, leaf)`` pairs in JAX's leaf order, and the structure
    :func:`_unflatten` rebuilds from new leaves."""
    items: List[Tuple[str, Any]] = []

    def walk(node: Any, path: str) -> Any:
        if node is None:
            return ("none",)
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", keys, [walk(node[k], f"{path}[{k!r}]") for k in keys])
        if _is_namedtuple(node):
            return ("namedtuple", type(node),
                    [walk(v, f"{path}.{f}") for f, v in zip(node._fields, node)])
        if isinstance(node, (list, tuple)):
            return (type(node).__name__,
                    [walk(v, f"{path}[{i}]") for i, v in enumerate(node)])
        items.append((path, node))
        return ("leaf",)

    treedef = walk(tree, "")
    return items, treedef


def _unflatten(treedef: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(node: Any) -> Any:
        kind = node[0]
        if kind == "none":
            return None
        if kind == "leaf":
            return next(it)
        if kind == "dict":
            return {k: build(c) for k, c in zip(node[1], node[2])}
        if kind == "namedtuple":
            return node[1](*[build(c) for c in node[2]])
        children = [build(c) for c in node[1]]
        return children if kind == "list" else tuple(children)

    return build(treedef)


def _host(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf as a host numpy array and the dtype name its manifest entry
    records (torch tensors leave their device).  A bf16 tensor, which numpy
    cannot hold without ``ml_dtypes``, is written as its 2-byte bits viewed
    as ``V2``, named ``"bfloat16"``: the bytes and the name the JAX package
    writes for a bf16 leaf."""
    if hasattr(leaf, "detach"):
        import torch

        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _placed(arr: np.ndarray, dtype: str, target: Any) -> Any:
    """A restored leaf where its target lives: on the target tensor's
    device when the target is a torch tensor (a ``"bfloat16"`` leaf's bits
    as a bf16 tensor), else the numpy array as it was read."""
    if hasattr(target, "detach") and hasattr(target, "device"):
        import torch

        arr = np.asarray(arr, order="C")  # ascontiguousarray would make a 0-d leaf 1-d
        if dtype == "bfloat16":
            return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(target.device)
        return torch.from_numpy(arr).to(target.device)
    return arr


class CheckpointManager:
    def __init__(self, directory: str | Path, n_shards: int = 4, keep: int = 3) -> None:
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.n_shards = n_shards
        self.keep = keep

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict[str, Any]] = None) -> Path:
        items, _ = _flatten(tree)
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

        manifest: Dict[str, Any] = {"step": step, "leaves": {}, "extra": extra or {},
                                    "n_shards": self.n_shards}
        shards: List[Dict[str, np.ndarray]] = [dict() for _ in range(self.n_shards)]
        for name, leaf in items:
            arr, dtype = _host(leaf)
            manifest["leaves"][name] = {"shape": list(arr.shape), "dtype": dtype}
            if arr.ndim == 0 or arr.shape[0] < self.n_shards:
                shards[0][name] = arr
                manifest["leaves"][name]["shards"] = [0]
            else:
                chunks = np.array_split(arr, self.n_shards, axis=0)
                for i, c in enumerate(chunks):
                    shards[i][name] = c
                manifest["leaves"][name]["shards"] = list(range(self.n_shards))

        hashes = []
        for i, shard in enumerate(shards):
            path = tmp / f"shard_{i}.npz"
            np.savez(path, **{k.replace("/", "|"): v for k, v in shard.items()})
            hashes.append(hashlib.sha256(path.read_bytes()).hexdigest())
        manifest["hashes"] = hashes
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))

        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        return final

    # -- restore ----------------------------------------------------------------
    def steps(self) -> List[int]:
        """Published (non-tmp, non-quarantined) step numbers, ascending."""
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                      if not p.name.endswith(".tmp")
                      and not p.name.endswith(".corrupt"))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, target_tree: Any, step: Optional[int] = None,
                verify: bool = True, strict: bool = False,
                ) -> Tuple[Any, Dict[str, Any]]:
        """Load into the *structure* (and shardings) of ``target_tree``.

        ``target_tree`` may hold numpy arrays or torch tensors; shapes must
        match the saved shapes.  A leaf whose target is a torch tensor is
        restored onto that tensor's device.

        A step whose manifest is unreadable or whose shard hashes mismatch
        is **quarantined** (directory renamed ``step_<N>.corrupt``) and the
        restore falls back to the previous published step, emitting a
        ``ckpt.quarantined`` warn_event — one corrupt snapshot must not
        brick recovery.  ``strict=True`` restores the old behavior: the
        first corrupt step raises ``IOError``.
        """
        if step is not None:
            candidates = [s for s in self.steps() if s <= step]
            if step not in candidates:
                raise FileNotFoundError(
                    f"no checkpoint for step {step} under {self.dir}")
            candidates = list(reversed(candidates))
        else:
            candidates = list(reversed(self.steps()))
        if not candidates:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")

        last_err: Optional[BaseException] = None
        for s in candidates:
            d = self.dir / f"step_{s:08d}"
            try:
                return self._load_step(d, s, target_tree, verify)
            except (IOError, OSError, ValueError, KeyError) as e:
                if strict:
                    raise
                last_err = e
                self._quarantine(d, s, e)
        raise IOError(
            f"every checkpoint under {self.dir} failed to restore; "
            f"last error: {last_err}")

    def _load_step(self, d: Path, step: int, target_tree: Any,
                   verify: bool) -> Tuple[Any, Dict[str, Any]]:
        manifest = json.loads((d / "manifest.json").read_text())

        if verify:
            for i, want in enumerate(manifest["hashes"]):
                got = hashlib.sha256((d / f"shard_{i}.npz").read_bytes()).hexdigest()
                if got != want:
                    raise IOError(f"checkpoint shard {i} hash mismatch at step {step}")

        loaded = [np.load(d / f"shard_{i}.npz") for i in range(manifest["n_shards"])]
        items, treedef = _flatten(target_tree)
        leaves = []
        for name, leaf in items:
            info = manifest["leaves"].get(name)
            if info is None:
                raise KeyError(f"checkpoint missing leaf {name}")
            key = name.replace("/", "|")
            parts = [loaded[i][key] for i in info["shards"]]
            arr = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
            want_shape = tuple(getattr(leaf, "shape", arr.shape))
            if tuple(arr.shape) != want_shape:
                raise ValueError(f"{name}: checkpoint shape {arr.shape} != target {want_shape}")
            leaves.append(_placed(arr, info["dtype"], leaf))
        return _unflatten(treedef, leaves), manifest["extra"]

    def _quarantine(self, d: Path, step: int, error: BaseException) -> None:
        from ..obs.trace import get_tracer, warn_event

        corrupt = d.with_name(d.name + ".corrupt")
        if corrupt.exists():
            shutil.rmtree(corrupt)
        if d.exists():
            os.rename(d, corrupt)
        get_tracer().counter("ckpt.quarantined")
        warn_event("ckpt.quarantined", step=step, path=str(corrupt),
                   error=f"{type(error).__name__}: {error}")

    def _gc(self) -> None:
        steps = sorted(p for p in self.dir.glob("step_*")
                       if not p.name.endswith(".tmp")
                       and not p.name.endswith(".corrupt"))
        for p in steps[:-self.keep]:
            shutil.rmtree(p)
