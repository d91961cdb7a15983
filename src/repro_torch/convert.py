"""Carry tables, arrays and model weights across onto the device.

Numpy columns — or a JAX ``VecTable``'s ``.cols`` / ``.valid`` as numpy
arrays, holes included, so a table from the middle of a JAX pipeline
carries over — become torch ``VecTable``\\ s; the ``la`` flavor's arrays
(k-means points and centroids) become tensors; and a JAX LM parameter
tree, as numpy arrays, becomes the port's tree of tensors.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from .relational.runtime import VecTable, _np_x32, resolve_device


def vectable_from_arrays(cols: Mapping[str, np.ndarray], valid: np.ndarray,
                         device: Any = None) -> VecTable:
    """A VecTable with exactly these columns and validity mask (capacity =
    their length); 64-bit columns become 32-bit (x64 off)."""
    dev = resolve_device(device)
    valid = np.asarray(valid, dtype=bool)
    out = {}
    for k, v in cols.items():
        v = _np_x32(np.asarray(v))
        if v.shape[0] != valid.shape[0]:
            raise ValueError(f"column {k!r} has {v.shape[0]} rows, validity {valid.shape[0]}")
        out[k] = torch.from_numpy(np.array(v, copy=True)).to(dev)
    return VecTable(out, torch.from_numpy(valid.copy()).to(dev))


def sources_from_context(ctx: Any, device: Any = None) -> Dict[str, VecTable]:
    """Every table of a ``Context`` as a VecTable at the context's padded
    capacity, in physical dtypes (strings as global-dictionary codes)."""
    return {name: VecTable.from_numpy(ctx._physical_columns(name), ctx.capacity(name),
                                      device=device)
            for name in ctx.tables}


def tensors_from_arrays(*arrays: np.ndarray, device: Any = None) -> List[torch.Tensor]:
    """Each array as a contiguous tensor on ``device`` (``cuda`` unless
    given), with the x64-off dtypes: 64-bit ints and floats become 32-bit."""
    dev = resolve_device(device)
    return [torch.from_numpy(np.array(_np_x32(np.asarray(a)), copy=True)).to(dev)
            for a in arrays]


def _leaf_from_numpy(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16, which torch.from_numpy refuses
        return torch.from_numpy(np.array(a, copy=True).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


#: leaves that stay at least f32 when a tree is carried at a narrower
#: dtype, as JAX makes them f32 whatever the model's dtype: the MoE router
#: (in bf16 its top-k would route other experts), Mamba2's ``A_log``,
#: ``D`` and ``dt_bias`` and RWKV6's ``w0`` and ``u`` (the decays and
#: their bonus)
KEEP_F32 = ("router", "A_log", "D", "dt_bias", "w0", "u")


def params_from_jax(tree: Any, device: Any = None,
                    dtype: Optional[torch.dtype] = None) -> Any:
    """A JAX parameter tree (nested dicts of arrays, e.g. through
    ``jax.device_get``) as the same tree of tensors on ``device``
    (``cuda`` unless given); floating leaves are cast to ``dtype`` where
    one is given, except that a leaf named in ``KEEP_F32`` goes no
    narrower than f32.  Stacked per-layer leaves keep their leading axis."""
    dev = resolve_device(device)

    def carry(node: Any, name: str) -> Any:
        if isinstance(node, Mapping):
            return {k: carry(v, k) for k, v in node.items()}
        t = _leaf_from_numpy(node)
        if dtype is not None and t.is_floating_point():
            t = t.to(torch.promote_types(dtype, torch.float32) if name in KEEP_F32 else dtype)
        return t.to(dev)

    return carry(tree, "")
