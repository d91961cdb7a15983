"""Carry tables and arrays across onto the device.

The state of this system is its tables, so this is the counterpart of
carrying weights across: numpy columns — or a JAX ``VecTable``'s
``.cols`` / ``.valid`` as numpy arrays, holes included, so a table from
the middle of a JAX pipeline carries over — become torch ``VecTable``\\ s,
and the ``la`` flavor's arrays (k-means points and centroids) become
tensors.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

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
