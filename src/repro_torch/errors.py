"""Faults of the card or of a kernel, which no safer plan repairs.

The driver's fallback ladder (``robust/fallback.py``) steps down to safer
strategies and at last to the numpy interpreter when a *plan* fails.  A
missing card, a tensor on the wrong device, a kernel that does not build
or does not launch are not plan faults: walking the ladder for them would
answer on the host and hide that the card or a kernel is broken.  The
compile ladder and the first-execution guard re-raise these classes, as
the JAX package re-raises invalid inputs.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Type

__all__ = ["CardError", "NoCardError", "DeviceMismatchError", "KernelBuildError",
           "KernelLaunchError", "is_card_fault", "card_fault"]


class CardError(RuntimeError):
    """The card or a kernel failed; the fallback ladder re-raises it."""


class NoCardError(CardError):
    """The caller asked for a card and none is visible."""


class DeviceMismatchError(CardError, ValueError):
    """An input lies on another device than the one the plan runs on."""


class KernelBuildError(CardError):
    """A kernel library could not be generated, built or loaded (no
    ``nvcc``, a compile error, a library ``ctypes`` cannot load)."""


class KernelLaunchError(CardError):
    """A kernel's wrapper failed: its launch returned a CUDA error, or it
    refused or could not place its inputs."""


def is_card_fault(error: BaseException) -> bool:
    """Whether ``error`` comes from the card rather than from the plan: one
    of the classes above, the card running out of memory, or a CUDA error
    torch raised (which leaves the context unusable)."""
    import torch

    card = tuple(c for c in (getattr(torch, "OutOfMemoryError", None),
                             getattr(torch, "AcceleratorError", None)) if c is not None)
    return isinstance(error, (CardError, *card))


@contextmanager
def card_fault(cls: Type[CardError], what: str) -> Iterator[None]:
    """Re-raise any failure inside the block as ``cls``: code on a kernel's
    path reports every failure as a fault the ladder does not walk."""
    try:
        yield
    except CardError:
        raise
    except Exception as e:
        raise cls(f"{what}: {type(e).__name__}: {e}") from e
