"""Fault injection and retries for the port's serve loop: the
``serve.step`` injection point (``inject``) and bounded retries with
deadlines (``retry``), copied from ``repro/robust``.  Admission by memory
budget and the fallback ladder are not ported."""

from .inject import POINTS, FaultRule, InjectedFault, clear_faults, inject, maybe_inject  # noqa: F401
from .retry import Deadline, RetryPolicy, call_with_retry  # noqa: F401
