"""Content-addressed on-disk store for compiled-plan metadata.

The port's copy of ``repro/compiler/store.py``, same format.  Executables
cannot be serialized, but everything needed
to *re-plan cheaply* can: the structural fingerprint, the chosen lowering
strategy, the pass records, and the cost estimates.  Spilling that metadata
keyed by the full plan-cache key means a restarted process (serve restarts,
elastic re-planning) skips the costed candidate search and re-lowers
straight down the previously chosen path, and the cost calibration keeps
learning across processes instead of starting cold.

Layout (``<root>/``):
  * ``<keyhash>.json``  — one plan record per (target, epoch, fingerprint,
    options) key, hashed content-address
  * ``<keyhash>.corrupt`` — a quarantined record that failed to parse; it is
    renamed aside on first detection so later runs see a clean miss instead
    of re-parsing and re-warning on the same bytes
  * ``calibration-torch.json`` — this package's :class:`CostCalibration`
    state (the JAX package's store writes ``calibration.json``; the names
    differ so that one directory can serve both packages without mixing
    compile times of two backends)

Plan records may carry a ``poison`` list: strategies whose compiled plans
*failed* (verification, backend compile, or execution — see
``repro_torch.robust.fallback``).  :meth:`PlanStore.mark_poison` appends to it and
the driver skips poisoned strategies on replay, so a crashing plan is never
reloaded from cache and re-crashed.

Store I/O is failure-tolerant by design: reads retry transient ``OSError``\\ s
(``repro_torch.robust.retry``), a failed read degrades to a cache miss, and a
failed write is warned about and dropped — persistence is an optimization,
never a correctness dependency.  Writes are atomic (tmp + rename) so
concurrent processes can share a store directory.  The default location
honours ``REPRO_PLAN_STORE`` so serving stacks can turn persistence on
without code changes.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Set, Tuple, Union

from ..obs.trace import get_tracer, warn_event
from ..robust.inject import InjectedFault, maybe_inject
from ..robust.retry import RetryPolicy, call_with_retry
from .cost import CostCalibration

__all__ = ["PlanStore", "default_store", "CALIBRATION_FILE"]

#: this package's calibration file in the store directory
CALIBRATION_FILE = "calibration-torch.json"

#: transient-I/O policy for store reads/writes: short, bounded, OSError-only
_IO_RETRY = RetryPolicy(max_retries=2, backoff_s=0.01, retry_on=(OSError,))


def _mangle_json(text: str, rule: Any) -> str:
    """Deterministic corruptor for ``store.load``: make the parse fail the
    way a torn write does (truncated bytes), exercising quarantine."""
    return text[: max(len(text) // 2, 1)].rstrip("}")


class PlanStore:
    """Directory-backed, content-addressed plan-metadata store."""

    def __init__(self, root: Union[str, Path]) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    # -- paths -------------------------------------------------------------
    def _plan_path(self, key_hash: str) -> Path:
        return self.root / f"{key_hash}.json"

    def _quarantine_path(self, key_hash: str) -> Path:
        return self.root / f"{key_hash}.corrupt"

    @property
    def _calib_path(self) -> Path:
        return self.root / CALIBRATION_FILE

    # -- plan records --------------------------------------------------------
    def save_plan(self, key_hash: str, record: Dict[str, Any]) -> None:
        """Persist one plan record; existing poison marks are preserved.

        A failed write is warned about (``plan_store.save_failed``) and
        dropped — the store is an optimization, not a correctness
        dependency, so a full disk must not fail the compile that already
        succeeded.
        """
        record = dict(record)
        record.setdefault("saved_at", time.time())
        if "poison" not in record:
            existing = self._read_raw(self._plan_path(key_hash))
            if existing and existing.get("poison"):
                record["poison"] = existing["poison"]
        try:
            maybe_inject("store.save", key=key_hash)
            call_with_retry(
                lambda: self._atomic_write(self._plan_path(key_hash), record),
                _IO_RETRY, name="store.save")
        except (OSError, InjectedFault) as e:
            get_tracer().counter("plan_store.save_failed")
            warn_event("plan_store.save_failed", key=key_hash,
                       reason=f"{type(e).__name__}: {e}")

    def load_plan(self, key_hash: str) -> Optional[Dict[str, Any]]:
        path = self._plan_path(key_hash)

        def _read() -> Optional[str]:
            try:
                return path.read_text()
            except FileNotFoundError:
                return None

        try:
            text = call_with_retry(_read, _IO_RETRY, name="store.load")
        except OSError as e:
            get_tracer().counter("plan_store.corrupt")
            warn_event("plan_store.corrupt", path=str(path),
                       reason=f"{type(e).__name__}: {e}")
            return None
        if text is None:
            get_tracer().counter("plan_store.miss")
            return None
        try:
            text = maybe_inject("store.load", text, corrupt=_mangle_json,
                                key=key_hash)
            record = json.loads(text)
        except InjectedFault as e:
            # an injected *raise* is a transient read failure, not bad bytes
            # on disk — degrade to a miss without quarantining a good record
            get_tracer().counter("plan_store.corrupt")
            warn_event("plan_store.corrupt", path=str(path), reason=str(e))
            return None
        except ValueError as e:
            # a present-but-unparseable record is data loss, not a miss —
            # surface it, and quarantine the bytes aside so every later run
            # sees a clean miss instead of re-parsing the same corruption
            quarantined = self._quarantine(key_hash)
            get_tracer().counter("plan_store.corrupt")
            warn_event("plan_store.corrupt", path=str(path),
                       quarantined=str(quarantined or ""),
                       reason=f"{type(e).__name__}: {e}")
            return None
        get_tracer().counter("plan_store.hit")
        return record

    def _quarantine(self, key_hash: str) -> Optional[Path]:
        """Rename a corrupt record to ``<key>.corrupt`` (best-effort)."""
        path = self._plan_path(key_hash)
        target = self._quarantine_path(key_hash)
        try:
            os.replace(path, target)
        except OSError:
            return None
        get_tracer().counter("plan_store.quarantined")
        return target

    def __len__(self) -> int:
        return sum(1 for p in self.root.glob("*.json")
                   if p.name != CALIBRATION_FILE)

    # -- poison plans --------------------------------------------------------
    def mark_poison(self, key_hash: str, strategy: Iterable[Tuple[str, str]],
                    reason: str = "") -> None:
        """Record that ``strategy``'s compiled plan failed for this key.

        The driver consults the mark on replay (memory cache, store replay,
        and costed search all skip poisoned strategies), so a crashing plan
        is quarantined instead of being recompiled and re-crashed.  Uses raw
        reads/writes on purpose: the poison bookkeeping is the safety net
        itself and must not be subject to fault injection.
        """
        path = self._plan_path(key_hash)
        record = self._read_raw(path) or {}
        strat = sorted([str(k), str(v)] for k, v in strategy)
        poison = list(record.get("poison") or ())
        if strat not in [p.get("strategy") for p in poison]:
            poison.append({"strategy": strat, "reason": reason,
                           "at": time.time()})
        record["poison"] = poison
        try:
            self._atomic_write(path, record)
        except OSError as e:
            warn_event("plan_store.save_failed", key=key_hash,
                       reason=f"{type(e).__name__}: {e}")
            return
        get_tracer().counter("plan_store.poison")

    @staticmethod
    def poisoned_strategies(record: Optional[Dict[str, Any]],
                            ) -> Set[Tuple[Tuple[str, str], ...]]:
        """The set of (sorted) strategy tuples marked poison in a record."""
        out: Set[Tuple[Tuple[str, str], ...]] = set()
        for p in (record or {}).get("poison") or ():
            out.add(tuple(sorted((str(k), str(v))
                                 for k, v in p.get("strategy") or ())))
        return out

    # -- calibration ---------------------------------------------------------
    def load_calibration(self) -> CostCalibration:
        try:
            return CostCalibration.from_dict(
                json.loads(self._calib_path.read_text()))
        except FileNotFoundError:
            return CostCalibration()
        except (OSError, ValueError) as e:
            get_tracer().counter("plan_store.corrupt")
            warn_event("plan_store.corrupt", path=str(self._calib_path),
                       reason=f"{type(e).__name__}: {e}")
            return CostCalibration()

    def save_calibration(self, calib: CostCalibration) -> None:
        self._atomic_write(self._calib_path, calib.to_dict())

    # -- internals -----------------------------------------------------------
    @staticmethod
    def _read_raw(path: Path) -> Optional[Dict[str, Any]]:
        """Best-effort read outside the injection/warning machinery."""
        try:
            got = json.loads(path.read_text())
            return got if isinstance(got, dict) else None
        except (OSError, ValueError):
            return None

    def _atomic_write(self, path: Path, payload: Dict[str, Any]) -> None:
        fd, tmp = tempfile.mkstemp(dir=str(self.root), suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=2, default=str)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise


def default_store() -> Optional[PlanStore]:
    """The environment-configured store (``REPRO_PLAN_STORE``), if any."""
    root = os.environ.get("REPRO_PLAN_STORE")
    return PlanStore(root) if root else None
