"""Port copy of ``trino_tpu/exec/memory.py`` (process-metrics calls dropped;
batch_bytes counts torch tensors).

Memory accounting: pool + hierarchical contexts + revocation.

Reference: lib/trino-memory-context (AggregatedMemoryContext.java:16,
LocalMemoryContext.java:18) + MemoryPool.java:44 — operators reserve
against a per-query pool; exceeding the limit kills the query (or triggers
revocation/spill). TPU edition: reservations track device HBM batch bytes;
host RAM plays the disk's role as the spill tier (exec/spill.py).

Round-9 growth — the full reservation model:

- USER reservations (`reserve`/`free`): bytes an operator needs resident
  to make progress. Exceeding the limit first *requests revocation* —
  registered callbacks (spillable build caches, pinned batches) free
  revocable bytes by moving them to host — and only then raises
  ExceededMemoryLimitError (MemoryPool.java's reserve + the
  MemoryRevokingScheduler.java:47 watermark trigger, collapsed into the
  reserve path).
- REVOCABLE reservations (`reserve_revocable`): bytes the holder can give
  back at any time (a spillable hash-build, cached build batches). They
  count toward pressure but never fail — by definition their owner
  registered a callback that can spill them.
- Per-holder ledger: every reservation is tagged (query id / cache name)
  so the coordinator's LowMemoryKiller can run its
  total-reservation-dominant policy, and `close()` can prove a query
  freed everything it took.
- Leak/double-free detection: the old `free` clamped negative
  reservations to 0, silently masking accounting bugs. Now a free
  exceeding the outstanding bytes raises MemoryAccountingError under
  strict mode (tests; TRINO_TPU_STRICT_MEMORY=1) and otherwise clamps
  while counting trino_tpu_memory_accounting_errors_total.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional, Tuple


class ExceededMemoryLimitError(RuntimeError):
    """The query's working set cannot fit its pool even after revocation.
    Surfaced to clients as errorName QUERY_EXCEEDED_MEMORY — a user
    error, never retried (retrying an OOM reproduces it)."""

    error_name = "QUERY_EXCEEDED_MEMORY"
    error_code = 3

    def __init__(self, pool: str, requested: int, limit: int):
        super().__init__(
            f"Query exceeded per-query memory limit of {limit} bytes "
            f"in pool {pool} (requested {requested})")
        self.requested = requested
        self.limit = limit


class MemoryKilledError(ExceededMemoryLimitError):
    """Query killed by the cluster LowMemoryKiller (the dominant
    reservation under cluster-wide pressure). Same user-facing error
    code as a per-query limit hit."""

    def __init__(self, reason: str):
        RuntimeError.__init__(self, reason)
        self.requested = 0
        self.limit = 0


class MemoryAccountingError(RuntimeError):
    """A free exceeded the outstanding reservation (double-free) or a
    pool closed with bytes still reserved (leak)."""


def _strict_default() -> bool:
    return os.environ.get("TRINO_TPU_STRICT_MEMORY", "") == "1"


def parse_bytes(text: str) -> int:
    """'17179869184', '16GB', '512MB', '64kB' -> bytes (env knob parse)."""
    t = text.strip().upper()
    for suffix, mult in (("GB", 1 << 30), ("MB", 1 << 20),
                         ("KB", 1 << 10), ("B", 1)):
        if t.endswith(suffix):
            return int(float(t[:-len(suffix)])) * mult
    return int(t)


class MemoryPool:
    """Byte budget shared by a query's operators (memory/MemoryPool.java:44
    reserve:127), grown with revocable reservations and a revocation
    callback registry (context/MemoryTrackingContext + the operators'
    setRevocationHandler wiring)."""

    def __init__(self, limit_bytes: int, name: str = "general",
                 strict: Optional[bool] = None):
        self.limit = limit_bytes
        self.name = name
        self.reserved = 0            # user bytes
        self.revocable = 0           # revocable bytes (spillable)
        self.peak = 0
        self.accounting_errors = 0
        self.revocations_requested = 0
        self.strict = _strict_default() if strict is None else strict
        self._lock = threading.Lock()
        # holder tag -> outstanding user bytes (LowMemoryKiller's per-query
        # attribution); revocable tracked separately
        self.holder_bytes: Dict[str, int] = {}
        self.holder_revocable: Dict[str, int] = {}
        self._current_tag = ""
        # handle -> (tag, callback(target_bytes) -> bytes freed)
        self._revocation_cbs: Dict[int, Tuple[str, Callable[[int], int]]] = {}
        self._next_handle = 0
        # grace depth: while > 0, reserve() never raises — used by the
        # spill paths for the TRANSIENT materialization of a side that is
        # immediately moved to host (its bytes are revocable in spirit:
        # the very next statement revokes them)
        self._grace = 0

    # -- configuration -----------------------------------------------------

    def set_limit(self, limit_bytes: int) -> None:
        """Adjust the budget in place — outstanding reservations (cached
        builds, undrained results) keep their ledger; replacing the pool
        object would leak them."""
        with self._lock:
            self.limit = limit_bytes

    def set_current_tag(self, tag: str) -> None:
        """Default holder for untagged reserve/free calls (the dispatcher
        sets the running query id; operators don't thread it through)."""
        self._current_tag = tag or ""

    # -- user reservations -------------------------------------------------

    def _gauges(self) -> None:
        # port: the process metrics registry is not ported
        return

    def reserve(self, bytes_: int, tag: Optional[str] = None) -> None:
        tag = self._current_tag if tag is None else tag
        with self._lock:
            deficit = self.reserved + self.revocable + bytes_ - self.limit
            grace = self._grace > 0
        if deficit > 0 and not grace:
            # memory pressure: ask revocable holders to spill before
            # failing the query (MemoryRevokingScheduler's trigger)
            freed = self.request_revocation(deficit)
            with self._lock:
                still = self.reserved + self.revocable + bytes_ - self.limit
                if still > 0:
                    raise ExceededMemoryLimitError(
                        self.name, self.reserved + self.revocable + bytes_,
                        self.limit)
            del freed
        with self._lock:
            self.reserved += bytes_
            self.holder_bytes[tag] = self.holder_bytes.get(tag, 0) + bytes_
            self.peak = max(self.peak, self.reserved + self.revocable)
            self._gauges()

    def try_reserve(self, bytes_: int, tag: Optional[str] = None) -> bool:
        try:
            self.reserve(bytes_, tag)
            return True
        except ExceededMemoryLimitError:
            return False

    def free(self, bytes_: int, tag: Optional[str] = None) -> None:
        explicit = tag is not None
        tag = self._current_tag if tag is None else tag
        with self._lock:
            if bytes_ > self.reserved:
                self._accounting_error(
                    f"free of {bytes_} bytes exceeds pool reservation "
                    f"{self.reserved} (double-free)")
                bytes_ = self.reserved
            self.reserved -= bytes_
            held = self.holder_bytes.get(tag, 0)
            take = min(held, bytes_)
            self.holder_bytes[tag] = held - take
            rest = bytes_ - take
            if rest:
                if explicit:
                    # an explicitly-tagged holder over-freed: that is an
                    # accounting bug in its own ledger
                    self._accounting_error(
                        f"holder {tag!r} freed {bytes_} bytes but held "
                        f"{held}")
                else:
                    # untagged frees legitimately cross query boundaries
                    # (a result batch reserved under query A is released
                    # when query B starts) — drain other holders so
                    # sum(holders) keeps tracking `reserved`
                    for h in list(self.holder_bytes):
                        if rest <= 0:
                            break
                        d = min(self.holder_bytes[h], rest)
                        self.holder_bytes[h] -= d
                        rest -= d
            for h in [k for k, v in self.holder_bytes.items() if v == 0]:
                self.holder_bytes.pop(h, None)
            self._gauges()

    # -- revocable reservations --------------------------------------------

    def reserve_revocable(self, bytes_: int,
                          tag: Optional[str] = None) -> None:
        """Never fails: revocable bytes are spillable by contract (their
        owner registered a callback that can give them back)."""
        tag = self._current_tag if tag is None else tag
        with self._lock:
            self.revocable += bytes_
            self.holder_revocable[tag] = \
                self.holder_revocable.get(tag, 0) + bytes_
            self.peak = max(self.peak, self.reserved + self.revocable)
            self._gauges()

    def free_revocable(self, bytes_: int, tag: Optional[str] = None) -> None:
        tag = self._current_tag if tag is None else tag
        with self._lock:
            if bytes_ > self.revocable:
                self._accounting_error(
                    f"revocable free of {bytes_} exceeds {self.revocable}")
                bytes_ = self.revocable
            self.revocable -= bytes_
            held = self.holder_revocable.get(tag, 0)
            if bytes_ > held:
                self._accounting_error(
                    f"revocable holder {tag!r} freed {bytes_} but held "
                    f"{held}")
            self.holder_revocable[tag] = max(0, held - bytes_)
            if self.holder_revocable.get(tag) == 0:
                self.holder_revocable.pop(tag, None)
            self._gauges()

    def register_revocation(self, callback: Callable[[int], int],
                            tag: str = "") -> int:
        """Register a spill callback: callback(target_bytes) frees up to
        target_bytes of revocable memory (calling free_revocable itself)
        and returns the bytes it freed. Returns an unregister handle."""
        with self._lock:
            self._next_handle += 1
            h = self._next_handle
            self._revocation_cbs[h] = (tag, callback)
            return h

    def unregister_revocation(self, handle: int) -> None:
        with self._lock:
            self._revocation_cbs.pop(handle, None)

    def request_revocation(self, target_bytes: int) -> int:
        """Drive callbacks (outside the lock — they free through this
        pool) until target_bytes are freed or every holder was asked.
        Returns bytes actually freed."""
        with self._lock:
            cbs = list(self._revocation_cbs.values())
            before = self.revocable
            self.revocations_requested += 1
        freed = 0
        for _tag, cb in cbs:
            if freed >= target_bytes:
                break
            try:
                freed += int(cb(target_bytes - freed) or 0)
            except Exception:    # noqa: BLE001 — a broken spiller must
                pass             # not mask the real memory error
        with self._lock:
            return max(freed, before - self.revocable)

    # -- transient grace (spill materialization) ---------------------------

    class _Grace:
        def __init__(self, pool: "MemoryPool"):
            self.pool = pool

        def __enter__(self):
            with self.pool._lock:
                self.pool._grace += 1
            return self.pool

        def __exit__(self, *exc):
            with self.pool._lock:
                self.pool._grace -= 1
            return False

    def grace(self) -> "MemoryPool._Grace":
        """Context manager: reservations inside never raise. Used only by
        spill paths to materialize a side that is immediately moved to
        host — the accounting stays truthful, the limit check defers to
        the bounded per-partition phase that follows."""
        return MemoryPool._Grace(self)

    # -- diagnostics -------------------------------------------------------

    def _accounting_error(self, msg: str) -> None:
        # called under self._lock
        self.accounting_errors += 1
        if self.strict:
            raise MemoryAccountingError(f"pool {self.name}: {msg}")

    def available(self) -> int:
        with self._lock:
            return max(0, self.limit - self.reserved - self.revocable)

    def query_bytes(self, tag: str) -> int:
        with self._lock:
            return self.holder_bytes.get(tag, 0) + \
                self.holder_revocable.get(tag, 0)

    def snapshot(self) -> dict:
        """Heartbeat/status payload (ClusterMemoryManager consumes this
        shape from every worker)."""
        with self._lock:
            return {"pool": self.name, "limit": self.limit,
                    "reserved": self.reserved,
                    "revocable": self.revocable, "peak": self.peak,
                    "holders": dict(self.holder_bytes),
                    "revocable_holders": dict(self.holder_revocable)}

    def close(self) -> None:
        """End-of-life check: every byte must have been freed. A leak is
        an accounting bug — strict mode raises (tests), production counts
        the metric and zeroes the ledger so gauges don't lie forever."""
        with self._lock:
            leaked = self.reserved + self.revocable
            if leaked:
                self._accounting_error(
                    f"closed with {leaked} bytes outstanding "
                    f"(holders: {dict(self.holder_bytes)})")
            self.reserved = 0
            self.revocable = 0
            self.holder_bytes.clear()
            self.holder_revocable.clear()
            self._gauges()


class MemoryContext:
    """One operator/node's reservation against the pool
    (LocalMemoryContext.setBytes semantics: delta-adjusted)."""

    def __init__(self, pool: MemoryPool, name: str):
        self.pool = pool
        self.name = name
        self.bytes = 0

    def set_bytes(self, new_bytes: int) -> None:
        delta = new_bytes - self.bytes
        if delta > 0:
            self.pool.reserve(delta)
        elif delta < 0:
            self.pool.free(-delta)
        self.bytes = new_bytes

    def close(self) -> None:
        self.set_bytes(0)


def batch_bytes(batch) -> int:
    """Device bytes of a Batch (data + validity + live mask)."""
    # port: torch tensors count with numel()/element_size()
    total = batch.live.numel()  # bool mask
    for col in batch.columns:
        total += col.data.numel() * col.data.element_size() + \
            col.valid.numel()
    return int(total)
