"""Port copy of ``trino_tpu/server/exchange_spool.py`` (no edits).

Durable exchange spool: task outputs persisted across attempts.

Reference: the fault-tolerant execution exchange —
spi/exchange/ExchangeManager.java + FileSystemExchangeManager.java:40 spool
every task's output partitions durably, so a retry re-runs only failed
tasks and consumers deduplicate attempts
(DeduplicatingDirectExchangeBuffer.java:87,
spi/exchange/ExchangeSourceOutputSelector.java).

TPU runtime shape: the coordinator is the exchange consumer. Every drained
task's pages are written here keyed by the *work identity* — a digest of
(fragment, splits) — not the attempt, so any successful attempt satisfies
the key and later attempts of the same work are never re-dispatched: the
scheduler checks the spool before POSTing a task, which turns retry-policy
QUERY into task-granularity recovery (only unfinished work re-executes).
Local disk plays the object store's role (the SPI boundary to swap in a
real one is this class)."""

from __future__ import annotations

import hashlib
import os
import struct
import tempfile
import threading
from typing import List, Optional


class ExchangeSpool:
    def __init__(self, root: Optional[str] = None, injector=None):
        # default scope is one coordinator lifetime (fresh directory):
        # the recovery quantum is a retried attempt within it. Pass an
        # explicit root for durability across coordinator restarts.
        self.root = root or tempfile.mkdtemp(prefix="trino_tpu_exchange_")
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self.injector = injector          # chaos hook (SPOOL_READ/WRITE)
        self.checksum_rejects = 0         # corrupt spool entries dropped
        self.write_skips = 0              # best-effort puts that failed

    @staticmethod
    def work_key(fragment_blob: str, splits) -> str:
        """Digest of the task's deterministic work identity."""
        h = hashlib.sha256()
        h.update(fragment_blob.encode())
        for s in splits:
            h.update(f"{s.catalog}.{s.schema_name}.{s.table}"
                     f":{s.start}+{s.count}".encode())
        return h.hexdigest()[:32]

    # container layout: b"TSPL" | npages u32 | per page: len u64 | frame
    _MAGIC = b"TSPL"

    def _path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.spool")

    def get(self, key: str) -> Optional[List[bytes]]:
        """Read spooled pages; a miss OR any integrity failure returns
        None so the scheduler re-dispatches the work — the spool is a
        recovery accelerator, never a correctness dependency. Every page
        frame is CRC32C-verified here (the reference verifies exchange
        source handles the same way); a corrupt container is deleted so
        the next attempt re-creates it from a live task."""
        from ..metrics import SPOOL_HITS, SPOOL_MISSES
        from .failureinjector import InjectedFailure
        from .pageserde import PageChecksumError, verify_page
        try:
            if self.injector is not None:
                self.injector.maybe_fail("SPOOL_READ", key)
            with open(self._path(key), "rb") as f:
                blob = f.read()
            if blob[:4] != self._MAGIC:
                SPOOL_MISSES.inc()
                return None
            (npages,) = struct.unpack_from("<I", blob, 4)
            off = 8
            pages = []
            for _ in range(npages):
                (ln,) = struct.unpack_from("<Q", blob, off)
                off += 8
                pages.append(blob[off:off + ln])
                off += ln
            for p in pages:
                verify_page(p)
            SPOOL_HITS.inc()
            return pages
        except PageChecksumError:
            self.checksum_rejects += 1
            SPOOL_MISSES.inc()
            try:
                os.unlink(self._path(key))
            except OSError:
                pass
            return None
        except (OSError, ValueError, struct.error, InjectedFailure):
            SPOOL_MISSES.inc()
            return None

    def put(self, key: str, pages: List[bytes]) -> None:
        """Persist one work unit's pages. Best-effort: persistence
        failures (disk full, injected faults) degrade to a spool miss on
        the next attempt, never a query failure."""
        from .failureinjector import InjectedFailure
        path = self._path(key)
        try:
            if self.injector is not None:
                self.injector.maybe_fail("SPOOL_WRITE", key)
                # payload corruption injected here is caught by get()'s
                # per-page CRC32C check — the write itself succeeds
                pages = [self.injector.corrupt_page("SPOOL_WRITE", key, p)
                         for p in pages]
            with self._lock:
                tmp = path + ".tmp"
                # write-then-rename: a crashed writer never leaves a torn
                # file a later attempt could read (exactly-one-attempt)
                with open(tmp, "wb") as f:
                    f.write(self._MAGIC + struct.pack("<I", len(pages)))
                    for p in pages:
                        f.write(struct.pack("<Q", len(p)))
                        f.write(p)
                os.replace(tmp, path)
        except (OSError, InjectedFailure):
            self.write_skips += 1

    def delete(self, key: str) -> None:
        """Drop one container (spill partitions are consumed once)."""
        try:
            os.unlink(self._path(key))
        except OSError:
            pass

    def clear(self) -> None:
        for f in os.listdir(self.root):
            if f.endswith((".json", ".spool")):
                try:
                    os.unlink(os.path.join(self.root, f))
                except OSError:
                    pass

    def sweep(self, keep=()) -> int:
        """Orphan sweep for a durable spool root after a coordinator
        failover: drop every container whose work key no live (ledger-
        known, non-terminal) query can claim. Returns the number of
        containers removed; leftover .tmp files from a crashed writer
        are always swept."""
        keep = set(keep)
        removed = 0
        try:
            names = os.listdir(self.root)
        except OSError:
            return 0
        for f in names:
            path = os.path.join(self.root, f)
            if f.endswith(".tmp"):
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            if not f.endswith(".spool") or f[:-len(".spool")] in keep:
                continue
            try:
                os.unlink(path)
                removed += 1
            except OSError:
                pass
        return removed
