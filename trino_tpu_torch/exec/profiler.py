"""Compile observability: the central compile-event recorder.

Counterpart of ``trino_tpu/exec/profiler.py``, with the reference's
``CompileRecorder`` API (``record``, ``snapshot``, ``totals``,
``site_shape_counts``, ``prewarm_context``, ``bind_stats``,
``thread_compile_seconds``), the process-wide ``RECORDER`` and
``device_memory_stats``.

The port's only compile is a kernel library build: ``ops/cuda_build.py``
records each library it loads under site ``cuda_build.<kernel>`` with
the source digest as the fingerprint. A library this process built with
nvcc is a compile with its nvcc seconds; a load of a library already
built on disk is a hit. The recorder feeds ``GET /v1/jit``,
``system.runtime.jit_cache`` and the Prometheus families
trino_tpu_jit_compiles_total{site}, trino_tpu_jit_cache_hits_total{site}
and trino_tpu_jit_compile_seconds.

The reference's ``instrument`` and ``recorded_jit`` wrap ``jax.jit``
callables; the port has no jit, so they have no counterpart here.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List


@dataclass(frozen=True)
class CompileEvent:
    site: str
    fingerprint: str
    duration_s: float       # build wall for misses, 0.0 for hits
    hit: bool               # True = the library was already built
    when: float             # time.time() at record


class CompileRecorder:
    """Thread-safe compile-event ring + per-(site, fingerprint) cache
    aggregates. One per process (module-level RECORDER): loaded kernel
    libraries are process-global, so their compile ledger is too."""

    MAX_EVENTS = 512
    MAX_ENTRIES = 2048

    def __init__(self):
        self._lock = threading.Lock()
        self.events: "deque[CompileEvent]" = deque(maxlen=self.MAX_EVENTS)
        # (site, fingerprint) -> mutable aggregate dict
        self._entries: "OrderedDict[tuple, dict]" = OrderedDict()
        self.total_compiles = 0
        self.total_hits = 0
        self.total_compile_s = 0.0
        # shape-canonicalization signal: every fingerprint ever seen per
        # site (survives the entry LRU — the lint cares about distinct
        # shapes produced, not about what is still cached)
        self._site_shapes: Dict[str, set] = {}
        # (site, fingerprint) -> off-path compile seconds, pending the
        # first query-path hit that claims the saving
        self._prewarm_pending: Dict[tuple, float] = {}
        self.total_prewarmed = 0
        self.total_prewarm_hits = 0
        self.total_saved_s = 0.0
        self._tl = threading.local()

    # -- per-thread attribution --------------------------------------------

    def bind_stats(self, stats) -> None:
        """Attribute compiles recorded on THIS thread to `stats`
        (ExecStats.jit_compiles). The executor binds its stats object at
        dispatch entry; worker task threads each bind their own."""
        self._tl.stats = stats

    def thread_compile_seconds(self) -> float:
        """Cumulative compile seconds recorded on this thread — the
        profiled dispatch path diffs this around a dispatch to isolate
        the compile component of an operator's wall."""
        return getattr(self._tl, "compile_s", 0.0)

    @contextmanager
    def site_context(self, prefix: str):
        """Prefix every site recorded on this thread inside the block —
        the spill tier wraps its partition-wise re-runs so their kernel
        compiles attribute to the spill path, not the resident one."""
        prev = getattr(self._tl, "site_prefix", None)
        self._tl.site_prefix = prefix
        try:
            yield
        finally:
            self._tl.site_prefix = prev

    @contextmanager
    def prewarm_context(self):
        """Mark every compile recorded on this thread inside the block
        as an OFF-PATH prewarm compile (exec/prewarm.py): it counts as
        prewarm_compiles_total instead of charging the thread-bound
        ExecStats, and the first later query-path hit on the same
        (site, fingerprint) claims its wall as compile seconds saved."""
        prev = getattr(self._tl, "prewarm", False)
        self._tl.prewarm = True
        try:
            yield
        finally:
            self._tl.prewarm = prev

    # -- recording ---------------------------------------------------------

    def record(self, site: str, fingerprint: str, duration_s: float,
               hit: bool) -> None:
        prefix = getattr(self._tl, "site_prefix", None)
        if prefix:
            site = f"{prefix}:{site}"
        from ..metrics import (COMPILE_SECONDS_SAVED, JIT_CACHE_HITS,
                               JIT_COMPILES, JIT_COMPILE_SECONDS,
                               JIT_DISTINCT_SHAPES, PREWARM_COMPILES,
                               PREWARM_HITS)
        prewarming = getattr(self._tl, "prewarm", False)
        ev = CompileEvent(site, fingerprint, duration_s if not hit
                          else 0.0, hit, time.time())
        shape_count = None
        saved_s = None
        prewarm_hit = False
        with self._lock:
            self.events.append(ev)
            key = (site, fingerprint)
            e = self._entries.get(key)
            if e is None:
                if len(self._entries) >= self.MAX_ENTRIES:
                    self._entries.popitem(last=False)
                e = self._entries[key] = {
                    "site": site, "fingerprint": fingerprint,
                    "compiles": 0, "hits": 0, "compile_ms": 0.0,
                    "last_compile_ms": 0.0, "last_used": 0.0,
                    "prewarmed": False, "prewarm_hits": 0}
            shapes = self._site_shapes.setdefault(site, set())
            if fingerprint not in shapes:
                shapes.add(fingerprint)
                shape_count = len(shapes)
            e["last_used"] = ev.when
            if hit:
                e["hits"] += 1
                self.total_hits += 1
                if e.get("prewarmed") and not prewarming:
                    prewarm_hit = True
                    e["prewarm_hits"] += 1
                    self.total_prewarm_hits += 1
                    # the first query-path hit claims the avoided
                    # compile wall; later hits were free anyway
                    saved_s = self._prewarm_pending.pop(key, None)
                    if saved_s is not None:
                        self.total_saved_s += saved_s
            else:
                e["compiles"] += 1
                e["compile_ms"] += duration_s * 1000
                e["last_compile_ms"] = duration_s * 1000
                self.total_compiles += 1
                self.total_compile_s += duration_s
                if prewarming:
                    e["prewarmed"] = True
                    self._prewarm_pending[key] = duration_s
                    self.total_prewarmed += 1
        if shape_count is not None:
            JIT_DISTINCT_SHAPES.set(shape_count, site=site)
        if hit:
            JIT_CACHE_HITS.inc(site=site)
            if prewarm_hit:
                PREWARM_HITS.inc()
            if saved_s is not None:
                COMPILE_SECONDS_SAVED.inc(saved_s)
        else:
            JIT_COMPILES.inc(site=site)
            JIT_COMPILE_SECONDS.observe(duration_s)
            if prewarming:
                PREWARM_COMPILES.inc()
            # per-thread attribution: the executor whose dispatch thread
            # triggered the compile owns it
            self._tl.compile_s = getattr(self._tl, "compile_s", 0.0) \
                + duration_s
            stats = getattr(self._tl, "stats", None)
            if stats is not None:
                stats.jit_compiles += 1

    # -- read surface ------------------------------------------------------

    def snapshot(self) -> List[dict]:
        """Per-(site, fingerprint) aggregates, most-recently-used last —
        the /v1/jit and system.runtime.jit_cache payload."""
        with self._lock:
            return [dict(e) for e in self._entries.values()]

    def totals(self) -> dict:
        with self._lock:
            return {"compiles": self.total_compiles,
                    "hits": self.total_hits,
                    "compileSeconds": round(self.total_compile_s, 6),
                    "entries": len(self._entries),
                    "prewarmedPrograms": self.total_prewarmed,
                    "prewarmHits": self.total_prewarm_hits,
                    "compileSecondsSaved": round(self.total_saved_s, 6)}

    def site_shape_counts(self) -> Dict[str, int]:
        """Distinct fingerprints ever recorded per site — what the
        shape-canonicalization lint asserts ceilings over."""
        with self._lock:
            return {s: len(fps) for s, fps in self._site_shapes.items()}

    def clear(self) -> None:
        from ..metrics import JIT_DISTINCT_SHAPES
        with self._lock:
            self.events.clear()
            self._entries.clear()
            self.total_compiles = 0
            self.total_hits = 0
            self.total_compile_s = 0.0
            sites = list(self._site_shapes)
            self._site_shapes.clear()
            self._prewarm_pending.clear()
            self.total_prewarmed = 0
            self.total_prewarm_hits = 0
            self.total_saved_s = 0.0
        for s in sites:
            JIT_DISTINCT_SHAPES.set(0, site=s)


RECORDER = CompileRecorder()


def device_memory_stats() -> dict:
    """Live device memory stats of this process's first CUDA device, in
    the /v1/status heartbeat shape (``torch.cuda.memory_stats``: bytes
    the caching allocator holds in use and its peak, against the card's
    total memory). Without CUDA it returns the platform only, the fields
    0."""
    import torch
    if not torch.cuda.is_available():
        return {"platform": "cpu", "deviceCount": 0, "bytesInUse": 0,
                "bytesLimit": 0, "peakBytesInUse": 0}
    stats = torch.cuda.memory_stats(0)
    return {"platform": "gpu",
            "deviceCount": torch.cuda.device_count(),
            "bytesInUse": int(stats.get("allocated_bytes.all.current", 0)),
            "bytesLimit": int(torch.cuda.get_device_properties(0)
                              .total_memory),
            "peakBytesInUse": int(stats.get("allocated_bytes.all.peak",
                                            0))}
