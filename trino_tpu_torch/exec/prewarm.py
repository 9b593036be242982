"""Cold-start elimination: plan pre-warming + compile-aware routing.

Counterpart of ``trino_tpu/exec/prewarm.py``, with the reference's
``PrewarmEngine`` API and switches. The port's cold start is the nvcc
build of its kernel libraries (``ops/cuda_build.py``) and the first run
of a statement on the card.

1. **Plan pre-warming**: at coordinator start, rank the top-N historical
   plan fingerprints (``server/history.py top_fingerprints``) and run
   each once on the session's device, under the exec lock and
   ``CompileRecorder.prewarm_context()``. Bounded by
   TRINO_TPU_PREWARM_BUDGET_S.
2. **Kernel libraries**: ``warm_shapes`` builds and loads every kernel
   library (``cuda_build.load_all``), so no query pays for nvcc. The
   canonical shape lattice (``canonical_lattice``) is kept for the warm
   manifest.
3. **Compile-aware routing**: while a fingerprint's device run is cold
   (no warm completed, or a prewarm in flight), ``decide_route`` sends
   host-eligible queries to the numpy interpreter and the serving layer
   kicks a background warm; once warm, the fingerprint routes to device.

The engine is OFF unless TRINO_TPU_PREWARM is set truthy (or a caller
enables it explicitly); disabled, ``decide_route`` never sees a cold
signal and no background threads start. Nothing here runs a statement
or a kernel anywhere but on the session's own device.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional

log = logging.getLogger("trino_tpu.prewarm")

DEFAULT_TOP_N = 8
DEFAULT_BUDGET_S = 60.0
# canonical-shape warm ceiling: lattice points above this are rare
# enough (and expensive enough to compile) that only a real plan warm
# should pay for them
DEFAULT_MAX_SHAPE = 1 << 20


def _env_truthy(name: str, default: str = "0") -> bool:
    return os.environ.get(name, default).strip().lower() in (
        "1", "true", "on", "yes")


def prewarm_enabled_by_env() -> bool:
    return _env_truthy("TRINO_TPU_PREWARM")


def canonical_lattice(max_cap: int = DEFAULT_MAX_SHAPE) -> List[int]:
    """Every bucket_capacity lattice point in [1024, max_cap] — the
    enumerable canonical shape set that shape canonicalization buys.
    Two points per octave: 2^k and 1.5*2^k."""
    out = []
    cap = 1024
    while cap <= max_cap:
        out.append(cap)
        half = (cap * 3) // 2
        if half <= max_cap:
            out.append(half)
        cap <<= 1
    return out


def compile_cache_stats() -> dict:
    """Kernel-library cache stats for the /v1/status heartbeat: the
    build directory (``cuda_build.BUILD_DIR``), whether it exists, and
    how many files and bytes it holds. File counting is bounded."""
    from ..ops.cuda_build import BUILD_DIR
    root = str(BUILD_DIR)
    out = {"active": os.path.isdir(root), "dir": root, "files": 0,
           "bytes": 0}
    if out["active"]:
        try:
            with os.scandir(root) as it:
                for i, ent in enumerate(it):
                    if i >= 10000:
                        break
                    if ent.is_file():
                        out["files"] += 1
                        try:
                            out["bytes"] += ent.stat().st_size
                        except OSError:
                            pass
        except OSError:
            pass
    return out


class PrewarmEngine:
    """Coordinator/worker-side prewarm conductor.

    Coordinator wiring (server/coordinator.py CoordinatorState): the
    engine gets the session, the history store, and the dispatcher's
    exec lock; `maybe_start()` launches the AOT warm thread when the
    engine is enabled; `ServingLayer.run_routed` consults
    `device_cold()` through `decide_route` and calls `ensure_warming` /
    `mark_warm` around device runs. Worker wiring (server/worker.py):
    a joining worker builds a detached engine, pulls the coordinator's
    `manifest()` over GET /v1/prewarm, and runs `warm_shapes` before
    its first ACTIVE announce."""

    def __init__(self, session=None, history=None,
                 exec_lock: Optional[threading.Lock] = None,
                 enabled: Optional[bool] = None,
                 top_n: Optional[int] = None,
                 budget_s: Optional[float] = None,
                 run_sql: Optional[Callable[[str], object]] = None):
        self.session = session
        self.history = history
        self.exec_lock = exec_lock
        self.enabled = prewarm_enabled_by_env() if enabled is None \
            else bool(enabled)
        self.top_n = int(os.environ.get("TRINO_TPU_PREWARM_TOP_N",
                                        DEFAULT_TOP_N)) \
            if top_n is None else int(top_n)
        self.budget_s = float(os.environ.get("TRINO_TPU_PREWARM_BUDGET_S",
                                             DEFAULT_BUDGET_S)) \
            if budget_s is None else float(budget_s)
        self._run_sql = run_sql
        self._lock = threading.Lock()
        self._warmed: set = set()          # fingerprints with a warm program
        self._inflight: set = set()        # fingerprints compiling right now
        self._sql_by_fp: Dict[str, str] = {}
        self._threads: List[threading.Thread] = []
        self._deadline: Optional[float] = None
        self.warm_rounds = 0               # completed warm_all passes
        self.shape_warms = 0               # kernel libraries loaded
        self.started_at: Optional[float] = None
        if self.enabled and self.session is not None:
            # the chunked-driver fused-compile warm (exec/chunked.py)
            # rides the same opt-in as the engine itself
            self.session.properties["prewarm_chunks"] = True

    # -- cold/warm state (the router's signal) ------------------------------

    def device_cold(self, fingerprint: Optional[str]) -> bool:
        """True while this fingerprint's device program has not been
        warmed (by prewarm OR by a completed device run). The router
        sends host-eligible queries to the host interpreter for exactly
        this window; `mark_warm` closes it."""
        if not self.enabled or not fingerprint:
            return False
        with self._lock:
            return fingerprint not in self._warmed

    def is_warm(self, fingerprint: str) -> bool:
        with self._lock:
            return fingerprint in self._warmed

    def is_inflight(self, fingerprint: str) -> bool:
        with self._lock:
            return fingerprint in self._inflight

    def mark_warm(self, fingerprint: Optional[str]) -> None:
        """A device program for this fingerprint exists now — either a
        prewarm finished or a query-path device run completed (which
        compiled it on-path)."""
        if not fingerprint:
            return
        with self._lock:
            self._warmed.add(fingerprint)
            self._inflight.discard(fingerprint)

    # -- warming ------------------------------------------------------------

    def _budget_left(self) -> float:
        if self._deadline is None:
            return self.budget_s
        return self._deadline - time.monotonic()

    def warm_fingerprint(self, fingerprint: str, sql: str,
                         context: str = "") -> bool:
        """Warm this statement off the query path: execute it once on the
        session's device under prewarm_context (a kernel library it
        loads records an off-path prewarm compile), then mark the
        fingerprint warm. Returns False when the warm failed or was
        skipped (already warm / in flight / no runner). `context` is the
        triggering query's `query=... trace=...` log prefix, so a warm
        kicked by a served query greps back to it."""
        if not sql:
            return False
        with self._lock:
            if fingerprint in self._warmed or \
                    fingerprint in self._inflight:
                return False
            self._inflight.add(fingerprint)
            self._sql_by_fp.setdefault(fingerprint, sql)
        from .profiler import RECORDER
        ok = False
        try:
            runner = self._run_sql
            if runner is None and self.session is not None:
                runner = self.session.execute
            if runner is None:
                return False
            with RECORDER.prewarm_context():
                if self.exec_lock is not None:
                    with self.exec_lock:
                        runner(sql)
                else:
                    runner(sql)
            ok = True
        except Exception as e:    # noqa: BLE001 — warming is best-effort
            log.warning("%sprewarm of %s failed: %s", context,
                        fingerprint, e)
        finally:
            with self._lock:
                self._inflight.discard(fingerprint)
                if ok:
                    self._warmed.add(fingerprint)
        return ok

    def ensure_warming(self, fingerprint: str, sql: str,
                       context: str = "") -> None:
        """Kick a background warm for a cold fingerprint the serving
        layer just routed to host. Dedup'd: one warm per fingerprint.
        When the warm completes the fingerprint routes to device."""
        if not self.enabled or not fingerprint or not sql:
            return
        with self._lock:
            if fingerprint in self._warmed or \
                    fingerprint in self._inflight:
                return
        t = threading.Thread(
            target=self.warm_fingerprint,
            args=(fingerprint, sql, context),
            name=f"prewarm-{fingerprint[:8]}", daemon=True)
        t.start()
        self._threads.append(t)

    def warm_all(self) -> int:
        """One AOT pass over the top-N historical fingerprints, bounded
        by the budget. Returns how many statements warmed."""
        if self.history is None:
            return 0
        self._deadline = time.monotonic() + self.budget_s
        warmed = 0
        for ent in self.history.top_fingerprints(self.top_n):
            if self._budget_left() <= 0:
                log.info("prewarm budget exhausted after %d statements",
                         warmed)
                break
            if self.warm_fingerprint(ent["fingerprint"], ent["sql"]):
                warmed += 1
        self.warm_rounds += 1
        return warmed

    def warm_shapes(self, capacities: Optional[List[int]] = None,
                    max_cap: int = DEFAULT_MAX_SHAPE) -> int:
        """Build and load every kernel library under prewarm_context
        (each load records a prewarm compile, or a hit, at
        ``cuda_build.<kernel>``), so no query pays for nvcc. The
        libraries have no shapes: `capacities` and `max_cap` keep the
        reference's signature. A session that is not on CUDA (or no
        session) loads nothing and returns 0; else returns how many
        libraries this call loaded."""
        device = getattr(self.session, "device", None)
        if device is None or device.type != "cuda":
            return 0
        from ..ops import cuda_build
        from .profiler import RECORDER
        with RECORDER.prewarm_context():
            done = cuda_build.load_all()
        self.shape_warms += done
        return done

    def maybe_start(self) -> bool:
        """Launch the startup AOT warm in the background when enabled.
        Returns whether a warm thread started."""
        if not self.enabled or self.history is None:
            return False
        self.started_at = time.time()
        t = threading.Thread(target=self.warm_all, name="prewarm-aot",
                             daemon=True)
        t.start()
        self._threads.append(t)
        return True

    def wait(self, timeout_s: float = 30.0) -> None:
        """Join outstanding warm threads (tests + the worker handshake)."""
        deadline = time.monotonic() + timeout_s
        for t in list(self._threads):
            t.join(timeout=max(0.0, deadline - time.monotonic()))

    # -- read surface -------------------------------------------------------

    def manifest(self) -> dict:
        """The warm-manifest a joining worker pulls before announcing
        ACTIVE: top historical fingerprints (with the SQL to re-plan
        and rank scores) plus the canonical shape lattice."""
        fps = self.history.top_fingerprints(self.top_n) \
            if self.history is not None else []
        return {"enabled": self.enabled,
                "fingerprints": fps,
                "shapes": canonical_lattice(),
                "budget_s": self.budget_s}

    def stats(self) -> dict:
        from .profiler import RECORDER
        with self._lock:
            warmed = len(self._warmed)
            inflight = len(self._inflight)
        t = RECORDER.totals()
        return {"enabled": self.enabled,
                "warmedFingerprints": warmed,
                "inflight": inflight,
                "warmRounds": self.warm_rounds,
                "shapeWarms": self.shape_warms,
                "prewarmedPrograms": t["prewarmedPrograms"],
                "prewarmHits": t["prewarmHits"],
                "compileSecondsSaved": t["compileSecondsSaved"],
                "compileCache": compile_cache_stats()}
