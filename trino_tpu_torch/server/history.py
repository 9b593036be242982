"""Port copy of ``trino_tpu/server/history.py`` (one edit:
``_default_path`` names the file ``query_history_torch.jsonl``, so
neither package routes on the other's medians).

Query history store + latency-regression detection.

Reference: the reference engine keeps completed QueryInfo in the
QueryTracker's bounded ring (query.min-expire-age) and ships
QueryCompletedEvents to listener plugins; slow-query logs and history
tables are built on top of that event stream. Here both live
coordinator-side: a persistent JSONL ring of completed-query records
keyed by *plan fingerprint* (normalized statement hash), and a detector
that compares each completed query's latency / bytes-shuffled / spill
counters against its fingerprint's robust baseline (median + MAD — the
estimator that ignores a few outliers instead of chasing them).

Flow: QueryCompletedEvent -> HistoryEventListener -> store.record()
(dedup by query id; the QueryTracker's eviction flush calls the same
path, so stats survive the tracker's max_history cap). A flagged
regression emits one slow-query log line, increments
trino_tpu_query_latency_regressions_total, and marks the record —
`system.runtime.query_history` serves the ring, and
`bench.py --check-regressions` applies the same median+MAD rule across
BENCH_r*.json rounds.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import threading
import time
from collections import deque
from typing import Dict, List, Optional

log = logging.getLogger("trino_tpu.history")

# per-fingerprint baseline rules (shared with bench --check-regressions):
# flag when the value exceeds BOTH the ratio gate (median * RATIO) and
# the robust spread gate (median + MAD_K * 1.4826 * MAD) — the ratio
# alone fires on tiny-median jitter, the MAD alone on tight baselines
MIN_BASELINE = 5            # prior finished records before judging
RATIO = 2.0
MAD_K = 6.0
MAD_SCALE = 1.4826          # MAD -> sigma for normal data
# per-metric floors below which differences are noise, not regressions
FLOORS = {"elapsed_s": 0.005, "bytes_shuffled": 1 << 16, "spills": 0}
METRICS = ("elapsed_s", "bytes_shuffled", "spills")


def plan_fingerprint(sql: str) -> str:
    """Stable statement-shape key: normalized SQL text (lower-cased,
    whitespace-collapsed, trailing ';' stripped), hashed. Two
    submissions of the same statement share a fingerprint regardless of
    formatting — the history analog of the executor's wire-form plan
    hash, computable without planning."""
    norm = re.sub(r"\s+", " ", sql.strip().rstrip(";").lower())
    return hashlib.sha256(norm.encode()).hexdigest()[:16]


def robust_baseline(values: List[float]) -> tuple:
    """(median, MAD) of a sample."""
    vs = sorted(values)
    n = len(vs)
    med = vs[n // 2] if n % 2 else (vs[n // 2 - 1] + vs[n // 2]) / 2
    devs = sorted(abs(v - med) for v in vs)
    mad = devs[n // 2] if n % 2 else (devs[n // 2 - 1] + devs[n // 2]) / 2
    return med, mad


def is_regressed(value: float, median: float, mad: float,
                 floor: float = 0.0, ratio: float = RATIO,
                 mad_k: float = MAD_K) -> bool:
    """The shared regression rule (history detector AND the bench
    gate): past the ratio gate AND outside the MAD envelope, with a
    floor so sub-noise medians never judge."""
    if median <= floor:
        return False
    return value > median * ratio and \
        (value - median) > max(mad_k * MAD_SCALE * mad, 0.05 * median)


def _default_path() -> str:
    env = os.environ.get("TRINO_TPU_HISTORY_PATH")
    if env:
        return env
    from ..connectors.diskcache import cache_root
    return os.path.join(cache_root(), "query_history_torch.jsonl")


class QueryHistoryStore:
    """Persistent JSONL ring of completed-query records.

    One record per completed query: {query_id, fingerprint, sql, state,
    user, elapsed_s, rows, bytes_shuffled, spills, end_time,
    regressed}. The file is append-only until the ring overflows, then
    rewritten atomically from the in-memory tail — corruption or a
    missing file just means an empty baseline, never an error."""

    PER_FINGERPRINT = 64        # baseline window per statement shape

    def __init__(self, path: Optional[str] = None,
                 max_records: int = 4096):
        self.path = _default_path() if path is None else path
        self.max_records = max_records
        self._lock = threading.Lock()
        self.records: "deque[dict]" = deque(maxlen=max_records)
        self._by_fp: Dict[str, "deque[dict]"] = {}
        self._ids: set = set()
        self._appended_since_rewrite = 0
        self._load()

    # -- persistence -------------------------------------------------------

    def _load(self) -> None:
        if not self.path or not os.path.isfile(self.path):
            return
        try:
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue          # torn write: skip the line
                    if isinstance(rec, dict) and rec.get("query_id"):
                        self._remember(rec)
        except OSError:
            pass

    def _remember(self, rec: dict) -> None:
        self.records.append(rec)
        self._ids.add(rec["query_id"])
        fp = rec.get("fingerprint", "")
        dq = self._by_fp.get(fp)
        if dq is None:
            dq = self._by_fp[fp] = deque(maxlen=self.PER_FINGERPRINT)
        dq.append(rec)

    def _append_file(self, rec: dict) -> None:
        if not self.path:
            return
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            # ring rewrite: once the file has grown well past the
            # in-memory cap, rewrite it from the retained tail so the
            # on-disk ring stays bounded too
            self._appended_since_rewrite += 1
            if self._appended_since_rewrite >= self.max_records:
                tmp = self.path + f".tmp{os.getpid()}"
                with open(tmp, "w") as f:
                    for r in self.records:
                        f.write(json.dumps(r) + "\n")
                os.replace(tmp, self.path)
                self._appended_since_rewrite = 0
                return
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            pass                          # history is best-effort

    # -- recording + detection ---------------------------------------------

    def baseline(self, fingerprint: str,
                 metric: str = "elapsed_s") -> Optional[tuple]:
        """(median, mad, n) over this fingerprint's prior FINISHED
        records, or None below the minimum sample size."""
        with self._lock:
            vals = [float(r.get(metric, 0) or 0)
                    for r in self._by_fp.get(fingerprint, ())
                    if r.get("state") == "FINISHED"]
        if len(vals) < MIN_BASELINE:
            return None
        med, mad = robust_baseline(vals)
        return med, mad, len(vals)

    def check(self, rec: dict) -> Optional[dict]:
        """Compare one completed record against its fingerprint's
        baseline; returns {metric, value, median, mad, n} for the first
        regressed metric, or None."""
        if rec.get("state") != "FINISHED":
            return None
        fp = rec.get("fingerprint", "")
        for metric in METRICS:
            base = self.baseline(fp, metric)
            if base is None:
                continue
            med, mad, n = base
            val = float(rec.get(metric, 0) or 0)
            if is_regressed(val, med, mad, floor=FLOORS.get(metric, 0)):
                return {"metric": metric, "value": val, "median": med,
                        "mad": mad, "n": n}
        return None

    def record(self, rec: dict) -> Optional[dict]:
        """Append one completed-query record (idempotent per query id);
        returns the regression verdict when the detector flags it."""
        if not rec.get("query_id"):
            return None
        rec = dict(rec)
        rec.setdefault("fingerprint", plan_fingerprint(rec.get("sql", "")))
        rec.setdefault("end_time", time.time())
        with self._lock:
            if rec["query_id"] in self._ids:
                return None               # completion event already did it
        regression = self.check(rec)
        rec["regressed"] = bool(regression)
        with self._lock:
            if rec["query_id"] in self._ids:
                return None
            self._remember(rec)
            self._append_file(rec)
        from ..metrics import HISTORY_RECORDS, LATENCY_REGRESSIONS
        HISTORY_RECORDS.inc()
        if regression:
            LATENCY_REGRESSIONS.inc()
            from ..utils.log import query_context
            dominant = rec.get("dominant_phase") or "unattributed"
            log.warning(
                "%sslow query (fingerprint %s): %s=%.4g vs baseline "
                "median %.4g (MAD %.4g over %d runs), wall dominated by "
                "%s: %s",
                query_context(rec["query_id"]), rec["fingerprint"],
                regression["metric"], regression["value"],
                regression["median"], regression["mad"],
                regression["n"], dominant, (rec.get("sql") or "")[:200])
        return regression

    def record_tracked(self, tq) -> None:
        """Eviction flush (QueryTracker.on_evict): persist a tracked
        query's stats before the tracker forgets it. A no-op when the
        completion event already recorded the query."""
        try:
            st = getattr(tq, "stage_stats", None) or {}
            self.record({
                "query_id": tq.query_id,
                "sql": tq.sql,
                "user": tq.session_user,
                "tenant": getattr(tq, "tenant", "default"),
                "state": tq.state,
                "elapsed_s": float(tq.elapsed_s),
                "rows": int(tq.rows_returned),
                "bytes_shuffled": int(st.get("bytes_shuffled", 0)),
                "spills": int(getattr(tq, "spills", 0)),
                "dominant_phase": (getattr(tq, "timeline", None) or
                                   {}).get("dominant", ""),
                # live-observability post-mortem context: how far the
                # query got (1.0 when FINISHED) and the stage that held
                # the most in-flight work when it ended — the fields an
                # OOM-killed query's autopsy starts from
                "progress_ratio": (1.0 if tq.state == "FINISHED" else
                                   float(getattr(tq, "progress_ratio",
                                                 0.0))),
                "dominant_stage": getattr(tq, "dominant_stage", ""),
            })
        except Exception:    # noqa: BLE001 — eviction must never fail
            log.exception("history eviction flush failed for %s",
                          getattr(tq, "query_id", "?"))

    # -- read surface ------------------------------------------------------

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self.records]

    def top_fingerprints(self, n: int = 8) -> List[dict]:
        """Rank fingerprints by frequency x recency over the ring — the
        prewarm engine's pick list (exec/prewarm.py) and the rank/score
        columns of system.runtime.query_history.

        Score: each FINISHED record contributes 2^(-age/half_life)
        with a one-hour half life, so a shape run 50 times yesterday
        still outranks a one-off from a minute ago, but dead shapes
        decay out of the top-N instead of pinning prewarm budget
        forever. Returns [{fingerprint, sql, count, last_end_time,
        score}] best-first; `sql` is the most recent FINISHED text for
        the shape (what prewarm re-plans)."""
        half_life_s = 3600.0
        now = time.time()
        agg: Dict[str, dict] = {}
        with self._lock:
            for r in self.records:
                if r.get("state") != "FINISHED":
                    continue
                fp = r.get("fingerprint", "")
                if not fp or not r.get("sql"):
                    continue
                end = float(r.get("end_time", now) or now)
                ent = agg.get(fp)
                if ent is None:
                    ent = agg[fp] = {"fingerprint": fp, "sql": r["sql"],
                                     "count": 0, "last_end_time": 0.0,
                                     "score": 0.0}
                ent["count"] += 1
                ent["score"] += 2.0 ** (-max(0.0, now - end) /
                                        half_life_s)
                if end >= ent["last_end_time"]:
                    ent["last_end_time"] = end
                    ent["sql"] = r["sql"]
        ranked = sorted(agg.values(),
                        key=lambda e: (-e["score"], -e["count"],
                                       e["fingerprint"]))
        return ranked[:max(0, int(n))]

    def for_fingerprint(self, fingerprint: str) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self._by_fp.get(fingerprint, ())]

    def __len__(self) -> int:
        with self._lock:
            return len(self.records)


class HistoryEventListener:
    """EventListener feeding the store from QueryCompletedEvent — the
    same SPI surface billing/SLO listeners use, so history never needs
    to scrape /v1/query."""

    def __init__(self, store: QueryHistoryStore):
        self.store = store

    def query_created(self, event) -> None:
        pass

    def query_completed(self, event) -> None:
        self.store.record({
            "query_id": event.query_id,
            "sql": event.sql,
            "user": event.user,
            "tenant": getattr(event, "tenant", "default"),
            "state": event.state,
            "elapsed_s": float(event.elapsed_s),
            "rows": int(event.rows),
            "bytes_shuffled": int(event.bytes_shuffled),
            "spills": int(getattr(event, "spills", 0)),
            "dominant_phase": getattr(event, "dominant_phase", ""),
            "progress_ratio": float(getattr(event, "progress_ratio",
                                            0.0)),
            "dominant_stage": getattr(event, "dominant_stage", ""),
            "end_time": event.end_time,
        })
