"""Port copy of ``trino_tpu/server/telemetry.py`` (no edits).

Cluster flight recorder: bounded in-process metric time series.

Reference: Trino ships point-in-time counters over JMX/OpenMetrics and
leaves retention to an external scraper; the soak/SLO tooling here needs
p99-over-time *without* a Prometheus deployment, so each node keeps a
small delta-encoded ring of registry samples (the "flight recorder") and
the coordinator federates worker rings into cluster-wide series.

Design:
- `FlightRecorder` walks the process `MetricsRegistry` at a configurable
  interval. Counters and histogram slots are stored as per-interval
  DELTAS (rate numerators); gauges as current values. A sample only
  carries keys whose value moved since the previous sample, so an idle
  cluster costs a timestamp per tick.
- The ring is byte-bounded: each sample's encoded size is tracked and the
  oldest samples are evicted (counted in
  trino_tpu_telemetry_ring_evictions_total) until the ring fits
  `max_bytes`. Memory use therefore cannot grow with uptime.
- The sampler THREAD only exists when an interval is configured
  (`TRINO_TPU_TELEMETRY_INTERVAL_S` or an explicit constructor value) —
  the default path adds zero threads and zero samples.
- Federation: workers serve `GET /v1/telemetry?since=<ts>` (internal
  route class); `ClusterTelemetry.collect()` scrapes every registered
  node incrementally (per-node `since` cursors) and merges the samples
  into one bounded cluster series served via
  system.runtime.metrics_history and consumed by `bench.py --soak`.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..metrics import REGISTRY, Histogram

DEFAULT_MAX_BYTES = 256 * 1024


def _interval_from_env() -> float:
    import os
    try:
        return float(os.environ.get("TRINO_TPU_TELEMETRY_INTERVAL_S", "0"))
    except ValueError:
        return 0.0


def registry_series_snapshot(registry=None) -> Dict[str, float]:
    """{metric-key: value} over every family in the registry.

    Keys are `name|labelval|...`; histograms contribute their cumulative
    bucket counts (`name_bucket|...|le`), `name_count` and `name_sum`
    slots so a per-interval delta of two snapshots is a well-formed
    per-interval histogram (the p99-over-time input).
    """
    registry = registry or REGISTRY
    out: Dict[str, float] = {}
    with registry._lock:
        metrics = list(registry._metrics.items())
    for name, m in metrics:
        if isinstance(m, Histogram):
            with m._lock:
                hists = [(k, list(h)) for k, h in m._hists.items()]
            for key, h in hists:
                prefix = "|".join((name,) + key)
                for i, b in enumerate(m.buckets):
                    out[f"{prefix}_bucket|le={b}"] = h[i]
                out[f"{prefix}_bucket|le=+Inf"] = h[-2]
                out[f"{prefix}_count"] = h[-2]
                out[f"{prefix}_sum"] = h[-1]
        else:
            with m._lock:
                vals = list(m._values.items())
            for key, v in vals:
                out["|".join((name,) + key)] = v
    return out


def _metric_kinds(registry=None) -> Dict[str, str]:
    registry = registry or REGISTRY
    with registry._lock:
        return {name: m.kind for name, m in registry._metrics.items()}


class FlightRecorder:
    """One node's bounded, delta-encoded metric ring."""

    def __init__(self, node_id: str, interval_s: Optional[float] = None,
                 max_bytes: int = DEFAULT_MAX_BYTES, registry=None):
        self.node_id = node_id
        self.interval_s = (_interval_from_env() if interval_s is None
                           else float(interval_s))
        self.max_bytes = int(max_bytes)
        self.registry = registry or REGISTRY
        self._ring: "deque[dict]" = deque()
        self._bytes = 0
        self._prev: Dict[str, float] = {}
        self._prev_ts: Optional[float] = None
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- sampling ---------------------------------------------------------

    def sample_once(self, now: Optional[float] = None) -> dict:
        """Take one sample: gauges by value, counters/histogram slots as
        deltas since the previous sample; store only keys that moved."""
        from ..metrics import TELEMETRY_SAMPLES
        now = time.time() if now is None else now
        snap = registry_series_snapshot(self.registry)
        kinds = _metric_kinds(self.registry)
        with self._lock:
            values: Dict[str, float] = {}
            for key, v in snap.items():
                name = key.split("|", 1)[0]
                kind = kinds.get(name)
                if kind is None:
                    # histogram slot keys carry suffixes; resolve by the
                    # longest registered prefix
                    for suffix in ("_bucket", "_count", "_sum"):
                        if name.endswith(suffix):
                            kind = kinds.get(name[: -len(suffix)])
                            break
                prev = self._prev.get(key)
                if kind == "gauge":
                    if prev is None or v != prev:
                        values[key] = v
                else:                      # counter / histogram slot
                    delta = v - (prev or 0.0)
                    if delta:
                        values[key] = delta
            interval = (now - self._prev_ts) if self._prev_ts else 0.0
            self._prev = snap
            self._prev_ts = now
            sample = {"ts": now, "interval_s": round(interval, 6),
                      "values": values}
            cost = self._estimate_bytes(sample)
            self._ring.append(sample)
            self._bytes += cost
            sample["_bytes"] = cost
            evicted = 0
            while self._bytes > self.max_bytes and len(self._ring) > 1:
                old = self._ring.popleft()
                self._bytes -= old.get("_bytes", 0)
                evicted += 1
        TELEMETRY_SAMPLES.inc()
        if evicted:
            from ..metrics import TELEMETRY_RING_EVICTIONS
            TELEMETRY_RING_EVICTIONS.inc(evicted)
        return sample

    @staticmethod
    def _estimate_bytes(sample: dict) -> int:
        # a JSON encode is the honest cost model: the ring is served as
        # JSON and the estimate is what eviction budgets against
        return len(json.dumps(
            {k: v for k, v in sample.items() if k != "_bytes"},
            separators=(",", ":")))

    # -- reads ------------------------------------------------------------

    def since(self, ts: float = 0.0) -> List[dict]:
        with self._lock:
            return [{"ts": s["ts"], "interval_s": s["interval_s"],
                     "values": dict(s["values"])}
                    for s in self._ring if s["ts"] > ts]

    def ring_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def sample_count(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- sampler lifecycle ------------------------------------------------

    @property
    def sampling(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "FlightRecorder":
        """Start the sampler thread — only when an interval is
        configured; the default (interval 0) stays thread-free."""
        if self.interval_s <= 0 or self.sampling:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f"telemetry-{self.node_id}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 — telemetry never kills a node
                pass


class ClusterTelemetry:
    """Coordinator-side federation: the local recorder plus incremental
    scrapes of every registered worker's /v1/telemetry ring, merged into
    one bounded cluster series of (ts, node, metric, value) rows."""

    def __init__(self, recorder: FlightRecorder, nodes_fn,
                 max_rows: int = 200_000):
        self.recorder = recorder
        self._nodes_fn = nodes_fn          # -> [(node_id, uri)]
        self._rows: "deque[tuple]" = deque(maxlen=max_rows)
        self._cursors: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- federation loop (only runs when an interval is configured) -------

    @property
    def collecting(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "ClusterTelemetry":
        if self.recorder.interval_s <= 0 or self.collecting:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="telemetry-federation", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2)

    def _loop(self) -> None:
        while not self._stop.wait(self.recorder.interval_s):
            try:
                self.collect()
            except Exception:  # noqa: BLE001 — telemetry never kills a node
                pass

    def _merge(self, node_id: str, samples: List[dict]) -> None:
        with self._lock:
            for s in samples:
                ts = s["ts"]
                self._cursors[node_id] = max(
                    self._cursors.get(node_id, 0.0), ts)
                for key, v in s.get("values", {}).items():
                    self._rows.append((ts, node_id, key, float(v)))

    def collect(self, sample_local: bool = True) -> int:
        """One federation round: sample the local ring, then scrape every
        worker incrementally. Returns the number of nodes that answered
        (coordinator included). Unreachable workers are skipped — the
        series gaps instead of the collector failing."""
        answered = 0
        if sample_local:
            try:
                self.recorder.sample_once()
            except Exception:  # noqa: BLE001
                pass
        local_id = self.recorder.node_id
        self._merge(local_id,
                    self.recorder.since(self._cursors.get(local_id, 0.0)))
        answered += 1
        from urllib.request import Request, urlopen

        from .security import internal_headers
        for node_id, uri in list(self._nodes_fn()):
            cursor = self._cursors.get(node_id, 0.0)
            try:
                req = Request(f"{uri}/v1/telemetry?since={cursor}",
                              headers=internal_headers())
                with urlopen(req, timeout=5) as resp:
                    doc = json.loads(resp.read().decode())
                self._merge(node_id, doc.get("samples", []))
                answered += 1
            except Exception:  # noqa: BLE001 — a dead worker gaps the series
                continue
        return answered

    def rows(self, since: float = 0.0,
             metric: Optional[str] = None) -> List[tuple]:
        """(ts, node, metric-key, value) rows, oldest first. `metric`
        filters by family-name prefix of the key."""
        with self._lock:
            out = [r for r in self._rows if r[0] > since]
        if metric:
            out = [r for r in out if r[2] == metric or
                   r[2].startswith(metric + "|") or
                   r[2].startswith(metric + "_")]
        return out

    def series(self, metric: str, node: Optional[str] = None) -> List[tuple]:
        """[(ts, value)] for one metric key prefix, optionally one node."""
        return [(ts, v) for ts, n, k, v in self.rows(metric=metric)
                if node is None or n == node]


# -- series math: the soak gate's per-interval percentile estimator --------

def percentile_from_buckets(bucket_deltas, quantile: float) -> Optional[float]:
    """Prometheus-style histogram_quantile over per-interval bucket
    deltas: [(upper_bound, count)] cumulative within the interval,
    linear interpolation inside the winning bucket. Returns None for an
    empty interval."""
    buckets = sorted(((float("inf") if b in ("+Inf", float("inf")) else
                       float(b)), c) for b, c in bucket_deltas)
    if not buckets:
        return None
    total = buckets[-1][1]
    if total <= 0:
        return None
    rank = quantile * total
    lo_bound, lo_count = 0.0, 0.0
    for bound, count in buckets:
        if count >= rank:
            if bound == float("inf"):
                return lo_bound
            span = count - lo_count
            frac = (rank - lo_count) / span if span > 0 else 1.0
            return lo_bound + (bound - lo_bound) * frac
        lo_bound, lo_count = bound, count
    return lo_bound


def histogram_deltas(samples: List[dict], family: str,
                     labelval: Optional[str] = None) -> List[dict]:
    """Per-interval bucket deltas of one histogram family from a list of
    flight-recorder samples: [{'ts', 'interval_s', 'buckets': [(le,
    delta)], 'count', 'sum'}] — the input `percentile_from_buckets`
    wants, one entry per sample that saw observations."""
    prefix = family + ("|" + labelval if labelval else "")
    out = []
    for s in samples:
        buckets, count, total = [], 0.0, 0.0
        for key, v in s.get("values", {}).items():
            if not key.startswith(prefix):
                continue
            rest = key[len(prefix):]
            if rest.startswith("_bucket|le="):
                buckets.append((rest[len("_bucket|le="):], v))
            elif rest == "_count":
                count = v
            elif rest == "_sum":
                total = v
        if buckets and count > 0:
            out.append({"ts": s["ts"], "interval_s": s.get("interval_s", 0),
                        "buckets": buckets, "count": count, "sum": total})
    return out
