"""Port copy of ``trino_tpu/server/timeline.py`` (no edits).

Critical-path wall-time attribution for completed queries.

Reference: Trino's QueryStats carry queued/analysis/planning/execution
time splits and EXPLAIN ANALYZE prints per-stage wall; what it does not
do — and what the ≥5x device-speedup story needs — is a per-query
attribution that says WHERE elapsed wall went: admission queue, planner,
scheduler overhead, exchange waits, device compute, host compute,
compile, spill, retry overhead, write-commit.

The discipline is the round-10 device/host/compile invariant, applied to
the whole query: every phase estimate is clipped into the elapsed-wall
budget and the residual lands in `other`, so the reported phases ALWAYS
sum exactly to elapsed wall (tier-1 asserts it). Estimates come from the
best available source and degrade gracefully:

- queued:     state-machine timestamps (stamped on every transition), so
              admission holds show up even untraced;
- plan/retry/write-commit/schedule: coordinator spans when tracing is on
  (plan-distributed, per-attempt query spans, write-commit, stage spans);
- device/host/compile: the per-stage BLOCKING task (max wall) of the
  scheduler's TaskStats rollup — profiled runs split its wall into
  device + compile + host-rest, unprofiled runs ride in host;
- exchange-wait: the largest per-task sum of adopted worker
  `exchange-pull` spans (the blocking task's wait, not the overcounted
  concurrent total).

The blocking critical path across concurrent stages is computed from the
coordinator stage spans: overlapping intervals form a concurrency group
and the longest member of each group is charged (the classic
program-activity-graph reduction).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

PHASES = ("queued", "plan", "schedule", "exchange-wait", "device", "host",
          "compile", "spill", "retry", "write-commit", "other")

_PLAN_SPANS = ("plan", "optimize", "plan-distributed")
# coordinator stage spans -> the scheduler's task-rollup stage keys
_STAGE_SPANS = {"source-stage": "source",
                "partitioned-exchange": "partitioned",
                "final-stage": None,
                "distributed-write": None}


def _dur_s(span: dict) -> float:
    return max(0.0, float(span.get("durationMs", 0.0)) / 1000.0)


def _start_s(span: dict) -> float:
    return float(span.get("startTimeUnixNano", 0)) / 1e9


def _stage_key(span: dict) -> Optional[str]:
    name = span.get("name")
    if name == "build-stage":
        frag = (span.get("attributes") or {}).get("fragment")
        return f"build-{frag}"
    return _STAGE_SPANS.get(name)


def stage_intervals(spans: List[dict]) -> List[dict]:
    """Coordinator stage spans as [{'name','start','end'}] intervals on
    one clock (the coordinator's), the critical-path input."""
    out = []
    for s in spans or ():
        name = s.get("name")
        if name in _STAGE_SPANS or name == "build-stage":
            start = _start_s(s)
            label = name
            if name == "build-stage":
                frag = (s.get("attributes") or {}).get("fragment")
                label = f"build-stage[{frag}]"
            out.append({"name": label, "start": start,
                        "end": start + _dur_s(s)})
    return out


def critical_path(intervals: List[dict]) -> Tuple[float, List[dict]]:
    """Blocking path through possibly-concurrent intervals: transitively
    overlapping intervals form a concurrency group; each group charges
    only its LONGEST member (the blocker), sequential groups sum.
    Returns (total_seconds, [{'name','seconds'}] in time order)."""
    ivs = sorted((i for i in intervals or () if i["end"] >= i["start"]),
                 key=lambda i: (i["start"], i["end"]))
    picks: List[dict] = []
    total = 0.0
    group: List[dict] = []
    group_end = float("-inf")
    for iv in ivs + [None]:
        if iv is not None and (not group or iv["start"] < group_end):
            group.append(iv)
            group_end = max(group_end, iv["end"])
            continue
        if group:
            blocker = max(group, key=lambda i: i["end"] - i["start"])
            seconds = blocker["end"] - blocker["start"]
            picks.append({"name": blocker["name"],
                          "seconds": round(seconds, 6)})
            total += seconds
        if iv is not None:
            group = [iv]
            group_end = iv["end"]
        else:
            group = []
    return total, picks


def _exchange_wait_s(spans: List[dict]) -> float:
    """The blocking exchange wait: worker `exchange-pull` spans grouped
    by their parent (worker-task) span; the largest per-task sum is the
    wait the query could not overlap away."""
    groups: Dict[object, float] = {}
    for s in spans or ():
        if s.get("name") == "exchange-pull":
            groups[s.get("parentSpanId")] = \
                groups.get(s.get("parentSpanId"), 0.0) + _dur_s(s)
    return max(groups.values()) if groups else 0.0


def attribute_phases(wall_s: float, queued_s: float,
                     spans: Optional[List[dict]],
                     stage_stats: Optional[dict],
                     write_stats: Optional[dict] = None) -> Dict[str, float]:
    """Split `wall_s` into the PHASES dict. The invariant every caller
    (and tier-1) relies on: sum(result.values()) == wall_s exactly —
    estimates are proportionally scaled into the budget and the residual
    is `other`."""
    wall_s = max(0.0, wall_s)
    spans = spans or []
    lq = stage_stats or {}
    ph = {p: 0.0 for p in PHASES}
    ph["queued"] = min(max(0.0, queued_s), wall_s)

    for s in spans:
        if s.get("name") in _PLAN_SPANS:
            ph["plan"] += _dur_s(s)

    # retry overhead: every non-final per-attempt `query` span
    attempts = sorted((s for s in spans if s.get("name") == "query"),
                      key=_start_s)
    for s in attempts[:-1]:
        ph["retry"] += _dur_s(s)

    commit_spans = [s for s in spans if s.get("name") == "write-commit"]
    if commit_spans:
        ph["write-commit"] = sum(_dur_s(s) for s in commit_spans)
    elif write_stats and write_stats.get("commit_s"):
        ph["write-commit"] = max(0.0, float(write_stats["commit_s"]))

    # per-stage blocking-task attribution from the TaskStats rollup
    stages: Dict[str, List[dict]] = {}
    for rec in lq.get("tasks", ()):
        stages.setdefault(rec.get("stage") or "source", []).append(rec)
    span_by_stage: Dict[str, float] = {}
    for s in spans:
        key = _stage_key(s)
        if key is not None:
            span_by_stage[key] = span_by_stage.get(key, 0.0) + _dur_s(s)
    host_raw = 0.0
    for key, recs in stages.items():
        blocking = max(recs, key=lambda r: r.get("wall_ms", 0.0))
        bw = max(0.0, blocking.get("wall_ms", 0.0) / 1000.0)
        dev = max(0.0, blocking.get("device_ms", 0.0) / 1000.0)
        comp = max(0.0, blocking.get("compile_ms", 0.0) / 1000.0)
        ph["device"] += dev
        ph["compile"] += comp
        host_raw += max(0.0, bw - dev - comp)
        stage_span = span_by_stage.get(key)
        if stage_span is not None:
            ph["schedule"] += max(0.0, stage_span - bw)
    # final-stage / write orchestration wall with no task rollup behind
    # it is scheduler overhead too
    for s in spans:
        if s.get("name") == "final-stage":
            ph["schedule"] += _dur_s(s)

    exch = _exchange_wait_s(spans)
    ph["exchange-wait"] = exch
    # exchange pulls happen inside the blocking tasks' wall: subtract so
    # the wait is not double-counted against host
    ph["host"] = max(0.0, host_raw - exch)

    # clip the sub-phases into the busy budget, residual -> other
    busy = max(0.0, wall_s - ph["queued"])
    sub = [p for p in PHASES if p not in ("queued", "other")]
    total_sub = sum(ph[p] for p in sub)
    if total_sub > busy and total_sub > 0.0:
        factor = busy / total_sub
        for p in sub:
            ph[p] *= factor
    # exact-sum discipline: drive sum(ph.values()) to wall_s via the
    # residual, compensating float rounding until equality holds
    ph["other"] = 0.0
    for _ in range(8):
        diff = wall_s - sum(ph.values())
        if diff == 0.0:
            break
        ph["other"] += diff
    if ph["other"] < 0.0:
        # residual can only go negative by float dust after scaling;
        # fold it into the largest sub-phase so no phase is negative
        big = max(sub, key=lambda p: ph[p])
        ph[big] += ph["other"]
        ph["other"] = 0.0
        for _ in range(8):
            diff = wall_s - sum(ph.values())
            if diff == 0.0:
                break
            ph[big] += diff
    return ph


def dominant_phase(phases: Dict[str, float]) -> str:
    """The phase holding the most wall — `other` only wins when nothing
    attributable beats it (ties break toward the attributed phase)."""
    if not phases:
        return ""
    best = max((p for p in phases if p != "other"),
               key=lambda p: phases.get(p, 0.0), default="other")
    if phases.get("other", 0.0) > phases.get(best, 0.0):
        return "other"
    return best


def breakdown_line(phases: Dict[str, float], wall_s: float) -> str:
    """The EXPLAIN ANALYZE surface: `critical path: queued Q + ... = W`.
    Zero phases are elided (other always prints so the sum is visible)."""
    parts = [f"{p} {phases.get(p, 0.0) * 1000:.1f}ms"
             for p in PHASES if phases.get(p, 0.0) > 0.0 or p == "other"]
    return ("critical path: " + " + ".join(parts) +
            f" = {wall_s * 1000:.1f}ms")


def build_timeline(tq) -> dict:
    """Full timeline for a TrackedQuery: phase attribution (sums exactly
    to elapsed wall), the dominant phase, and the blocking critical path
    over coordinator stage spans. Works untraced (state-machine stamps +
    TaskStats rollup); spans only enrich it."""
    sm = tq.state_machine
    created = sm.created_at
    ended = sm.ended_at if sm.ended_at is not None else time.time()
    wall = max(0.0, ended - created)
    state_times = getattr(sm, "state_times", {}) or {}
    if "PLANNING" in state_times:
        queued = max(0.0, state_times["PLANNING"] - created)
    elif sm.is_done():
        # the query died while QUEUED (queued-time deadline, queue-full
        # rejection, cancel-before-dispatch): every second of its wall
        # was queue wait — charging zero here would silently launder
        # admission holds into `other`
        queued = wall
    else:
        queued = 0.0
    spans = tq.trace
    if spans is None and getattr(tq, "tracer", None) is not None:
        spans = tq.tracer.export()
    lq = getattr(tq, "stage_stats", None) or {}
    phases = attribute_phases(wall, queued, spans, lq, lq.get("write"))
    cp_total, cp = critical_path(stage_intervals(spans or []))
    return {"queryId": tq.query_id,
            "state": sm.state,
            "wall_s": wall,
            "phases": phases,
            "dominant": dominant_phase(phases),
            "criticalPath": cp,
            "criticalPathSeconds": round(cp_total, 6),
            "breakdown": breakdown_line(phases, wall)}
