"""Port copy of ``trino_tpu/events.py`` (no edits).

Event listener SPI.

Reference: spi/eventlistener (QueryCreatedEvent / QueryCompletedEvent /
SplitCompletedEvent) dispatched by EventListenerManager
(eventlistener/EventListenerManager.java:56) to plugins (http, kafka,
mysql, openlineage). Here: the same contract as a Python protocol; the
coordinator dispatches on query creation and completion. Completion events
carry the distributed execution rollup (stages/tasks/bytes shuffled/faults
survived) so a listener can build billing or SLO pipelines without
scraping /v1/query.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import List, Optional

log = logging.getLogger("trino_tpu.events")


@dataclass(frozen=True)
class QueryCreatedEvent:
    query_id: str
    user: str
    sql: str
    create_time: float
    tenant: str = "default"       # resource-group tenant (audit label)


@dataclass(frozen=True)
class QueryCompletedEvent:
    query_id: str
    user: str
    sql: str
    state: str                    # FINISHED | FAILED | CANCELED
    error: Optional[str]
    elapsed_s: float
    rows: int
    retries: int
    end_time: float
    # distributed-execution rollup (0 when the query ran coordinator-local)
    stages: int = 0
    tasks: int = 0
    bytes_shuffled: int = 0
    faults_survived: int = 0      # task retries + checksum rejections
    hedges_fired: int = 0
    spills: int = 0               # spill-tier activations (history +
                                  # regression-detector input)
    tenant: str = "default"       # resource-group tenant (audit label)
    # exactly-once write rollup (zero/empty for read queries)
    written_rows: int = 0
    written_bytes: int = 0
    commit_phase: str = ""        # "committed" | "aborted" | ""
    # critical-path attribution (server/timeline.py): the phase holding
    # the most elapsed wall, "" when no timeline was built
    dominant_phase: str = ""
    # live observability (server/livestats.py): the last split-weighted
    # progress the heartbeat fold computed (1.0 for FINISHED; an
    # OOM-killed query records how far it got) and the in-flight stage
    # that held the most remaining work when the query ended
    progress_ratio: float = 0.0
    dominant_stage: str = ""


class EventListener:
    """Subclass and override; both hooks are optional (the SPI's default
    methods)."""

    def query_created(self, event: QueryCreatedEvent) -> None:
        pass

    def query_completed(self, event: QueryCompletedEvent) -> None:
        pass


class EventListenerManager:
    def __init__(self):
        self._listeners: List[EventListener] = []
        self._logged: set = set()

    def register(self, listener: EventListener) -> None:
        self._listeners.append(listener)

    def _dispatch(self, hook: str, ev) -> None:
        for li in self._listeners:
            try:
                getattr(li, hook)(ev)
            except Exception:   # listener failures never kill queries —
                # but a silently broken listener is undiagnosable, so log
                # the first failure of each (listener, hook) pair
                key = (id(li), hook)
                if key not in self._logged:
                    self._logged.add(key)
                    log.exception(
                        "event listener %s failed in %s "
                        "(further failures suppressed)",
                        type(li).__name__, hook)

    def query_created(self, tq) -> None:
        ev = QueryCreatedEvent(tq.query_id, tq.session_user, tq.sql,
                               time.time(),
                               tenant=getattr(tq, "tenant", "default"))
        self._dispatch("query_created", ev)

    def query_completed(self, tq) -> None:
        st = getattr(tq, "stage_stats", None) or {}
        ev = QueryCompletedEvent(
            tq.query_id, tq.session_user, tq.sql, tq.state,
            tq.state_machine.error, tq.elapsed_s, tq.rows_returned,
            tq.retries, time.time(),
            stages=int(st.get("stages", 0)),
            tasks=len(st.get("tasks", ())),
            bytes_shuffled=int(st.get("bytes_shuffled", 0)),
            faults_survived=int(st.get("faults_survived", 0)),
            hedges_fired=int(st.get("hedged_tasks", 0)),
            spills=int(getattr(tq, "spills", 0)),
            tenant=getattr(tq, "tenant", "default"),
            written_rows=int((st.get("write") or {}).get("rows", 0)),
            written_bytes=int((st.get("write") or {}).get("bytes", 0)),
            commit_phase=(st.get("write") or {}).get("phase", ""),
            dominant_phase=(getattr(tq, "timeline", None) or
                            {}).get("dominant", ""),
            progress_ratio=(1.0 if tq.state == "FINISHED" else
                            float(getattr(tq, "progress_ratio", 0.0))),
            dominant_stage=getattr(tq, "dominant_stage", ""))
        self._dispatch("query_completed", ev)
