"""Port copy of ``trino_tpu/utils/tracing.py`` (no edits beyond import targets
noted inline).

Distributed span tracing with W3C trace-context propagation.

Reference: Trino wires OpenTelemetry spans through the whole query path —
TracingModule at bootstrap (server/Server.java:106), spans around planning
(SqlQueryExecution.java:473,501), split scheduling
(split/SplitManager.java:85), decorators like tracing/TracingMetadata.java,
semantic attributes in tracing/TrinoAttributes.java — and propagates the
context over every internal HTTP hop so one query yields one trace.

Here: a dependency-free tracer with the same shape — named spans with
attributes and random 64-bit span ids, parent/child nesting via a
thread-local context stack, a W3C `traceparent` header
(`00-<trace_id>-<span_id>-01`) carried on every internal hop (statement
POST, task create, exchange pulls, spooled-segment gets), and remote spans
adopted back into the originating tracer so the coordinator can serve the
stitched query trace as OTLP-like JSON. Disabled tracers are zero-overhead
no-ops.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_ROOT_SPAN_ID = "0" * 16


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """-> (trace_id, parent_span_id) or None on anything malformed."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    try:
        int(parts[1], 16), int(parts[2], 16)
    except ValueError:
        return None
    return parts[1], parts[2]


@dataclass
class Span:
    name: str
    start: float                       # time.monotonic()
    end: Optional[float] = None
    attributes: Dict[str, object] = field(default_factory=dict)
    trace_id: str = ""
    span_id: str = ""
    # parent SPAN ID (not name: one query spawns many same-named task
    # spans, so a name link is ambiguous); None = trace root
    parent_id: Optional[str] = None
    service: str = "trino-tpu"
    start_unix: float = 0.0            # time.time() at start

    @property
    def duration_ms(self) -> float:
        return ((self.end or time.monotonic()) - self.start) * 1000

    def to_dict(self) -> dict:
        return {"name": self.name,
                "traceId": self.trace_id,
                "spanId": self.span_id,
                "parentSpanId": self.parent_id,
                "service": self.service,
                "startTimeUnixNano": int(self.start_unix * 1e9),
                "durationMs": round(self.duration_ms, 3),
                "attributes": self.attributes}


class Tracer:
    """Collects spans per thread; `span()` nests via a context stack.

    A tracer created via `from_traceparent` roots its first spans under
    the remote parent, so worker-side spans stitch under the coordinator
    span that dispatched the task. `adopt()` merges spans shipped back
    from remote processes (already-exported dicts) into this tracer's
    trace.
    """

    def __init__(self, enabled: bool = True,
                 trace_id: Optional[str] = None,
                 parent_span_id: Optional[str] = None,
                 service: str = "trino-tpu"):
        self.enabled = enabled
        self.trace_id = trace_id or new_trace_id()
        self.remote_parent = parent_span_id
        self.service = service
        self.spans: List[Span] = []
        self._foreign: List[dict] = []
        self._local = threading.local()
        self._lock = threading.Lock()

    @classmethod
    def from_traceparent(cls, header: Optional[str],
                         enabled: bool = True,
                         service: str = "trino-tpu") -> "Tracer":
        ctx = parse_traceparent(header)
        if ctx is None:
            return cls(enabled=enabled, service=service)
        return cls(enabled=enabled, trace_id=ctx[0],
                   parent_span_id=ctx[1], service=service)

    def _stack(self) -> list:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def traceparent(self) -> Optional[str]:
        """Header value for the CURRENT context (innermost open span on
        this thread, else the adopted remote parent). None when tracing
        is off, so callers can skip the header entirely."""
        if not self.enabled:
            return None
        stack = self._stack()
        sid = stack[-1].span_id if stack else \
            (self.remote_parent or _ROOT_SPAN_ID)
        return format_traceparent(self.trace_id, sid)

    @contextmanager
    def span(self, name: str, **attributes):
        if not self.enabled:
            yield None
            return
        stack = self._stack()
        parent = stack[-1].span_id if stack else self.remote_parent
        s = Span(name, time.monotonic(), attributes=dict(attributes),
                 trace_id=self.trace_id, span_id=new_span_id(),
                 parent_id=parent, service=self.service,
                 start_unix=time.time())
        stack.append(s)
        try:
            yield s
        finally:
            s.end = time.monotonic()
            stack.pop()
            with self._lock:
                self.spans.append(s)

    def adopt(self, span_dicts, offset_s: float = 0.0) -> None:
        """Merge remote spans (exported dicts shipped back in task
        results) into this trace. Spans from another trace id are kept
        too — a mis-stitched span is more diagnosable than a dropped
        one.

        `offset_s` is the remote node's estimated clock offset (remote
        clock minus local clock, measured at announce time): remote
        `startTimeUnixNano` stamps are rebased onto the local clock so
        cross-node timeline intervals cannot go negative when a worker's
        wall clock is skewed. Spans are copied, not mutated in place."""
        if not self.enabled or not span_dicts:
            return
        adopted = []
        for d in span_dicts:
            if not isinstance(d, dict):
                continue
            if offset_s and "startTimeUnixNano" in d:
                d = dict(d)
                d["startTimeUnixNano"] = int(
                    d["startTimeUnixNano"] - offset_s * 1e9)
            adopted.append(d)
        with self._lock:
            self._foreign.extend(adopted)

    def export(self) -> List[dict]:
        with self._lock:
            return [s.to_dict() for s in self.spans] + list(self._foreign)

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()
            self._foreign.clear()


NOOP = Tracer(enabled=False)
