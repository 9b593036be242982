"""Port copy of ``trino_tpu/utils/log.py`` (unchanged).

Structured log correlation: one consistent query/trace prefix.

Reference: Trino stamps query ids into its log lines so `grep <queryId>`
reconstructs a query's server-side story. The ad-hoc log lines here
(serving replans, memory-manager kills, prewarm, the write protocol,
slow-query warnings) grew without a shared convention, so a timeline
entry could not be grepped to its logs. No new framework — just a helper
producing the canonical `query=<id> trace=<id>` prefix every correlated
line starts with.
"""

from __future__ import annotations

from typing import Optional


def query_context(query_id: Optional[str] = None,
                  trace_id: Optional[str] = None) -> str:
    """`query=<id> trace=<id> ` prefix (trailing space included); empty
    string when neither id is known, so callers can prepend it
    unconditionally."""
    parts = []
    if query_id:
        parts.append(f"query={query_id}")
    if trace_id:
        parts.append(f"trace={trace_id}")
    return (" ".join(parts) + " ") if parts else ""


def tq_context(tq) -> str:
    """Prefix for a TrackedQuery: query id plus its tracer's trace id
    when tracing is on."""
    tracer = getattr(tq, "tracer", None)
    trace_id = getattr(tracer, "trace_id", None) if tracer is not None \
        and getattr(tracer, "enabled", False) else None
    return query_context(getattr(tq, "query_id", None), trace_id)
