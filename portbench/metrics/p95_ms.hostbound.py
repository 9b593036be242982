"""p95_ms.hostbound: the 95th percentile of the client's wall of every
query of the window, POST to last page, a failed query counting as
missing every limit. A per-layer metric in cells whose card idles more
than half the window, where the host paces the tail."""

from portbench.run import percentile


def read(r):
    if not r.queries:
        return None
    return percentile([q.wall_s * 1e3 if q.ok else float("inf")
                       for q in r.queries], 95)
