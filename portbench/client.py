"""A minimal client of the statement protocol: urllib and json only.

``POST /v1/statement`` with the SQL text, then ``GET`` each ``nextUri``
until a page has none. Kept apart from the program's own client, so that
a change to that client cannot change what the benchmark measures.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Callable, List, Optional

USER = "portbench"


class QueryFailed(Exception):
    pass


@dataclass
class Answer:
    query_id: str
    columns: List[str]
    rows: List[list]
    elapsed_ms: int               # the coordinator's elapsedTimeMillis


def _call(req: urllib.request.Request, timeout: float) -> dict:
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        raise QueryFailed(f"HTTP {e.code}: {e.read()[:500]!r}") from e


def run(base: str, sql: str, timeout: float = 600.0,
        span: Optional[Callable] = None) -> Answer:
    """Send `sql` to the coordinator at `base` and follow it to its last
    page. Raises QueryFailed when the query fails. `span(name)` is a
    context manager factory put around each request (the traced run's
    host spans); None for none."""
    def request(method, url, body=None):
        req = urllib.request.Request(
            url, data=body, method=method,
            headers={"X-Trino-User": USER,
                     "Content-Type": "text/plain"})
        if span is None:
            return _call(req, timeout)
        with span("pb:client." + ("submit" if method == "POST"
                                  else "poll")):
            return _call(req, timeout)

    page = request("POST", f"{base}/v1/statement", sql.encode())
    qid = page.get("id", "")
    columns: List[str] = []
    rows: List[list] = []
    while True:
        if "error" in page:
            err = page["error"]
            raise QueryFailed(f"{qid}: {err.get('errorName')}: "
                              f"{err.get('message')}")
        if page.get("columns") and not columns:
            columns = [c["name"] for c in page["columns"]]
        rows.extend(page.get("data") or ())
        nxt = page.get("nextUri")
        if not nxt:
            break
        page = request("GET", nxt)
    state = page.get("stats", {}).get("state")
    if state != "FINISHED":
        raise QueryFailed(f"{qid}: ended in state {state}")
    return Answer(qid, columns, rows,
                  int(page.get("stats", {}).get("elapsedTimeMillis", 0)))
