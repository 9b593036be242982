"""Port copy of ``trino_tpu/client/client.py`` (no edits).

Python client for the statement protocol.

Reference: client/trino-client's StatementClientV1
(StatementClientV1.java:76) — POST /v1/statement, then follow `nextUri`
(advance:391) accumulating data pages until no nextUri remains; DELETE the
current uri to cancel.
"""

from __future__ import annotations

import http.client
import json
import time
from dataclasses import dataclass, field
from typing import List, Optional
from urllib.error import HTTPError
from urllib.request import Request, urlopen


class QueryError(Exception):
    def __init__(self, message: str, error_name: str = ""):
        super().__init__(message)
        self.error_name = error_name


@dataclass
class ClientResult:
    query_id: str
    columns: List[str]
    rows: List[list]
    state: str
    elapsed_ms: int = 0
    # how many times this query's polling crossed to a different
    # coordinator address (0 on the happy path; >=1 when a failover
    # happened under the query without surfacing an error)
    failovers: int = 0


class Client:
    def __init__(self, uri, user: str = "anonymous",
                 poll_interval_s: float = 0.05, timeout_s: float = 300.0,
                 spooled: bool = False, password: Optional[str] = None,
                 traceparent: Optional[str] = None,
                 on_progress=None):
        # `uri` accepts a single address, a comma-separated list, or a
        # list/tuple — the failover address list. The first entry is
        # the preferred coordinator; nextUri polling rewrites hosts
        # across the list when one stops answering (the HA client's
        # multi-host JDBC-URL pattern).
        if isinstance(uri, str):
            uris = [u for u in (p.strip() for p in uri.split(",")) if u]
        else:
            uris = [str(u) for u in uri]
        self.uris = [u.rstrip("/") for u in uris]
        self.uri = self.uris[0]
        self.user = user
        self.password = password   # X-Trino-Password credential
        self.poll_interval_s = poll_interval_s
        self.timeout_s = timeout_s
        self.spooled = spooled     # opt into the spooled result protocol
        # W3C trace context: carried on every request (statement POST,
        # nextUri polls, spooled segment get/ack) so an enable_tracing
        # query's trace continues the CALLER's trace instead of rooting
        # a fresh one (utils/tracing.py parses it coordinator-side)
        self.traceparent = traceparent
        # live-progress hook: called with each polled page's `stats`
        # dict (state, progressRatio, stage, elapsedTimeMillis) — the
        # CLI's --progress line renders from this; None costs nothing
        self.on_progress = on_progress
        # cumulative coordinator-address switches (per-query delta is
        # reported on ClientResult.failovers)
        self.failovers = 0
        # the most recent nextUri — the Ctrl-C cancel target
        self._last_next_uri: Optional[str] = None
        from ..server.retrypolicy import RetryPolicy
        # the retry window must outlast a standby promotion (detector
        # misses + ledger replay + worker re-announce), not just a
        # connection blip — hence the deep attempt budget
        self.retry_policy = RetryPolicy(base_delay_s=0.05,
                                        max_delay_s=1.0, max_attempts=12,
                                        name="client-failover")

    def _request(self, method: str, url: str,
                 body: Optional[bytes] = None) -> dict:
        headers = {"X-Trino-User": self.user,
                   "Content-Type": "text/plain"}
        if self.password is not None:
            headers["X-Trino-Password"] = self.password
        if self.spooled:
            headers["X-Trino-Spooled"] = "true"
        if self.traceparent is not None:
            headers["traceparent"] = self.traceparent
        req = Request(url, data=body, method=method, headers=headers)
        with urlopen(req, timeout=30) as resp:
            payload = resp.read()
        return json.loads(payload) if payload else {}

    # -- coordinator failover ----------------------------------------------

    @staticmethod
    def _rewrite(url: str, base: str) -> str:
        """Re-home a server-issued URI (nextUri, spooled segment) onto
        `base` — the statement routes are identical on every coordinator
        in the list, and a promoted standby resumes the query under the
        same id/token path the dead primary issued."""
        from urllib.parse import urlsplit, urlunsplit
        b = urlsplit(base)
        u = urlsplit(url)
        return urlunsplit((b.scheme, b.netloc, u.path, u.query,
                           u.fragment))

    def _next_coordinator(self, failed: str) -> None:
        """Rotate the polling target past `failed`; counts a failover
        only when the address actually changes."""
        if len(self.uris) < 2:
            return
        try:
            i = self.uris.index(failed)
        except ValueError:
            i = -1
        nxt = self.uris[(i + 1) % len(self.uris)]
        if nxt != failed:
            self.uri = nxt
            self.failovers += 1

    @staticmethod
    def _retryable_http(e: HTTPError) -> bool:
        """A coordinator that answers but cannot serve (a not-yet-
        promoted standby's 503 COORDINATOR_UNAVAILABLE, a proxy's 502)
        is a failover signal, not a query error."""
        return e.code in (502, 503)

    def _submit(self, sql: str) -> dict:
        """POST the statement, failing over across the address list
        ONLY on errors that guarantee nothing was admitted — a refused/
        unreachable connection, or an explicit COORDINATOR_UNAVAILABLE
        rejection. Once any coordinator has accepted the statement,
        recovery happens on the idempotent nextUri GETs instead (a
        re-POST would run the query twice)."""
        delays = self.retry_policy.delays()
        last: Optional[Exception] = None
        for _ in range(self.retry_policy.max_attempts):
            base = self.uri
            try:
                return self._request("POST", f"{base}/v1/statement",
                                     sql.encode())
            except HTTPError as e:
                if not self._retryable_http(e):
                    raise
                last = e
            except (OSError, http.client.HTTPException) as e:
                last = e
            self._next_coordinator(base)
            d = next(delays, None)
            if d is None:
                break
            time.sleep(d)
        raise QueryError(f"no coordinator accepted the statement: {last}",
                         "COORDINATOR_UNAVAILABLE")

    def execute(self, sql: str) -> ClientResult:
        """Submit and drain the nextUri chain to completion."""
        failovers_at_start = self.failovers
        doc = self._submit(sql)
        columns: List[str] = []
        rows: List[list] = []
        deadline = time.time() + self.timeout_s
        self._last_next_uri = None
        try:
            return self._drain(doc, columns, rows, deadline,
                               failovers_at_start)
        except KeyboardInterrupt:
            # Ctrl-C cancels the SERVER-side query before the client
            # exits — otherwise the interrupted query keeps burning
            # cluster slots until its own deadline fires
            nu = self._last_next_uri
            if nu:
                try:
                    self._request("DELETE", self._rewrite(nu, self.uri))
                except Exception:  # noqa: BLE001 — best-effort cancel
                    pass
            raise

    def _drain(self, doc: dict, columns: List[str], rows: List[list],
               deadline: float, failovers_at_start: int) -> ClientResult:
        while True:
            if "error" in doc:
                err = doc["error"]
                name = err.get("errorName", "")
                msg = err.get("message", "query failed")
                if name == "QUERY_EXCEEDED_RUN_TIME":
                    msg += (" — the query hit its query_max_run_time_s "
                            "budget: raise it (SET SESSION "
                            "query_max_run_time_s = N, or the CLI's "
                            "--timeout) or narrow the query")
                elif name in ("QUERY_QUEUE_FULL",
                              "QUERY_EXCEEDED_QUEUED_TIME"):
                    msg += (" — the cluster is overloaded and this "
                            "rejection is retryable: resubmit after a "
                            "backoff")
                raise QueryError(msg, name)
            if self.on_progress is not None:
                try:
                    self.on_progress(doc.get("stats") or {})
                except Exception:  # noqa: BLE001 — rendering never
                    pass           # fails the query
            if "columns" in doc and not columns:
                columns = [c["name"] for c in doc["columns"]]
            if "data" in doc:
                rows.extend(doc["data"])
            for seg in doc.get("segments", ()):
                # spooled protocol: fetch each segment, then acknowledge
                # (re-homed onto the current coordinator — spool storage
                # is shared, so a promoted standby serves the same keys)
                sdoc = self._request("GET",
                                     self._rewrite(seg["uri"], self.uri))
                rows.extend(sdoc["data"])
                self._request("DELETE",
                              self._rewrite(seg["uri"], self.uri))
            next_uri = doc.get("nextUri")
            self._last_next_uri = next_uri
            if next_uri is None:
                return ClientResult(
                    doc.get("id", ""), columns, rows,
                    doc.get("stats", {}).get("state", "FINISHED"),
                    doc.get("stats", {}).get("elapsedTimeMillis", 0),
                    failovers=self.failovers - failovers_at_start)
            if time.time() > deadline:
                # cancel the server-side query BEFORE raising — a bare
                # CLIENT_TIMEOUT used to leak the executing query (it
                # keeps burning cluster slots until ITS timeout); the
                # DELETE is best-effort so a dead coordinator can't mask
                # the timeout error itself
                try:
                    self._request("DELETE",
                                  self._rewrite(next_uri, self.uri))
                except Exception:     # noqa: BLE001 — best-effort cancel
                    pass
                raise QueryError("client timeout", "CLIENT_TIMEOUT")
            state = doc.get("stats", {}).get("state", "")
            if state in ("QUEUED", "PLANNING", "RUNNING", "STARTING"):
                time.sleep(self.poll_interval_s)
            doc = self._poll(next_uri, deadline)

    def _poll(self, next_uri: str, deadline: Optional[float] = None) -> dict:
        """One nextUri advance, retried with backoff through the
        coordinator address list: a reset/refused/dropped connection or
        an explicit COORDINATOR_UNAVAILABLE answer rotates the target
        and re-issues the SAME uri against the next address (nextUri
        GETs are idempotent — the token pins the page, and a promoted
        standby resumes the query under the original id). The query
        survives its coordinator dying mid-poll without surfacing an
        error; HTTP status errors other than 502/503 are real answers
        and propagate (StatementClientV1.advance retries the same
        way).

        Past the attempt budget, a poll whose coordinators answered with
        a retryable status (a standby still promoting) goes on at the
        policy's longest delay until the query's `deadline` (time.time()):
        how long a promotion takes (detector misses, the wait for workers,
        the ledger's replay) grows with the host's load, while the
        budget's jittered delays may sum to a few seconds."""
        delays = self.retry_policy.delays()
        last: Optional[Exception] = None
        answered = False
        while True:
            base = self.uri
            try:
                return self._request("GET",
                                     self._rewrite(next_uri, base))
            except HTTPError as e:
                if not self._retryable_http(e):
                    raise
                last = e
                answered = True
            except (OSError, http.client.HTTPException) as e:
                last = e
            self._next_coordinator(base)
            d = next(delays, None)
            if d is None:
                if not (answered and deadline is not None and
                        time.time() < deadline):
                    break
                d = self.retry_policy.max_delay_s
            time.sleep(max(d, self.poll_interval_s))
        raise last if isinstance(last, HTTPError) else \
            QueryError(f"lost every coordinator while polling: {last}",
                       "COORDINATOR_UNAVAILABLE")

    def query_info(self, query_id: str) -> dict:
        return self._request("GET", f"{self.uri}/v1/query/{query_id}")

    def list_queries(self) -> list:
        return self._request("GET", f"{self.uri}/v1/query")

    def nodes(self) -> list:
        return self._request("GET", f"{self.uri}/v1/node")

    def server_info(self) -> dict:
        return self._request("GET", f"{self.uri}/v1/info")
