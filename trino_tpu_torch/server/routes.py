"""Port copy of ``trino_tpu/server/routes.py`` (no edits).

Declarative HTTP route tables for the coordinator and worker servers.

Reference: the reference engine binds REST resources declaratively (JAX-RS
annotations on QueuedStatementResource / TaskResource / QueryResource), so
its route inventory is introspectable. The round-7 handlers here had grown
if/elif chains instead — invisible to metrics and impossible to lint. Every
`/v1/...` route now lives in a module-level ROUTES table:

    (METHOD, pattern, handler_method_name, needs_auth)

where `pattern` is a tuple of path segments and STAR matches any single
segment. `needs_auth` is False (open), True (end-user authentication via
the server's authenticator), or "internal" (cluster-membership routes:
the shared-secret header TRINO_TPU_INTERNAL_SECRET configures — worker
task/exchange routes and the coordinator announce route reject callers
without it with 401). `dispatch()` is the entire body of each
do_GET/do_POST/...: match, count the request in
trino_tpu_http_requests_total{server,route}, enforce auth, call the
handler. Adding a route therefore *cannot* skip the metrics surface, and
tier-1 lints exactly that (tests/test_metrics_lint.py: handlers may not
contain inline path literals; every table entry must have a
pre-initialized counter sample).
"""

from __future__ import annotations

from typing import Tuple

STAR = "*"


def route_label(method: str, pattern: Tuple[str, ...]) -> str:
    """Stable metrics label, e.g. 'GET /v1/task/*/results/*'."""
    return method + " /" + "/".join(pattern)


def match(pattern: Tuple[str, ...], parts: Tuple[str, ...]) -> bool:
    return len(pattern) == len(parts) and all(
        p == STAR or p == s for p, s in zip(pattern, parts))


def register_routes(server_name: str, routes) -> None:
    """Pre-initialize every route's request counter so a cold server's
    /v1/metrics already lists its full route inventory at 0."""
    from ..metrics import HTTP_REQUESTS
    for method, pattern, *_ in routes:
        HTTP_REQUESTS.init_labels(server=server_name,
                                  route=route_label(method, pattern))


def dispatch(handler, method: str, routes, server_name: str) -> None:
    """Generic request dispatcher (the whole body of a do_* method)."""
    from urllib.parse import urlparse

    from ..metrics import HTTP_REQUESTS
    path = urlparse(handler.path).path
    parts = tuple(p for p in path.split("/") if p)
    for m, pattern, fn_name, needs_auth in routes:
        if m != method or not match(pattern, parts):
            continue
        HTTP_REQUESTS.inc(server=server_name,
                          route=route_label(m, pattern))
        user = None
        if needs_auth == "internal":
            from .security import check_internal_request
            if not check_internal_request(handler.headers):
                handler._send(401, {"error": {
                    "message": "cluster-internal route: missing or "
                               "invalid internal secret",
                    "errorName": "AUTHENTICATION_FAILED"}})
                return
            user = "internal"
        elif needs_auth:
            user = handler._authenticate()
            if user is None:
                return           # 401 already sent
        getattr(handler, fn_name)(parts, user)
        return
    HTTP_REQUESTS.inc(server=server_name, route=f"{method} unmatched")
    handler._not_found(path)
