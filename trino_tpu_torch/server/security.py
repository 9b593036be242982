"""Port copy of ``trino_tpu/server/security.py`` (no edits).

Authentication + access control (minimal production shape).

Reference: the layered security stack — password authenticators
(plugin/trino-password-authenticators), AccessControlManager dispatching
to system access controls (security/AccessControlManager.java), and the
file-based rules plugin (FileBasedSystemAccessControl). Here: a static
password/token authenticator on the coordinator's HTTP intake, and a
rule-list access control consulted at dispatch with the statement's
RESOLVED table references (post-planning, so views/CTEs can't smuggle
reads past the checker).
"""

from __future__ import annotations

import fnmatch
from dataclasses import dataclass
from typing import List, Optional, Tuple


class AccessDeniedError(RuntimeError):
    """Authorization failure — never retried, surfaced to the client
    (spi/security/AccessDeniedException.java)."""


class AuthenticationError(RuntimeError):
    """Credential failure — HTTP 401 at the protocol layer."""


# --------------------------------------------------------------------------
# cluster-internal shared secret (the reference's internal-communication
# shared secret, security/internal-communication.md): when
# TRINO_TPU_INTERNAL_SECRET is set, every data-plane/control-plane route
# that only cluster members may call (worker task/exchange routes, the
# coordinator announce route) requires the header; unset = open cluster
# (dev/test compatibility).
# --------------------------------------------------------------------------

INTERNAL_HEADER = "X-Trino-Internal-Bearer"


def internal_secret() -> Optional[str]:
    import os
    return os.environ.get("TRINO_TPU_INTERNAL_SECRET") or None


def internal_headers() -> dict:
    """Headers a cluster member attaches to internal HTTP calls
    (announce, task create/status, exchange page pulls)."""
    secret = internal_secret()
    return {INTERNAL_HEADER: secret} if secret else {}


def check_internal_request(headers) -> bool:
    """True when the request may use an internal route: either the
    cluster is open (no secret configured) or the caller presented the
    matching secret (constant-time compare)."""
    import hmac
    secret = internal_secret()
    if secret is None:
        return True
    presented = headers.get(INTERNAL_HEADER, "")
    return hmac.compare_digest(str(presented), secret)


class PasswordAuthenticator:
    """Static user -> secret map (the PasswordAuthenticator SPI shape;
    file/LDAP backends would subclass). Secrets compare in constant
    time."""

    def __init__(self, credentials: dict):
        self._creds = dict(credentials)

    def authenticate(self, user: str, secret: Optional[str]) -> str:
        import hmac
        want = self._creds.get(user)
        if want is None or secret is None or \
                not hmac.compare_digest(str(want), str(secret)):
            raise AuthenticationError(f"invalid credentials for {user!r}")
        return user


@dataclass(frozen=True)
class AccessRule:
    """One allow/deny rule; glob patterns per part
    (FileBasedSystemAccessControl's catalog/schema/table rules)."""
    user: str = "*"
    catalog: str = "*"
    schema: str = "*"
    table: str = "*"
    privileges: Tuple[str, ...] = ("select", "write")
    allow: bool = True

    def matches(self, user, catalog, schema, table, privilege) -> bool:
        return (fnmatch.fnmatchcase(user, self.user) and
                fnmatch.fnmatchcase(catalog, self.catalog) and
                fnmatch.fnmatchcase(schema, self.schema) and
                fnmatch.fnmatchcase(table, self.table) and
                privilege in self.privileges)


class AllowAllAccessControl:
    """Default: open cluster (AllowAllSystemAccessControl)."""

    def check(self, user, catalog, schema, table, privilege) -> None:
        pass


class RuleAccessControl:
    """First-match-wins rule list; NO match denies (the reference's
    file-based control denies whatever the rules don't grant)."""

    def __init__(self, rules: List[AccessRule]):
        self.rules = list(rules)

    def check(self, user, catalog, schema, table, privilege) -> None:
        for r in self.rules:
            if r.matches(user, catalog, schema, table, privilege):
                if r.allow:
                    return
                break
        raise AccessDeniedError(
            f"Access Denied: user {user!r} cannot {privilege} "
            f"{catalog}.{schema}.{table}")


def _plan_scan_nodes(root):
    """Every ScanNode reachable from a plan, INCLUDING subplans embedded
    in expressions (scalar / IN subqueries carry their planned subtree
    inside ScalarSubqueryRef / InSubqueryRef) — a denied table must not
    slip past the checker inside a select-item or SET subquery."""
    from .. import ir
    from ..planner import logical as L
    from ..planner.fragmenter import _subtree_nodes

    def node_exprs(n):
        if isinstance(n, L.FilterNode):
            return (n.predicate,)
        if isinstance(n, L.ProjectNode):
            return n.exprs
        if isinstance(n, L.AggregateNode):
            return tuple(a.arg for a in n.aggs if a.arg is not None)
        return ()

    todo = [root]
    while todo:
        node = todo.pop()
        for n in _subtree_nodes(node):
            if isinstance(n, L.ScanNode):
                yield n
            for e in node_exprs(n):
                for sub in ir.walk(e):
                    plan = getattr(sub, "plan", None)
                    if isinstance(plan, L.PlanNode):
                        todo.append(plan)


def statement_table_refs(session, sql: str):
    """(privilege, catalog, schema, table) references of a statement,
    resolved through the planner (scans of the final plan, not raw AST
    names — CTEs/derived tables resolve first). DML adds a write ref on
    its target."""
    from ..planner import logical as L
    from ..sql import ast_nodes as A
    from ..sql.parser import parse
    stmt = parse(sql)
    refs = []

    def scan_refs(node):
        for n in _plan_scan_nodes(node):
            refs.append(("select", n.catalog, n.schema_name, n.table))

    def qualify(name_parts):
        parts = list(name_parts)
        if len(parts) == 3:
            return parts
        if len(parts) == 2:
            return [session.default_cat] + parts
        return [session.default_cat, session.default_schema] + parts

    if isinstance(stmt, (A.Query, A.SetOp, A.Values)):
        rel = session.planner().plan_query(stmt)
        scan_refs(rel.node)
    elif isinstance(stmt, (A.InsertInto, A.Update, A.Delete,
                           A.MergeInto, A.CreateTable, A.DropTable)):
        target = getattr(stmt, "table", None) or \
            getattr(stmt, "target", None)
        if target is not None:
            parts = qualify(target if isinstance(target, (list, tuple))
                            else str(target).split("."))
            refs.append(("write", *parts))
        inner = getattr(stmt, "query", None)
        if isinstance(inner, (A.Query, A.SetOp, A.Values)):
            rel = session.planner().plan_query(inner)
            scan_refs(rel.node)
        # UPDATE/DELETE read through their WHERE clause and SET
        # expressions (subqueries included): plan the statement's shadow
        # query over the target — the same query execute_dml runs — and
        # collect its ScanNodes as READ refs, exactly like the MERGE
        # USING fix. Without this, any write grant could exfiltrate a
        # denied table via `WHERE x IN (SELECT ... FROM denied)`.
        if isinstance(stmt, (A.Update, A.Delete)) and target is not None:
            tparts = [p.lower() for p in qualify(
                target if isinstance(target, (list, tuple))
                else str(target).split("."))]
            items = [A.SelectItem(A.NumberLit("1"), "$x")]
            if isinstance(stmt, A.Update):
                for j, (_col, expr) in enumerate(stmt.assignments):
                    items.append(A.SelectItem(expr, f"$v{j}"))
            shadow = A.Query(select=tuple(items), distinct=False,
                             relation=A.TableRef(tuple(tparts),
                                                 alias=tparts[-1]),
                             where=stmt.where, group_by=(), having=None,
                             order_by=(), limit=None)
            rel = session.planner().plan_query(shadow)
            for n in _plan_scan_nodes(rel.node):
                if (n.catalog, n.schema_name, n.table) != tuple(tparts):
                    # the target's own scan is implied by the write
                    # grant; every OTHER table the statement touches
                    # needs an explicit SELECT grant
                    refs.append(("select", n.catalog, n.schema_name,
                                 n.table))
        # MERGE's USING relation (and any relation AST) is READ: wrap it
        # in a trivial query so the planner resolves its table refs —
        # a denied table must not leak through the source side
        src = getattr(stmt, "source", None)
        if isinstance(src, A.Node) and not isinstance(src, (A.Query,)):
            if isinstance(src, A.TableRef):
                refs.append(("select", *qualify(src.name)))
            else:
                for n in _ast_subtree(src):
                    if isinstance(n, A.TableRef):
                        refs.append(("select", *qualify(n.name)))
        elif isinstance(src, A.Query):
            rel = session.planner().plan_query(src)
            scan_refs(rel.node)
    # SET SESSION / SHOW / EXPLAIN etc: no table privileges involved
    return refs


def _ast_subtree(node):
    import dataclasses
    yield node
    if dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            items = v if isinstance(v, tuple) else (v,)
            for it in items:
                if dataclasses.is_dataclass(it):
                    yield from _ast_subtree(it)


def check_statement_access(access_control, session, sql: str,
                           user: str) -> None:
    """Dispatch-time authorization (DispatchManager.createQueryInternal's
    access-check step). Raises AccessDeniedError."""
    if isinstance(access_control, AllowAllAccessControl):
        return
    for privilege, cat, sch, tbl in statement_table_refs(session, sql):
        access_control.check(user, cat, sch, tbl, privilege)
