"""Port copy of ``trino_tpu/server/writeprotocol.py``, with a fence, a
table lock and a coordinator's write scope that the reference lacks
(ROADMAP, "Where the port departs from the reference on purpose").

Exactly-once staged-write commit protocol for directory connectors.

The fault-tolerant-execution write path (the role of Trino's
TableWriterOperator + TableFinishOperator under task-level retries):
worker write tasks stage output to uniquely-named attempt files under
`<table>/.staging/` and only *report* a manifest — publication is the
coordinator's job. The coordinator dedups manifests by (stage, partition)
with first-success-wins, records a CRC-framed, fsync'd commit journal in
the table directory, publishes each staged file by atomic rename, then
removes the journal. Replaying any prefix of that sequence is idempotent:

  crash before the INTENT record is durable  -> roll back (sweep staging)
  crash after INTENT, before all renames     -> roll forward (finish renames)
  crash after COMMIT record                  -> cleanup only

Published part files carry the committing query's token and row count in
their names (`part-00000-<qtok>-r123.orc`), so a whole-query retry that
finds its own parts already published returns success without re-staging —
the commit point is the INTENT record, exactly once per query id.

Single-writer-per-table is assumed (the coordinator serializes DDL/DML on
one exec lock; the session-local path is in-process); recovery additionally
runs on connector startup so an unclean shutdown can never leak staging
files, journals, or torn tables.

Across a coordinator failover two coordinators can hold one query id: the
old primary's dispatch thread runs on after its ledger is sealed (or a
newer primary claimed the ledger epoch) while the promoted standby
resumes the query. Every call that changes a table directory (`commit`,
`abort`, `recover_table_dir`) therefore takes an exclusive lock on the
directory (`table_lock`) and, under it, checks the caller's fence: the
coordinator's query ledger, or None without one. A sealed or deposed
ledger makes the call raise `WriteFencedError` with the directory as it
was. A stale committer thus either committed before the standby's claim
(and the standby's commit dedups) or is refused.

A coordinator's local run of a tracked query (`coordinator_write`) gives
the connector's staged write that query's id and fence, so a resumed
query finds its own commit (`published_rows_for`) whichever path made it.
"""

import contextlib
import contextvars
import fcntl
import json
import logging
import os
import re
import struct

from ..metrics import WRITE_COMMITS, WRITE_ORPHANS_SWEPT, WRITE_TASKS
from ..utils.atomicio import fsync_dir
from ..utils.log import query_context
from .failureinjector import WRITE_COMMIT, WRITE_PUBLISH, WRITE_STAGE
from .pageserde import _crc32c

log = logging.getLogger("trino_tpu_torch.write")

STAGING_DIR = ".staging"
LOCK_NAME = ".write.lock"
JOURNAL_MAGIC = b"TWJ1"
_PART_RE = re.compile(r"^part-(\d+)-([0-9a-f]+)-r(\d+)\.(orc|parquet)$")


def qtoken(query_id: str) -> str:
    """Filesystem-safe token for a query id (stable across retries of
    the same query — that stability is what makes commit exactly-once)."""
    return format(_crc32c(query_id.encode()) & 0xFFFFFFFF, "08x")


def staging_dir(table_dir: str) -> str:
    return os.path.join(table_dir, STAGING_DIR)


def journal_path(table_dir: str, query_id: str) -> str:
    return os.path.join(table_dir, f".commit_{qtoken(query_id)}.journal")


def attempt_filename(query_id: str, stage: int, partition: int,
                     attempt: str, ext: str) -> str:
    return f"{qtoken(query_id)}_{stage}_{partition}_{attempt}.{ext}"


def part_filename(seq: int, qtok: str, rows: int, ext: str) -> str:
    return f"part-{seq:05d}-{qtok}-r{rows}.{ext}"


def list_parts(table_dir: str):
    """Published part files, in deterministic (sequence) order."""
    if not os.path.isdir(table_dir):
        return []
    out = []
    for f in os.listdir(table_dir):
        m = _PART_RE.match(f)
        if m:
            out.append((int(m.group(1)), f))
    return [f for _, f in sorted(out)]


def published_rows_for(table_dir: str, query_id: str):
    """If parts published by `query_id` exist, their total row count —
    the signal that a prior attempt already committed. None otherwise."""
    tok = qtoken(query_id)
    rows, seen = 0, False
    for f in list_parts(table_dir):
        m = _PART_RE.match(f)
        if m and m.group(2) == tok:
            seen = True
            rows += int(m.group(3))
    return rows if seen else None


# --------------------------------------------------------------------------
# fence, table lock and a coordinator's write scope
# --------------------------------------------------------------------------

class FencedError(RuntimeError):
    """This coordinator's ledger is sealed (its process is dead), or
    another node claimed the ledger epoch: it may change no shared state,
    no table directory and no task on a worker. Not retried: the query's
    client has moved to the coordinator that holds the epoch."""


class WriteFencedError(FencedError):
    """A fenced coordinator asked to change a table directory: refused,
    and the directory left as it was."""


def fenced(fence):
    """Why `fence` (a coordinator's QueryLedger, or None for a
    coordinator without one) forbids its holder to change shared state:
    "sealed", "deposed", or None when it does not. The epoch is read from
    disk, not from the ledger's cache."""
    if fence is None:
        return None
    if fence.sealed:
        return "sealed"
    return None if fence.owns_epoch(force=True) else "deposed"


def refuse(fence, why: str, op: str, what: str, query_id: str,
           error=FencedError):
    """Record a refusal in `fence.fence_refusals` and raise `error`."""
    fence.fence_refusals.append({"op": op, "query": query_id,
                                 "target": what, "why": why})
    log.warning("%sfenced: %s (%s ledger) may not %s %s",
                query_context(query_id), fence.node_id, why, op, what)
    raise error(f"fenced: coordinator {fence.node_id} ({why} ledger) may "
                f"not {op} {what} (query {query_id})")


def check_fence(fence, op: str, table_dir: str, query_id: str) -> None:
    """Raise WriteFencedError if `fence` forbids the `op` of `query_id`
    on `table_dir`."""
    why = fenced(fence)
    if why is not None:
        refuse(fence, why, op, f"in {table_dir}", query_id,
               WriteFencedError)


@contextlib.contextmanager
def table_lock(table_dir: str):
    """Hold the table directory's write lock: `flock` on `LOCK_NAME`
    inside it, which excludes other processes and other threads alike
    (each open is its own lock). The file is removed on release; a
    waiter that wakes on a removed file opens the new one."""
    path = os.path.join(table_dir, LOCK_NAME)
    while True:
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            held = os.fstat(fd)
            try:
                cur = os.stat(path)
            except FileNotFoundError:
                cur = None
        except BaseException:
            os.close(fd)
            raise
        if cur is not None and (cur.st_ino, cur.st_dev) == \
                (held.st_ino, held.st_dev):
            break
        os.close(fd)
    try:
        yield
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass
        os.close(fd)


class _WriteScope:
    __slots__ = ("query_id", "fence", "writes")

    def __init__(self, query_id: str, fence):
        self.query_id, self.fence, self.writes = query_id, fence, 0


_SCOPE: contextvars.ContextVar = contextvars.ContextVar(
    "coordinator_write", default=None)


@contextlib.contextmanager
def coordinator_write(query_id: str, fence=None):
    """A coordinator's local run of the tracked query `query_id`: a
    staged write made inside commits under `query_id` and checks
    `fence`. Outside one, a connector write mints `local_<uuid>`."""
    token = _SCOPE.set(_WriteScope(query_id, fence))
    try:
        yield
    finally:
        _SCOPE.reset(token)


def current_write():
    """(query_id, fence) of the enclosing coordinator_write, or (None,
    None) outside one."""
    scope = _SCOPE.get()
    return (None, None) if scope is None else (scope.query_id, scope.fence)


def claim_scoped_write():
    """(query_id, fence) for a staged write inside a coordinator_write,
    (None, None) outside one. A query id commits one staged write
    (`commit` is idempotent per id), so a second one in the same run
    raises instead of being deduplicated away."""
    scope = _SCOPE.get()
    if scope is None:
        return None, None
    if scope.writes:
        raise RuntimeError(f"query {scope.query_id} already staged a "
                           f"write: a second staged write in one "
                           f"statement needs an id of its own")
    scope.writes += 1
    return scope.query_id, scope.fence


# --------------------------------------------------------------------------
# staging (worker side)
# --------------------------------------------------------------------------

def stage_table_data(table_dir: str, data, query_id: str, stage: int,
                     partition: int, attempt: str, fmt: str,
                     injector=None) -> dict:
    """Write one attempt file under `<table>/.staging/` and return its
    manifest (path, rows, CRC, bytes, per-column zone stats). Never
    publishes — the file is invisible to scans until the coordinator
    commits it."""
    if injector is not None:
        injector.maybe_fail(WRITE_STAGE,
                            f"{query_id}:{stage}:{partition}:{attempt}")
    sdir = staging_dir(table_dir)
    os.makedirs(sdir, exist_ok=True)
    ext = "orc" if fmt == "orc" else "parquet"
    path = os.path.join(sdir, attempt_filename(query_id, stage, partition,
                                               attempt, ext))
    if fmt == "orc":
        from ..connectors.orcdir import export_table
    else:
        from ..connectors.parquetdir import export_table
    export_table(data, path)
    with open(path, "rb") as f:
        body = f.read()
    WRITE_TASKS.inc()
    return {
        "path": path,
        "rows": int(data.num_rows),
        "bytes": len(body),
        "crc": _crc32c(body) & 0xFFFFFFFF,
        "stage": stage,
        "partition": partition,
        "attempt": attempt,
        "zones": _zone_stats(data),
    }


def _zone_stats(data) -> dict:
    """min/max per numeric column — the manifest's zone-map stats (the
    file's own stripe/chunk statistics back actual scan pruning; these
    feed observability and the commit journal)."""
    import numpy as np
    out = {}
    for i, f in enumerate(data.schema):
        col = np.asarray(data.columns[i])
        if col.size == 0 or not (np.issubdtype(col.dtype, np.integer)
                                 or np.issubdtype(col.dtype, np.floating)):
            continue
        valid = None if data.valids is None else data.valids[i]
        vals = col if valid is None else col[np.asarray(valid)]
        if vals.size:
            out[f.name] = [float(vals.min()), float(vals.max())]
    return out


# --------------------------------------------------------------------------
# journal (CRC-framed, fsync'd, torn-tail tolerant)
# --------------------------------------------------------------------------

def _frame(rec: dict) -> bytes:
    body = json.dumps(rec, sort_keys=True).encode()
    return (JOURNAL_MAGIC + struct.pack("<I", _crc32c(body) & 0xFFFFFFFF)
            + struct.pack("<I", len(body)) + body)


def append_journal(path: str, rec: dict, injector=None,
                   key: str = "") -> None:
    """Append one CRC-framed record and fsync file + directory. The
    CORRUPT fault at WRITE_COMMIT truncates the frame mid-write — the
    torn-journal case replay must tolerate."""
    frame = _frame(rec)
    torn = False
    if injector is not None:
        try:
            frame2 = injector.corrupt_page(WRITE_COMMIT, key, frame)
            if frame2 is not frame and frame2 != frame:
                # model a torn append: a prefix of the record hits disk
                frame, torn = frame[:max(4, len(frame) // 2)], True
        except AttributeError:
            pass
    with open(path, "ab") as f:
        f.write(frame)
        f.flush()
        os.fsync(f.fileno())
    fsync_dir(os.path.dirname(os.path.abspath(path)))
    if torn:
        from .failureinjector import InjectedCrash
        raise InjectedCrash(f"torn journal append at {path}")


def replay_journal(path: str):
    """Decode journal records, stopping cleanly at the first torn or
    corrupt frame. Returns (records, torn_tail)."""
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except OSError:
        return [], False
    recs, off = [], 0
    while off < len(buf):
        if buf[off:off + 4] != JOURNAL_MAGIC or off + 12 > len(buf):
            return recs, True
        crc, ln = struct.unpack_from("<II", buf, off + 4)
        body = buf[off + 12:off + 12 + ln]
        if len(body) != ln or (_crc32c(body) & 0xFFFFFFFF) != crc:
            return recs, True
        try:
            recs.append(json.loads(body.decode()))
        except ValueError:
            return recs, True
        off += 12 + ln
    return recs, False


# --------------------------------------------------------------------------
# commit (coordinator side)
# --------------------------------------------------------------------------

def dedup_manifests(manifests):
    """First-success-wins by (stage, partition): scheduler retries and
    straggler hedges can report duplicate attempts for one partition;
    exactly one may publish. Returns (chosen, n_deduped)."""
    chosen, deduped = {}, 0
    for m in manifests:
        key = (m["stage"], m["partition"])
        if key in chosen:
            deduped += 1
        else:
            chosen[key] = m
    ordered = [chosen[k] for k in sorted(chosen)]
    return ordered, deduped


def commit(table_dir: str, query_id: str, manifests, injector=None,
           tracer=None, fence=None) -> dict:
    """Publish deduped staged files transactionally. The INTENT journal
    record (durable before any rename) is the commit point: recovery
    rolls the full rename set forward from it; without it, staged files
    are swept. Idempotent per query id. `tracer`, when given, nests
    write-publish / write-sweep child spans under the caller's
    write-commit span so the commit's phases show in the query trace.
    The fence check, the already-committed check and the whole publish
    run under the table lock."""
    from ..utils.tracing import NOOP
    tracer = tracer or NOOP
    chosen, deduped = dedup_manifests(manifests)
    tok = qtoken(query_id)
    if injector is not None:
        injector.maybe_fail(WRITE_COMMIT, query_id)
    with table_lock(table_dir):
        check_fence(fence, "commit", table_dir, query_id)
        already = published_rows_for(table_dir, query_id)
        if already is not None:          # prior attempt already committed
            _sweep_query(table_dir, query_id)
            return {"published": 0, "rows": already, "deduped": deduped,
                    "bytes": 0, "phase": "committed"}
        seq0 = len(list_parts(table_dir))
        files = []
        for i, m in enumerate(chosen):
            ext = os.path.splitext(m["path"])[1].lstrip(".")
            files.append({"src": m["path"],
                          "dst": os.path.join(table_dir, part_filename(
                              seq0 + i, tok, m["rows"], ext)),
                          "rows": m["rows"], "crc": m["crc"],
                          "zones": m.get("zones", {})})
        jpath = journal_path(table_dir, query_id)
        append_journal(jpath, {"rec": "intent", "query": query_id,
                               "files": [{k: f[k] for k in
                                          ("src", "dst", "rows", "crc")}
                                         for f in files]},
                       injector=injector, key=query_id)
        # ---- point of no return: roll forward from here ----
        with tracer.span("write-publish", files=len(files)):
            for f in files:
                if injector is not None:
                    injector.maybe_fail(WRITE_PUBLISH, f["dst"])
                _publish_one(f["src"], f["dst"])
            fsync_dir(table_dir)
            append_journal(jpath, {"rec": "commit", "query": query_id})
        with tracer.span("write-sweep"):
            _sweep_query(table_dir, query_id)
            try:
                os.unlink(jpath)
            except OSError:
                pass
            fsync_dir(table_dir)
    WRITE_COMMITS.inc(outcome="committed")
    rows = sum(f["rows"] for f in files)
    log.info("%scommitted %d parts (%d rows, %d deduped) in %s",
             query_context(query_id), len(files), rows, deduped, table_dir)
    return {"published": len(files), "deduped": deduped,
            "rows": rows,
            "bytes": sum(m["bytes"] for m in chosen),
            "phase": "committed"}


def _publish_one(src: str, dst: str) -> None:
    if os.path.exists(src):
        os.replace(src, dst)
    elif not os.path.exists(dst):
        raise IOError(f"write commit lost {src} (and {dst} absent)")


def abort(table_dir: str, query_id: str, fence=None) -> None:
    """Abandon a write that never reached its INTENT record: sweep this
    query's staging attempts and any torn journal."""
    if not os.path.isdir(table_dir):
        return
    with table_lock(table_dir):
        check_fence(fence, "abort", table_dir, query_id)
        recs, _ = replay_journal(journal_path(table_dir, query_id))
        if any(r.get("rec") == "intent" for r in recs):
            # intent is durable: the write must roll forward, not abort
            _recover(table_dir)
            return
        n = _sweep_query(table_dir, query_id)
        try:
            os.unlink(journal_path(table_dir, query_id))
            n += 1
        except OSError:
            pass
    if n:
        WRITE_ORPHANS_SWEPT.inc(n)
    WRITE_COMMITS.inc(outcome="aborted")
    log.info("%saborted write: swept %d staging artifacts in %s",
             query_context(query_id), n, table_dir)


def _sweep_query(table_dir: str, query_id: str) -> int:
    """Remove this query's staging attempts (all of them — duplicates
    from hedged attempts included). The caller holds the table lock."""
    sdir = staging_dir(table_dir)
    tok = qtoken(query_id)
    n = 0
    if os.path.isdir(sdir):
        for f in os.listdir(sdir):
            if f.startswith(f"{tok}_"):
                try:
                    os.unlink(os.path.join(sdir, f))
                    n += 1
                except OSError:
                    pass
        _rmdir_if_empty(sdir)
    return n


def _rmdir_if_empty(d: str) -> None:
    try:
        os.rmdir(d)
    except OSError:
        pass


# --------------------------------------------------------------------------
# recovery (abort path + connector startup)
# --------------------------------------------------------------------------

def recover_table_dir(table_dir: str, fence=None,
                      query_id: str = "") -> dict:
    """Replay any journals in a table directory and finish or undo the
    protocol: durable INTENT -> roll the renames forward; torn or absent
    INTENT -> roll back. Then sweep all remaining staging files and temp
    names. Idempotent — safe to run any number of times, after a crash
    at any point. `query_id` names the caller's query in a refusal."""
    if not os.path.isdir(table_dir):
        return {"rolled_forward": 0, "swept": 0}
    with table_lock(table_dir):
        check_fence(fence, "recover", table_dir, query_id)
        return _recover(table_dir)


def _recover(table_dir: str) -> dict:
    out = {"rolled_forward": 0, "swept": 0}
    for jf in sorted(os.listdir(table_dir)):
        if not jf.endswith(".journal"):
            continue
        jpath = os.path.join(table_dir, jf)
        recs, _torn = replay_journal(jpath)
        intent = next((r for r in recs if r.get("rec") == "intent"), None)
        if intent is not None:
            for f in intent["files"]:
                _publish_one(f["src"], f["dst"])
                out["rolled_forward"] += 1
            fsync_dir(table_dir)
        try:
            os.unlink(jpath)
            out["swept"] += 1
        except OSError:
            pass
    sdir = staging_dir(table_dir)
    if os.path.isdir(sdir):
        for f in os.listdir(sdir):
            try:
                os.unlink(os.path.join(sdir, f))
                out["swept"] += 1
            except OSError:
                pass
        _rmdir_if_empty(sdir)
    for f in os.listdir(table_dir):
        if f.startswith(".tmp."):
            try:
                os.unlink(os.path.join(table_dir, f))
                out["swept"] += 1
            except OSError:
                pass
    if out["swept"]:
        WRITE_ORPHANS_SWEPT.inc(out["swept"])
    return out


def sweep_root(root: str) -> dict:
    """Connector-startup sweep: recover every table directory under
    `<root>/<schema>/` so no crash can leak staging state or a torn
    journal into a serving connector."""
    total = {"rolled_forward": 0, "swept": 0}
    if not os.path.isdir(root):
        return total
    for schema in os.listdir(root):
        sdir = os.path.join(root, schema)
        if not os.path.isdir(sdir):
            continue
        for entry in os.listdir(sdir):
            tdir = os.path.join(sdir, entry)
            if not os.path.isdir(tdir):
                continue
            r = recover_table_dir(tdir)
            total["rolled_forward"] += r["rolled_forward"]
            total["swept"] += r["swept"]
            # a rolled-back CTAS can leave an empty table dir behind
            _rmdir_if_empty(tdir)
    return total
