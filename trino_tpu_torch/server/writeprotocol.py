"""Port copy of ``trino_tpu/server/writeprotocol.py`` (no edits beyond
the logger's name).

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
"""

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
           tracer=None) -> dict:
    """Publish deduped staged files transactionally. The INTENT journal
    record (durable before any rename) is the commit point: recovery
    rolls the full rename set forward from it; without it, staged files
    are swept. Idempotent per query id. `tracer`, when given, nests
    write-publish / write-sweep child spans under the caller's
    write-commit span so the commit's phases show in the query trace."""
    from ..utils.tracing import NOOP
    tracer = tracer or NOOP
    chosen, deduped = dedup_manifests(manifests)
    tok = qtoken(query_id)
    if injector is not None:
        injector.maybe_fail(WRITE_COMMIT, query_id)
    already = published_rows_for(table_dir, query_id)
    if already is not None:          # prior attempt already committed
        sweep_query(table_dir, query_id)
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
        sweep_query(table_dir, query_id)
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


def abort(table_dir: str, query_id: str) -> None:
    """Abandon a write that never reached its INTENT record: sweep this
    query's staging attempts and any torn journal."""
    recs, _ = replay_journal(journal_path(table_dir, query_id))
    if any(r.get("rec") == "intent" for r in recs):
        # intent is durable: the write must roll forward, not abort
        recover_table_dir(table_dir)
        return
    n = sweep_query(table_dir, query_id)
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


def sweep_query(table_dir: str, query_id: str) -> int:
    """Remove this query's staging attempts (all of them — duplicates
    from hedged attempts included)."""
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

def recover_table_dir(table_dir: str) -> dict:
    """Replay any journals in a table directory and finish or undo the
    protocol: durable INTENT -> roll the renames forward; torn or absent
    INTENT -> roll back. Then sweep all remaining staging files and temp
    names. Idempotent — safe to run any number of times, after a crash
    at any point."""
    out = {"rolled_forward": 0, "swept": 0}
    if not os.path.isdir(table_dir):
        return out
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
