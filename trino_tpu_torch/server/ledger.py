"""Port copy of ``trino_tpu/server/ledger.py``; the one addition is
`QueryLedger.fence_refusals`, the fence's record (the ledger's and
the epoch file's bytes are the reference's).

Durable coordinator query ledger + epoch-fenced failover state.

The coordinator analogue of the round-18 write-commit journal: an
append-only, CRC-framed, fsync'd record of everything the coordinator
must not forget across a crash — query admission (SQL, principal,
session props, plan fingerprint), every state transition, task/stage
assignments, result-spool pointers, and terminal outcomes. Replaying
any byte prefix of the file is safe (torn tails are tolerated exactly
like the write journal's), and replay is a pure fold into `LedgerView`
whose `apply` is idempotent — double replay, or replay interleaved with
live appends after a resume, converges to the same registry /
resource-group / catalog-version state.

Fencing: leadership is an epoch in a sidecar file (`<ledger>.epoch`),
bumped atomically (tmp + rename + dir fsync) by `claim_epoch` at
promotion. Every append re-checks ownership (TTL-cached); a deposed
primary's appends become no-ops and `owns_epoch()` flips false, which
the coordinator uses to demote itself — the classic fencing-token
scheme, so a resurrected old primary can never split-brain the ledger.

The frame format is writeprotocol's (`TWJ1` magic + crc32c + length +
sorted-keys JSON) so the torn-tail replay machinery is shared, not
re-implemented.
"""

import json
import logging
import os
import threading
import time

from ..metrics import LEDGER_BYTES, LEDGER_RECORDS
from ..utils.atomicio import fsync_dir
from .writeprotocol import JOURNAL_MAGIC, _frame, replay_journal

log = logging.getLogger("trino_tpu.ledger")

# record kinds, also the lint-enforced label values of
# trino_tpu_ledger_records_total{kind=...}
KINDS = ("admit", "state", "assign", "spool", "terminal", "catalog",
         "promote")

# lifecycle order for the view's monotonic state advance (terminal
# states compare equal-highest: a terminal record always wins)
_ORDER = ("QUEUED", "PLANNING", "STARTING", "RUNNING", "FINISHING",
          "FINISHED", "FAILED", "CANCELED")
_TERMINAL = ("FINISHED", "FAILED", "CANCELED")


def _rank(state: str) -> int:
    try:
        i = _ORDER.index(state)
    except ValueError:
        return -1
    return len(_ORDER) if state in _TERMINAL else i


class LedgerView:
    """Pure fold over ledger records. `apply` is idempotent per record
    content: first-wins for admission facts and timestamps, monotonic
    max for lifecycle state / catalog version / epoch — so replaying a
    prefix, the whole file, or the whole file twice all agree."""

    def __init__(self):
        self.queries = {}           # qid -> dict
        self.catalog_version = 0
        self.epoch = 0
        self.promotions = []        # [(epoch, node)] in epoch order

    def _q(self, qid: str) -> dict:
        return self.queries.setdefault(qid, {
            "query_id": qid, "sql": None, "user": None, "tenant": None,
            "fingerprint": None, "properties": {}, "state": "QUEUED",
            "state_times": {}, "assigned": {}, "spooled": [],
            "terminal": None, "error": None, "error_name": None,
            "error_code": 0, "rows": None, "elapsed_s": None,
        })

    def apply(self, rec: dict) -> None:
        kind = rec.get("rec")
        if kind == "admit":
            q = self._q(rec["query"])
            if q["sql"] is None:            # first admit wins
                q["sql"] = rec.get("sql")
                q["user"] = rec.get("user")
                q["tenant"] = rec.get("tenant")
                q["fingerprint"] = rec.get("fingerprint")
                q["properties"] = dict(rec.get("properties") or {})
            q["state_times"].setdefault("QUEUED", rec.get("ts", 0.0))
        elif kind == "state":
            q = self._q(rec["query"])
            st = rec.get("state", "")
            q["state_times"].setdefault(st, rec.get("ts", 0.0))
            if _rank(st) > _rank(q["state"]) and q["terminal"] is None:
                q["state"] = st
        elif kind == "terminal":
            q = self._q(rec["query"])
            st = rec.get("state", "FAILED")
            q["state_times"].setdefault(st, rec.get("ts", 0.0))
            if q["terminal"] is None:       # first terminal wins
                q["terminal"] = st
                q["state"] = st
                q["error"] = rec.get("error")
                q["error_name"] = rec.get("error_name")
                q["error_code"] = rec.get("error_code", 0)
                q["rows"] = rec.get("rows")
                q["elapsed_s"] = rec.get("elapsed_s")
            if rec.get("catalog_version"):
                self.catalog_version = max(self.catalog_version,
                                           rec["catalog_version"])
        elif kind == "assign":
            q = self._q(rec["query"])
            q["assigned"].setdefault(rec["task"], {
                "node": rec.get("node"), "stage": rec.get("stage")})
        elif kind == "spool":
            q = self._q(rec["query"])
            if rec["key"] not in q["spooled"]:
                q["spooled"].append(rec["key"])
        elif kind == "catalog":
            self.catalog_version = max(self.catalog_version,
                                       rec.get("version", 0))
        elif kind == "promote":
            e = rec.get("epoch", 0)
            if e > self.epoch:
                self.epoch = e
                self.promotions.append((e, rec.get("node")))

    def live(self):
        """Non-terminal queries, in admission order (qids sort by
        admission thanks to the tracker's timestamped sequence ids)."""
        return [q for _, q in sorted(self.queries.items())
                if q["terminal"] is None]

    def fingerprint(self) -> str:
        """Canonical digest of the whole view — the idempotence oracle
        the replay tests compare across single/double/prefix replays."""
        import hashlib
        blob = json.dumps(
            {"queries": self.queries,
             "catalog_version": self.catalog_version,
             "epoch": self.epoch, "promotions": self.promotions},
            sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()


class QueryLedger:
    """Append side + replay + epoch fencing for one ledger file."""

    EPOCH_TTL_S = 0.25          # ownership re-check cadence on append

    def __init__(self, path: str, node_id: str = "coordinator"):
        self.path = os.path.abspath(path)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self.node_id = node_id
        self.sealed = False
        # changes to shared state (table directories, worker tasks) the
        # fence refused this node (server/writeprotocol.refuse), oldest
        # first
        self.fence_refusals = []
        self._lock = threading.RLock()
        self._owner_checked = 0.0
        self._owner = None          # cached (epoch, node)

    # ---- epoch fencing ---------------------------------------------------

    @property
    def epoch_path(self) -> str:
        return self.path + ".epoch"

    def read_epoch(self):
        """(epoch, owner_node) from the sidecar; (0, None) if never
        claimed — the unfenced single-coordinator mode."""
        try:
            with open(self.epoch_path) as f:
                doc = json.load(f)
            return int(doc.get("epoch", 0)), doc.get("node")
        except (OSError, ValueError):
            return 0, None

    def claim_epoch(self) -> int:
        """Atomically bump the epoch and take ownership. The returned
        token fences every previous holder: their cached ownership
        expires within EPOCH_TTL_S and appends turn into no-ops."""
        with self._lock:
            cur, _ = self.read_epoch()
            new = cur + 1
            tmp = self.epoch_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"epoch": new, "node": self.node_id}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.epoch_path)
            fsync_dir(os.path.dirname(self.epoch_path))
            self._owner = (new, self.node_id)
            self._owner_checked = time.monotonic()
            self.append({"rec": "promote", "epoch": new,
                         "node": self.node_id, "ts": time.time()})
            log.info("ledger epoch %d claimed by %s", new, self.node_id)
            return new

    def owns_epoch(self, force: bool = False) -> bool:
        """True while this node may append. An unclaimed ledger is
        owned by everyone (no failover configured yet)."""
        now = time.monotonic()
        if force or self._owner is None or \
                now - self._owner_checked > self.EPOCH_TTL_S:
            self._owner = self.read_epoch()
            self._owner_checked = now
        epoch, node = self._owner
        return epoch == 0 or node == self.node_id

    # ---- append side -----------------------------------------------------

    def seal(self) -> None:
        """In-process crash model: a sealed ledger accepts no appends,
        exactly as if the coordinator process died."""
        self.sealed = True

    def append(self, rec: dict) -> bool:
        """Append one fenced, fsync'd record. Returns False (no-op)
        when sealed or deposed — callers never need to special-case a
        lost leadership race; the record simply does not happen."""
        with self._lock:
            if self.sealed or not self.owns_epoch():
                return False
            frame = _frame(rec)
            with open(self.path, "ab") as f:
                f.write(frame)
                f.flush()
                os.fsync(f.fileno())
                size = f.tell()
            fsync_dir(os.path.dirname(self.path))
        kind = rec.get("rec", "")
        if kind in KINDS:
            LEDGER_RECORDS.inc(kind=kind)
        LEDGER_BYTES.set(size)
        return True

    # typed appenders ------------------------------------------------------

    def admit(self, qid: str, sql: str, user: str, tenant: str,
              fingerprint: str, properties: dict) -> bool:
        props = {k: v for k, v in (properties or {}).items()
                 if isinstance(v, (str, int, float, bool))}
        return self.append({"rec": "admit", "query": qid, "sql": sql,
                            "user": user, "tenant": tenant,
                            "fingerprint": fingerprint,
                            "properties": props, "ts": time.time()})

    def state(self, qid: str, state: str, ts: float) -> bool:
        return self.append({"rec": "state", "query": qid, "state": state,
                            "ts": ts})

    def terminal(self, qid: str, state: str, ts: float, error=None,
                 error_name=None, error_code=0, rows=None,
                 elapsed_s=None, catalog_version=0) -> bool:
        return self.append({
            "rec": "terminal", "query": qid, "state": state, "ts": ts,
            "error": error, "error_name": error_name,
            "error_code": error_code, "rows": rows,
            "elapsed_s": elapsed_s, "catalog_version": catalog_version})

    def assign(self, qid: str, task: str, node: str, stage: str) -> bool:
        return self.append({"rec": "assign", "query": qid, "task": task,
                            "node": node, "stage": stage,
                            "ts": time.time()})

    def spool(self, qid: str, key: str) -> bool:
        return self.append({"rec": "spool", "query": qid, "key": key,
                            "ts": time.time()})

    # ---- replay side -----------------------------------------------------

    def replay(self):
        """(LedgerView, torn_tail) — a pure function of the file bytes
        plus the epoch sidecar, safe on torn tails and safe to call any
        number of times."""
        return replay_path(self.path)

    def tail_records(self, offset: int):
        """Complete frames at/after byte `offset`; returns
        (records, new_offset). Torn or incomplete tails leave the
        offset at the last complete frame so the standby's tail loop
        just retries — the same contract as replay_journal, but
        incremental."""
        import struct
        try:
            with open(self.path, "rb") as f:
                f.seek(offset)
                buf = f.read()
        except OSError:
            return [], offset
        from .pageserde import _crc32c
        recs, off = [], 0
        while off + 12 <= len(buf):
            if buf[off:off + 4] != JOURNAL_MAGIC:
                break
            crc, ln = struct.unpack_from("<II", buf, off + 4)
            body = buf[off + 12:off + 12 + ln]
            if len(body) != ln or (_crc32c(body) & 0xFFFFFFFF) != crc:
                break
            try:
                recs.append(json.loads(body.decode()))
            except ValueError:
                break
            off += 12 + ln
        return recs, offset + off


def replay_path(path: str):
    """Replay a ledger file (possibly truncated mid-frame) into a
    LedgerView. The epoch sidecar, when present, floors the view's
    epoch so fencing survives even a fully torn ledger tail."""
    view = LedgerView()
    records, torn = replay_journal(path)
    for rec in records:
        view.apply(rec)
    try:
        with open(path + ".epoch") as f:
            doc = json.load(f)
        view.epoch = max(view.epoch, int(doc.get("epoch", 0)))
    except (OSError, ValueError):
        pass
    return view, torn
