"""The canonical form of a corpus query's rows, shared by
tools/corpus_reference.py (which writes tests/torch_corpus_sf1.json from
the reference's rows at SF1), chip_smoke.py's `phase_corpus_card` (which
holds the card's rows against that file) and the tests.

The rule is the parity test's (tests/test_torch_parity.py): each row is
the `repr` of its tuple, exact to the bit for a double and telling -0.0
from 0.0; the rows keep their order where the query ends in ORDER BY
outside every parenthesis, and are sorted otherwise. A digest is the
SHA-256 of the canonical rows joined by newlines.

A generated table's digest is the SHA-256 of its columns: each field's
name, type and dictionary, the column's dtype and bytes, and its null
mask where it has one.

This module imports neither jax nor the reference package, so the
port's scripts can read it on a machine that has neither."""

import hashlib
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SF1_FILE = os.path.join(HERE, "torch_corpus_sf1.json")
SUITES = ("tpch", "tpcds")
# a query the reference answers slower than this at SF1 is recorded as
# not answered
REFERENCE_TIMEOUT_S = 600
HEAD_ROWS = 3


def ends_in_order_by(sql: str) -> bool:
    """Whether `sql` has an ORDER BY outside every parenthesis."""
    up, depth = sql.upper(), 0
    for i, ch in enumerate(up):
        depth += (ch == "(") - (ch == ")")
        if depth == 0 and up.startswith("ORDER BY", i):
            return True
    return False


def canonical_rows(sql: str, rows) -> list:
    """The `repr` of each row tuple: in order where `sql` ends in ORDER
    BY, sorted otherwise."""
    out = [repr(tuple(r)) for r in rows]
    return out if ends_in_order_by(sql) else sorted(out)


def rows_digest(canonical: list) -> str:
    return hashlib.sha256("\n".join(canonical).encode()).hexdigest()


def summary(sql: str, rows) -> dict:
    """What the file keeps of one answer: the row count, the digest of
    the canonical rows and the first HEAD_ROWS of them."""
    canon = canonical_rows(sql, rows)
    return {"rows": len(canon), "sha256": rows_digest(canon),
            "head": canon[:HEAD_ROWS]}


def first_difference(sql: str, got, want_head: list):
    """(index, got row, want row or None) of the first canonical row of
    `got` that differs from `want_head`, the reference's first rows;
    None where `got` agrees with all of them."""
    canon = canonical_rows(sql, got)
    for i, w in enumerate(want_head):
        g = canon[i] if i < len(canon) else None
        if g != w:
            return i, g, w
    return None


def table_digest(t) -> str:
    """SHA-256 of a generated table (either package's TableData)."""
    h = hashlib.sha256()
    for i, f in enumerate(t.schema.fields):
        h.update(repr((f.name, str(f.dtype))).encode())
        if f.dictionary is not None:
            h.update(json.dumps(list(f.dictionary)).encode())
        col = np.ascontiguousarray(t.columns[i])
        h.update(col.dtype.str.encode())
        h.update(col.tobytes())
        valid = None if t.valids is None else t.valids[i]
        if valid is not None:
            h.update(b"valid")
            h.update(np.ascontiguousarray(valid, dtype=np.bool_).tobytes())
    return h.hexdigest()


def suite_queries(suite: str) -> dict:
    """The query texts of a suite, by number."""
    if suite == "tpch":
        from tpch_full import QUERIES
    else:
        from tpcds_queries import QUERIES
    return QUERIES


def key(suite: str, q: int) -> str:
    """A query's key in the file: `tpch:1`, `tpcds:95`."""
    return f"{suite}:{q}"


def load(path: str = SF1_FILE) -> dict:
    with open(path) as f:
        return json.load(f)
