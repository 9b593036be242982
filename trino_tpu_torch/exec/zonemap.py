"""Port copy of ``trino_tpu/exec/zonemap.py`` (no edits beyond import targets
noted inline).

Zone maps: per-row-range min/max/null statistics for scan pruning.

Reference: Trino's stripe/row-group skipping in trino-orc
(StripeReader.java) and trino-parquet (TupleDomainParquetPredicate) —
TupleDomain pushdown decides from column statistics whether a range of
rows can possibly satisfy a predicate, and skips decoding it otherwise.

Here the same idea covers every connector uniformly: a ZoneMap slices a
materialized TableData into fixed `zone_rows` ranges and records, per
zone per column, (min, max, null_count, row_count) in the column's
PHYSICAL representation (scaled int64 for DECIMAL, int32 days for DATE,
int32 dictionary codes for VARCHAR — pools are sorted engine-wide, so
code order is string order).

Evaluation is strictly conservative three-valued logic: a zone is pruned
only when the pushed conjunction provably cannot evaluate to TRUE for
any row in the zone. NULLs follow SQL semantics (a comparison against a
zone of all NULLs is never TRUE; IS NULL survives it), floating-point
zones containing NaN record unknown bounds and always survive, and
DECIMAL bounds compare through ops/project's exact scaled-int helpers so
HALF_UP semantics cannot drift from the device filter. The residual
FilterNode always re-runs, so pruning is a pure skip optimization.
"""

from __future__ import annotations

import operator
import threading
from collections import OrderedDict
from dataclasses import dataclass
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np

from .. import ir
from ..types import TypeKind

DEFAULT_ZONE_ROWS = 65536

_FLIP = {"=": "=", "<>": "<>", "<": ">", "<=": ">=", ">": "<", ">=": "<="}
_OPS = {"=": operator.eq, "<>": operator.ne, "<": operator.lt,
        "<=": operator.le, ">": operator.gt, ">=": operator.ge}


@dataclass(frozen=True)
class ColumnZone:
    """Physical-representation bounds for one column over one row range.
    min/max are None when unknown (all-NULL zone, NaN present, or a type
    with no meaningful order) — an unknown bound never prunes."""
    min: Optional[object]
    max: Optional[object]
    null_count: int
    row_count: int


@dataclass(frozen=True)
class ZoneMap:
    zone_rows: int
    row_count: int
    starts: Tuple[int, ...]
    counts: Tuple[int, ...]
    zones: Tuple[Tuple[ColumnZone, ...], ...]   # [zone][table column]

    @property
    def num_zones(self) -> int:
        return len(self.starts)


def build_zone_map(data, zone_rows: int = DEFAULT_ZONE_ROWS) -> ZoneMap:
    """One numpy pass per (zone, column) over a TableData."""
    n = data.num_rows
    zone_rows = max(1, int(zone_rows))
    cols = [np.asarray(c) for c in data.columns]
    valids = [None] * len(cols) if data.valids is None else \
        [None if v is None else np.asarray(v) for v in data.valids]
    starts, counts, zones = [], [], []
    for start in range(0, max(n, 1), zone_rows):
        count = min(zone_rows, n - start)
        if count <= 0:
            break
        zcols = []
        for arr, valid in zip(cols, valids):
            sl = arr[start:start + count]
            if valid is not None:
                v = valid[start:start + count]
                nulls = int(count - v.sum())
                sl = sl[v]
            else:
                nulls = 0
            if len(sl) == 0:
                zcols.append(ColumnZone(None, None, nulls, count))
                continue
            if np.issubdtype(sl.dtype, np.floating) and \
                    bool(np.isnan(sl).any()):
                # NaN breaks min/max ordering: leave bounds unknown so
                # the zone always survives
                zcols.append(ColumnZone(None, None, nulls, count))
                continue
            zcols.append(ColumnZone(sl.min().item(), sl.max().item(),
                                    nulls, count))
        starts.append(start)
        counts.append(count)
        zones.append(tuple(zcols))
    return ZoneMap(zone_rows, n, tuple(starts), tuple(counts),
                   tuple(zones))


# ---- cache (keyed by table-data identity) --------------------------------
#
# The cache holds a strong reference to the TableData it describes, so a
# live entry can never alias a recycled id(); connector mutations rebuild
# TableData (memory connector INSERT/UPDATE/DELETE produce a new object),
# which self-invalidates by key.

_CACHE_MAX = 32
_cache: "OrderedDict[int, tuple]" = OrderedDict()
_cache_lock = threading.Lock()


def zone_map_for(data, zone_rows: int = DEFAULT_ZONE_ROWS) -> ZoneMap:
    key = id(data)
    with _cache_lock:
        hit = _cache.get(key)
        if hit is not None and hit[0] is data and zone_rows in hit[1]:
            _cache.move_to_end(key)
            return hit[1][zone_rows]
    zm = build_zone_map(data, zone_rows)
    with _cache_lock:
        hit = _cache.get(key)
        if hit is None or hit[0] is not data:
            hit = (data, {})
            _cache[key] = hit
        hit[1][zone_rows] = zm
        _cache.move_to_end(key)
        while len(_cache) > _CACHE_MAX:
            _cache.popitem(last=False)
    return zm


def note_table(data, zone_rows: int = DEFAULT_ZONE_ROWS) -> ZoneMap:
    """Eager collection hook (memory-connector insert/CTAS time)."""
    return zone_map_for(data, zone_rows)


def invalidate_zone_maps() -> None:
    with _cache_lock:
        _cache.clear()


# ---- conservative zone evaluation ----------------------------------------


def _scalar_cmp(op: str, a, adt, b, bdt) -> bool:
    """Exact comparison of two physical scalars of (possibly different)
    SQL types. DECIMAL pairs go through ops/project's scaled-int compare
    (the device path's helper — HALF_UP semantics shared by
    construction); DECIMAL-vs-DOUBLE compares exactly via Fraction;
    everything else is exact native Python comparison (int vs float is
    exact in Python)."""
    a_dec = adt.kind is TypeKind.DECIMAL
    b_dec = bdt.kind is TypeKind.DECIMAL
    if a_dec or b_dec:
        sa = adt.scale if a_dec else 0
        sb = bdt.scale if b_dec else 0
        if adt.kind is TypeKind.DOUBLE or bdt.kind is TypeKind.DOUBLE:
            fa = Fraction(int(a), 10 ** sa) if a_dec else Fraction(a)
            fb = Fraction(int(b), 10 ** sb) if b_dec else Fraction(b)
            return bool(_OPS[op](fa, fb))
        from ..ops.project import _decimal_compare
        return bool(_decimal_compare(np.int64(int(a)), sa,
                                     np.int64(int(b)), sb, op, xp=np))
    return bool(_OPS[op](a, b))


def _zone_of(expr: ir.ColumnRef, zone_cols, column_indices):
    return zone_cols[column_indices[expr.index]]


def _may_match(e: ir.Expr, zone_cols, column_indices) -> bool:
    """May `e` evaluate to TRUE for some row in the zone? True unless
    provably impossible. Any shape (or failure) we cannot reason about
    returns True — pruning is advisory only."""
    try:
        if isinstance(e, ir.Logical):
            if e.op == "and":
                return all(_may_match(a, zone_cols, column_indices)
                           for a in e.args)
            return True                       # OR et al: no pruning
        if isinstance(e, ir.IsNull):
            if not isinstance(e.arg, ir.ColumnRef):
                return True
            z = _zone_of(e.arg, zone_cols, column_indices)
            if e.negated:                     # IS NOT NULL
                return z.null_count < z.row_count
            return z.null_count > 0           # IS NULL
        if isinstance(e, ir.DictPredicate):
            if not isinstance(e.arg, ir.ColumnRef):
                return True
            z = _zone_of(e.arg, zone_cols, column_indices)
            if z.null_count >= z.row_count:
                return False                  # all NULL: never TRUE
            if z.min is None or z.max is None:
                return True
            lo = max(0, int(z.min))
            hi = min(len(e.lut) - 1, int(z.max))
            return any(e.lut[lo:hi + 1])
        if isinstance(e, ir.Compare):
            left, right, op = e.left, e.right, e.op
            if isinstance(left, ir.Literal) and \
                    isinstance(right, ir.ColumnRef):
                left, right, op = right, left, _FLIP[op]
            if not (isinstance(left, ir.ColumnRef) and
                    isinstance(right, ir.Literal)):
                return True
            if left.dtype.kind in (TypeKind.VARCHAR, TypeKind.ARRAY):
                return True                   # strings go via DictPredicate
            z = _zone_of(left, zone_cols, column_indices)
            if z.null_count >= z.row_count or right.value is None:
                return False                  # NULL comparand: never TRUE
            if z.min is None or z.max is None:
                return True
            cdt, v, ldt = left.dtype, right.value, right.dtype
            if op == "<":
                return _scalar_cmp("<", z.min, cdt, v, ldt)
            if op == "<=":
                return _scalar_cmp("<=", z.min, cdt, v, ldt)
            if op == ">":
                return _scalar_cmp(">", z.max, cdt, v, ldt)
            if op == ">=":
                return _scalar_cmp(">=", z.max, cdt, v, ldt)
            if op == "=":
                return _scalar_cmp("<=", z.min, cdt, v, ldt) and \
                    _scalar_cmp(">=", z.max, cdt, v, ldt)
            if op == "<>":
                # only impossible when the zone is the single value v
                return not (_scalar_cmp("=", z.min, cdt, v, ldt) and
                            _scalar_cmp("=", z.max, cdt, v, ldt))
            return True
        if isinstance(e, ir.Between):
            if not (isinstance(e.arg, ir.ColumnRef) and
                    isinstance(e.low, ir.Literal) and
                    isinstance(e.high, ir.Literal)):
                return True
            if e.arg.dtype.kind in (TypeKind.VARCHAR, TypeKind.ARRAY):
                return True
            z = _zone_of(e.arg, zone_cols, column_indices)
            if z.null_count >= z.row_count or e.low.value is None or \
                    e.high.value is None:
                return False
            if z.min is None or z.max is None:
                return True
            return _scalar_cmp(">=", z.max, e.arg.dtype,
                               e.low.value, e.low.dtype) and \
                _scalar_cmp("<=", z.min, e.arg.dtype,
                            e.high.value, e.high.dtype)
        if isinstance(e, ir.InList):
            if not isinstance(e.arg, ir.ColumnRef) or \
                    not all(isinstance(v, ir.Literal) for v in e.values):
                return True
            if e.arg.dtype.kind in (TypeKind.VARCHAR, TypeKind.ARRAY):
                return True
            z = _zone_of(e.arg, zone_cols, column_indices)
            if z.null_count >= z.row_count:
                return False
            if z.min is None or z.max is None:
                return True
            return any(
                v.value is not None and
                _scalar_cmp("<=", z.min, e.arg.dtype, v.value, v.dtype) and
                _scalar_cmp(">=", z.max, e.arg.dtype, v.value, v.dtype)
                for v in e.values)
        return True
    except Exception:
        return True


def surviving_zone_indices(zm: ZoneMap, predicate: ir.Expr,
                           column_indices) -> list:
    """Zone indices that may contain matching rows. `predicate`
    references scan OUTPUT positions; `column_indices` maps them to
    table columns."""
    return [i for i, zcols in enumerate(zm.zones)
            if _may_match(predicate, zcols, column_indices)]


def surviving_ranges(zm: ZoneMap, predicate: ir.Expr,
                     column_indices) -> list:
    """Merged (start, count) row ranges covering every surviving zone."""
    ranges = []
    for i in surviving_zone_indices(zm, predicate, column_indices):
        s, c = zm.starts[i], zm.counts[i]
        if ranges and ranges[-1][0] + ranges[-1][1] == s:
            ranges[-1][1] += c
        else:
            ranges.append([s, c])
    return [(s, c) for s, c in ranges]


def range_may_match(zm: ZoneMap, predicate: ir.Expr, column_indices,
                    start: int, count: int) -> bool:
    """May any row in [start, start+count) match? Used by the scheduler
    to drop whole splits and by the chunked driver to skip chunks."""
    end = start + count
    for i, (s, c) in enumerate(zip(zm.starts, zm.counts)):
        if s >= end:
            break
        if s + c <= start:
            continue
        if _may_match(predicate, zm.zones[i], column_indices):
            return True
    return False


def column_ranges(predicate: ir.Expr, column_indices, schema) -> dict:
    """Lower the pushed conjunction to {column_name: (lo, hi)} inclusive
    physical bounds for file readers (ORC stripe / Parquet row-group
    skipping). Only closed, numeric, single-column bounds translate;
    anything else is simply not tightened (None side = unbounded)."""
    out: dict = {}

    def tighten(name, lo, hi):
        plo, phi = out.get(name, (None, None))
        if lo is not None:
            plo = lo if plo is None else max(plo, lo)
        if hi is not None:
            phi = hi if phi is None else min(phi, hi)
        out[name] = (plo, phi)

    stack = [predicate]
    while stack:
        e = stack.pop()
        if isinstance(e, ir.Logical) and e.op == "and":
            stack.extend(e.args)
            continue
        if isinstance(e, ir.Compare):
            left, right, op = e.left, e.right, e.op
            if isinstance(left, ir.Literal) and \
                    isinstance(right, ir.ColumnRef):
                left, right, op = right, left, _FLIP[op]
            if not (isinstance(left, ir.ColumnRef) and
                    isinstance(right, ir.Literal)) or right.value is None:
                continue
            if left.dtype.kind in (TypeKind.VARCHAR, TypeKind.ARRAY) or \
                    left.dtype != right.dtype:
                continue                      # readers compare same-type
            name = schema.fields[column_indices[left.index]].name
            v = right.value
            if op in ("<", "<="):
                tighten(name, None, v)
            elif op in (">", ">="):
                tighten(name, v, None)
            elif op == "=":
                tighten(name, v, v)
        elif isinstance(e, ir.Between):
            if isinstance(e.arg, ir.ColumnRef) and \
                    isinstance(e.low, ir.Literal) and \
                    isinstance(e.high, ir.Literal) and \
                    e.arg.dtype.kind not in (TypeKind.VARCHAR,
                                             TypeKind.ARRAY) and \
                    e.low.value is not None and e.high.value is not None \
                    and e.arg.dtype == e.low.dtype == e.high.dtype:
                name = schema.fields[column_indices[e.arg.index]].name
                tighten(name, e.low.value, e.high.value)
    return {k: v for k, v in out.items() if v != (None, None)}
