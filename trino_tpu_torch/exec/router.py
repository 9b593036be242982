"""Cost-based host/device co-routing + the host numpy execution path.

Counterpart of ``trino_tpu/exec/router.py``. ``decide_route`` picks
'host' or 'device' for a pruned local plan exactly as the reference does
(``routing_mode``, the prewarm cold signal, per-tenant fair share, the
history median against ``router_host_latency_ms``, then the planner's
scan-row estimate against ``router_host_max_rows``), so both packages
route the same statement the same way.

``run_host`` is the reference's numpy interpreter for the host-eligible
subset (Scan/Filter/Project/global-Aggregate/Sort/Limit/Values over the
scalar expression IR). It never touches torch, the device or the shared
Executor, so host-routed queries run without the coordinator's exec
lock. Its arithmetic is the reference's HOST arithmetic, bit for bit:
the reference calls its device helpers (decimal rescale and compare, the
comparison cast, the decimal avg finalizer, the min/max identity) with
``xp=np``, and this module keeps numpy copies of exactly those versions
(``_np_rescale`` ... ``_np_identity``). The port's helpers of those names
are torch and mirror XLA's rewrites on purpose (a decimal->double
operand multiplies by the reciprocal of 10^s there; a float sum follows
XLA's reduction order), so they are never called here: on the host a
decimal->double operand divides by 10^s and a sum is ``np.sum``. A
DOUBLE result can therefore depend on the route, in the reference as in
the port.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .. import ir
from ..planner import logical as L
from ..types import TypeKind


class HostUnsupported(Exception):
    """Plan (or expression) outside the host interpreter's subset — the
    router falls back to the device path, never fails the query."""


@dataclass(frozen=True)
class RouteDecision:
    target: str          # 'host' | 'device'
    reason: str
    est_rows: float = 0.0


_HOST_AGGS = ("sum", "count", "count_star", "min", "max")

# expression kinds the numpy evaluator implements; anything else makes
# the plan device-only (ScalarSubqueryRef/InSubqueryRef need the
# executor's subquery folding, general ScalarFunc/ExtractField the device
# kernels). The two-limb decimal-sum scalars are whitelisted: wide
# decimal SUM plans route through them and they are two int ops each.
_HOST_EXPRS = (ir.ColumnRef, ir.Literal, ir.Arith, ir.Negate, ir.Compare,
               ir.Logical, ir.Not, ir.IsNull, ir.InList, ir.Between,
               ir.Case, ir.Cast, ir.DictPredicate, ir.DictValueMap,
               ir.DerivedDict, ir.DecimalAvg, ir.ArrayConst)

_HOST_SCALAR_FUNCS = ("$limb_hi", "$limb_lo", "$limb_combine")


def _subtree_nodes(node: L.PlanNode):
    yield node
    for c in L.children(node):
        yield from _subtree_nodes(c)


def _node_exprs(node: L.PlanNode):
    if isinstance(node, L.FilterNode):
        return (node.predicate,)
    if isinstance(node, L.ProjectNode):
        return node.exprs
    return ()


def _expr_supported(expr: ir.Expr) -> Optional[str]:
    for n in ir.walk(expr):
        if isinstance(n, ir.ScalarFunc):
            if n.name not in _HOST_SCALAR_FUNCS:
                return f"scalar function {n.name}"
        elif not isinstance(n, _HOST_EXPRS):
            return f"expression {type(n).__name__}"
    return None


def host_supported(root: L.PlanNode) -> Optional[str]:
    """None when the host interpreter can run this plan, else the first
    reason it cannot (surfaced in EXPLAIN's routing annotation)."""
    for node in _subtree_nodes(root):
        if isinstance(node, (L.OutputNode, L.LimitNode, L.ScanNode,
                             L.ValuesNode)):
            pass
        elif isinstance(node, L.SortNode):
            pass
        elif isinstance(node, (L.FilterNode, L.ProjectNode)):
            for e in _node_exprs(node):
                why = _expr_supported(e)
                if why is not None:
                    return why
        elif isinstance(node, L.AggregateNode):
            if node.group_keys or node.strategy != "global":
                return "grouped aggregation"
            for a in node.aggs:
                if a.distinct:
                    return "distinct aggregate"
                if a.func not in _HOST_AGGS:
                    return f"aggregate {a.func}"
                if a.arg is not None and not isinstance(a.arg,
                                                        ir.ColumnRef):
                    return "computed aggregate argument"
        else:
            return f"operator {type(node).__name__}"
    return None


def plan_scan_rows(planner, root: L.PlanNode) -> float:
    """Total estimated rows read by the plan's scans — the router's cost
    proxy (dispatch cost amortizes over rows touched, not rows
    returned)."""
    total = 0.0
    for n in _subtree_nodes(root):
        if isinstance(n, L.ScanNode):
            try:
                total += planner.estimate_rows(n)
            except Exception:       # noqa: BLE001 — stats are best-effort
                total += 1e6
        elif isinstance(n, L.ValuesNode):
            total += float(n.num_rows)
    return total


class TenantFairShare:
    """Per-tenant device-contention tracker for the router.

    The device tier serializes behind the coordinator's exec lock, so
    "contended" means: some OTHER tenant's query currently holds (or
    waits for) the device. Under contention a tenant's host-eligible
    queries overflow to the host tier instead of queueing behind a
    neighbor's scan — the co-processing split from "Revisiting
    Co-Processing for Hash Joins on the Coupled CPU-GPU Architecture":
    keep the accelerator for the work that amortizes it, and keep small
    tenants' latency off the contention path entirely. A tenant is
    never overflowed by ITS OWN in-flight device work (its queries
    serializing behind each other is its own fair queue)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._inflight: dict = {}

    def device_begin(self, tenant: str) -> None:
        with self._lock:
            self._inflight[tenant] = self._inflight.get(tenant, 0) + 1

    def device_end(self, tenant: str) -> None:
        with self._lock:
            n = self._inflight.get(tenant, 0) - 1
            if n <= 0:
                self._inflight.pop(tenant, None)
            else:
                self._inflight[tenant] = n

    def contended_by_others(self, tenant: str) -> bool:
        with self._lock:
            return any(n > 0 for t, n in self._inflight.items()
                       if t != tenant)

    def inflight(self) -> dict:
        with self._lock:
            return dict(self._inflight)


def decide_route(planner, root: L.PlanNode, properties,
                 history=None, fingerprint: Optional[str] = None,
                 tenant: Optional[str] = None,
                 fair_share: Optional[TenantFairShare] = None,
                 prewarm=None) -> RouteDecision:
    """Pick the execution target for a pruned local plan."""
    mode = str(properties.get("routing_mode", "auto")).lower()
    unsupported = host_supported(root)
    if mode == "device":
        return RouteDecision("device", "forced by routing_mode")
    if mode == "host":
        if unsupported is not None:
            return RouteDecision(
                "device", f"routing_mode=host but {unsupported}")
        return RouteDecision("host", "forced by routing_mode")
    if unsupported is not None:
        return RouteDecision("device", unsupported)
    # compile-aware routing (exec/prewarm.py): while this fingerprint's
    # device program is cold — a prewarm is still compiling it, or no
    # device run has compiled it yet — a host-eligible query runs on
    # the bit-exact numpy interpreter instead of blocking on a
    # multi-second XLA compile; the serving layer kicks a background
    # warm and the fingerprint swaps to device once it lands. A None /
    # disabled engine never reaches here, so prewarm-off behavior is
    # byte-identical to the pre-prewarm router.
    if prewarm is not None and fingerprint and \
            prewarm.device_cold(fingerprint):
        return RouteDecision(
            "host", "device program cold (prewarm in flight)"
            if prewarm.is_inflight(fingerprint)
            else "device program cold")
    # per-tenant fair share: under device contention from OTHER tenants,
    # a host-eligible plan overflows to the host tier even when history
    # would have preferred the device — bounded at 4x the host row gate
    # so a genuinely scan-heavy plan still waits for the device rather
    # than grinding the host interpreter
    if fair_share is not None and tenant is not None and \
            fair_share.contended_by_others(tenant):
        rows = plan_scan_rows(planner, root)
        limit = int(properties.get("router_host_max_rows", 200_000))
        if rows <= limit * 4:
            return RouteDecision(
                "host", "fair-share overflow: device contended by "
                        f"other tenants, ~{rows:,.0f} scanned rows "
                        "host-eligible", rows)
    # per-fingerprint history baseline: observed latency beats estimates
    if history is not None and fingerprint:
        try:
            base = history.baseline(fingerprint, "elapsed_s")
        except Exception:           # noqa: BLE001 — history is advisory
            base = None
        if base is not None:
            med_ms = base[0] * 1000.0
            gate = float(properties.get("router_host_latency_ms", 30.0))
            if med_ms <= gate:
                return RouteDecision(
                    "host", f"history median {med_ms:.1f}ms <= "
                            f"{gate:g}ms over {base[2]} runs")
            return RouteDecision(
                "device", f"history median {med_ms:.1f}ms > {gate:g}ms")
    rows = plan_scan_rows(planner, root)
    limit = int(properties.get("router_host_max_rows", 200_000))
    if rows <= limit:
        return RouteDecision(
            "host", f"~{rows:,.0f} scanned rows <= {limit:,}", rows)
    return RouteDecision(
        "device", f"~{rows:,.0f} scanned rows > {limit:,}", rows)


# --------------------------------------------------------------------------
# host numpy interpreter
# --------------------------------------------------------------------------

# numpy int64 overflow warnings: the device path wraps silently (XLA
# semantics); the host mirror must not spam stderr while matching it
_NP_ERR = {"over": "ignore"}


class _HostRows:
    """Compacted host relation: columns as (data, valid) numpy pairs,
    no dead rows (the Batch live-mask discipline collapses to slicing)."""

    __slots__ = ("arrays", "valids", "n")

    def __init__(self, arrays: List[np.ndarray],
                 valids: List[np.ndarray], n: int):
        self.arrays = arrays
        self.valids = valids
        self.n = n

    def take(self, mask: np.ndarray) -> "_HostRows":
        return _HostRows([a[mask] for a in self.arrays],
                         [v[mask] for v in self.valids],
                         int(mask.sum()) if mask.dtype == np.bool_
                         else len(mask))


# --------------------------------------------------------------------------
# numpy copies of the reference's helpers as its host path calls them
# (trino_tpu/ops/project.py rescale, _decimal_compare, _apply_cmp,
# _to_comparable and ops/aggregate.py avg_decimal_finalize, _identity,
# each with xp=np)
# --------------------------------------------------------------------------

_FLIPPED_CMP = {'<': '>', '<=': '>=', '>': '<', '>=': '<=',
                '=': '=', '<>': '<>'}


def _np_rescale(data, from_scale: int, to_scale: int):
    """Trino HALF_UP decimal rescale (round half away from zero)."""
    if to_scale == from_scale:
        return data
    if to_scale > from_scale:
        return data * (10 ** (to_scale - from_scale))
    d = 10 ** (from_scale - to_scale)
    half = d // 2
    pos = (data + half) // d
    neg = -((-data + half) // d)
    return np.where(data >= 0, pos, neg)


def _np_apply_cmp(op: str, l, r):
    if op == '=':
        return l == r
    if op == '<>':
        return l != r
    if op == '<':
        return l < r
    if op == '<=':
        return l <= r
    if op == '>':
        return l > r
    return l >= r


def _np_decimal_compare(a, sa: int, b, sb: int, op: str):
    """Exact comparison of scaled-int64 decimals at different scales,
    without multiplying either side (overflow-free)."""
    if sa == sb:
        return _np_apply_cmp(op, a, b)
    if sa > sb:
        return _np_decimal_compare(b, sb, a, sa, _FLIPPED_CMP[op])
    d = 10 ** (sb - sa)
    hi = b // d                      # floor div: lo is always in [0, d)
    lo = b - hi * d
    eq0 = lo == 0
    if op == '=':
        return (a == hi) & eq0
    if op == '<>':
        return (a != hi) | ~eq0
    if op == '>':
        return a > hi
    if op == '>=':
        return (a > hi) | ((a == hi) & eq0)
    if op == '<':
        return (a < hi) | ((a == hi) & ~eq0)
    return a <= hi


def _np_to_comparable(expr: ir.Expr, data, target):
    """One comparison/arithmetic operand converted to the common type; a
    decimal becomes a double by a true division by 10^s."""
    t = expr.dtype
    # a DECIMAL target never reaches here: np_eval compares decimals
    # through _np_decimal_compare
    if target.kind is TypeKind.DOUBLE:
        if t.kind is TypeKind.DECIMAL:
            return data.astype(np.float64) / (10 ** t.scale)
        return data.astype(np.float64)
    if target.kind is TypeKind.TIMESTAMP and t.kind is TypeKind.DATE:
        return data.astype(np.int64) * 86_400_000_000
    return data


def _np_avg_decimal_finalize(sums, counts):
    """Exact decimal AVG: round half away from zero of sum/count."""
    counts = np.where(counts == 0, 1, counts)
    q = sums // counts
    rem = sums - q * counts
    neg = sums < 0
    q = np.where(neg & (rem != 0), q + 1, q)
    rem = np.where(neg, sums - q * counts, rem)
    up = (2 * np.abs(rem) >= counts).astype(np.int64)
    return np.where(neg, q - up, q + up)


def _np_identity(func: str, dtype) -> object:
    if func == "sum" or func.startswith("count"):
        return 0
    if np.issubdtype(dtype, np.floating):
        return np.inf if func == "min" else -np.inf
    info = np.iinfo(dtype)
    return info.max if func == "min" else info.min


def _np_literal(expr: ir.Literal, n: int):
    if expr.value is None:
        return (np.zeros(n, dtype=expr.dtype.np_dtype),
                np.zeros(n, dtype=np.bool_))
    if expr.dtype.kind is TypeKind.VARCHAR:
        return (np.zeros(n, dtype=np.int32), np.ones(n, dtype=np.bool_))
    return (np.full(n, expr.value, dtype=expr.dtype.np_dtype),
            np.ones(n, dtype=np.bool_))


def np_eval(expr: ir.Expr, rows: _HostRows):
    """(data, valid) numpy evaluation: the reference's host interpreter
    (three-valued logic, decimal scale rules, truncating integer
    division, NULL on division by zero)."""
    n = rows.n

    if isinstance(expr, ir.ColumnRef):
        return rows.arrays[expr.index], rows.valids[expr.index]

    if isinstance(expr, ir.Literal):
        return _np_literal(expr, n)

    if isinstance(expr, ir.Arith):
        ld, lv = np_eval(expr.left, rows)
        rd, rv = np_eval(expr.right, rows)
        valid = lv & rv
        out = expr.dtype
        lt, rt = expr.left.dtype, expr.right.dtype
        with np.errstate(**_NP_ERR):
            if out.kind is TypeKind.DECIMAL:
                if expr.op == '*':
                    res = ld.astype(np.int64) * rd.astype(np.int64)
                else:
                    l = _np_rescale(ld, lt.scale, out.scale) \
                        if lt.kind is TypeKind.DECIMAL \
                        else ld.astype(np.int64) * (10 ** out.scale)
                    r = _np_rescale(rd, rt.scale, out.scale) \
                        if rt.kind is TypeKind.DECIMAL \
                        else rd.astype(np.int64) * (10 ** out.scale)
                    res = l + r if expr.op == '+' else l - r
                return res, valid
            if out.kind is TypeKind.DOUBLE:
                l = _np_to_comparable(expr.left, ld, out)
                r = _np_to_comparable(expr.right, rd, out)
                if expr.op == '+':
                    res = l + r
                elif expr.op == '-':
                    res = l - r
                elif expr.op == '*':
                    res = l * r
                else:
                    res = l / np.where(r == 0, np.float64(1), r)
                    valid = valid & (r != 0)
                return res, valid
            l = ld.astype(out.np_dtype)
            r = rd.astype(out.np_dtype)
            if expr.op == '+':
                res = l + r
            elif expr.op == '-':
                res = l - r
            elif expr.op == '*':
                res = l * r
            else:
                safe_r = np.where(r == 0, np.ones_like(r), r)
                q = l // safe_r
                rem = l - q * safe_r
                q = q + np.where((rem != 0) & ((l < 0) != (r < 0)), 1,
                                 0).astype(q.dtype)
                res = q
                valid = valid & (r != 0)
        return res, valid

    if isinstance(expr, ir.Negate):
        d, v = np_eval(expr.arg, rows)
        return -d, v

    if isinstance(expr, ir.Compare):
        target = ir.comparable(expr.left, expr.right)
        ld, lv = np_eval(expr.left, rows)
        rd, rv = np_eval(expr.right, rows)
        if target.kind is TypeKind.DECIMAL:
            sa = expr.left.dtype.scale \
                if expr.left.dtype.kind is TypeKind.DECIMAL else 0
            sb = expr.right.dtype.scale \
                if expr.right.dtype.kind is TypeKind.DECIMAL else 0
            res = _np_decimal_compare(ld.astype(np.int64), sa,
                                      rd.astype(np.int64), sb, expr.op)
            return res, lv & rv
        l = _np_to_comparable(expr.left, ld, target)
        r = _np_to_comparable(expr.right, rd, target)
        return _np_apply_cmp(expr.op, l, r), lv & rv

    if isinstance(expr, ir.Logical):
        parts = [np_eval(a, rows) for a in expr.args]
        d, v = parts[0]
        for (d2, v2) in parts[1:]:
            if expr.op == 'and':
                out_v = (v & v2) | (v & ~d) | (v2 & ~d2)
                d = d & d2
            else:
                out_v = (v & v2) | (v & d) | (v2 & d2)
                d = d | d2
            v = out_v
        return d, v

    if isinstance(expr, ir.Not):
        d, v = np_eval(expr.arg, rows)
        return ~d, v

    if isinstance(expr, ir.IsNull):
        d, v = np_eval(expr.arg, rows)
        res = v if expr.negated else ~v
        return res, np.ones_like(v)

    if isinstance(expr, ir.InList):
        d, v = np_eval(expr.arg, rows)
        res = np.zeros(n, dtype=np.bool_)
        for lit in expr.values:
            res = res | (d == np.asarray(lit.value, dtype=d.dtype))
        return res, v

    if isinstance(expr, ir.Between):
        lowered = ir.Logical('and', (
            ir.Compare('>=', expr.arg, expr.low),
            ir.Compare('<=', expr.arg, expr.high)))
        return np_eval(lowered, rows)

    if isinstance(expr, ir.Case):
        if expr.default is not None:
            acc_d, acc_v = np_eval(expr.default, rows)
            acc_d = acc_d.astype(expr.dtype.np_dtype)
        else:
            acc_d = np.zeros(n, dtype=expr.dtype.np_dtype)
            acc_v = np.zeros(n, dtype=np.bool_)
        for cond, val in reversed(expr.whens):
            cd, cv = np_eval(cond, rows)
            vd, vv = np_eval(val, rows)
            take = cd & cv
            acc_d = np.where(take, vd.astype(expr.dtype.np_dtype), acc_d)
            acc_v = np.where(take, vv, acc_v)
        return acc_d, acc_v

    if isinstance(expr, ir.Cast):
        d, v = np_eval(expr.arg, rows)
        src, dst = expr.arg.dtype, expr.dtype
        if src == dst:
            return d, v
        with np.errstate(**_NP_ERR):
            if dst.kind is TypeKind.DECIMAL:
                if src.kind is TypeKind.DECIMAL:
                    return _np_rescale(d, src.scale, dst.scale), v
                if src.kind is TypeKind.DOUBLE:
                    xs = d.astype(np.float64) * (10 ** dst.scale)
                    half_up = np.where(xs >= 0, np.floor(xs + 0.5),
                                       np.ceil(xs - 0.5))
                    return half_up.astype(np.int64), v
                return d.astype(np.int64) * (10 ** dst.scale), v
            if dst.kind is TypeKind.DOUBLE:
                if src.kind is TypeKind.DECIMAL:
                    return d.astype(np.float64) / (10 ** src.scale), v
                return d.astype(np.float64), v
            if dst.kind in (TypeKind.BIGINT, TypeKind.INTEGER):
                if src.kind is TypeKind.DECIMAL:
                    return _np_rescale(d, src.scale,
                                       0).astype(dst.np_dtype), v
                return d.astype(dst.np_dtype), v
            if dst.kind is TypeKind.DATE:
                if src.kind is TypeKind.TIMESTAMP:
                    return (d // 86_400_000_000).astype(np.int32), v
                return d.astype(np.int32), v
            if dst.kind is TypeKind.TIMESTAMP:
                if src.kind is TypeKind.DATE:
                    return d.astype(np.int64) * 86_400_000_000, v
                return d.astype(np.int64), v
        raise HostUnsupported(f"cast {src} -> {dst}")

    if isinstance(expr, ir.ArrayConst):
        return np.zeros(n, dtype=np.int32), np.ones(n, dtype=np.bool_)

    if isinstance(expr, ir.DictPredicate):
        d, v = np_eval(expr.arg, rows)
        if len(expr.lut) == 0:
            return np.zeros(n, dtype=np.bool_), v
        lut = np.asarray(expr.lut, dtype=np.bool_)
        codes = np.clip(d.astype(np.int32), 0, len(expr.lut) - 1)
        return lut[codes], v

    if isinstance(expr, ir.DictValueMap):
        d, v = np_eval(expr.arg, rows)
        vals = np.asarray(expr.values)
        codes = np.clip(d.astype(np.int32), 0, len(expr.values) - 1)
        return vals[codes].astype(expr.dtype.np_dtype), v

    if isinstance(expr, ir.DerivedDict):
        d, v = np_eval(expr.arg, rows)
        lut = np.asarray(expr.lut, dtype=np.int32)
        codes = np.clip(d.astype(np.int32), 0, len(expr.lut) - 1)
        out = lut[codes]
        if expr.null_code is not None:
            out = np.where(v, out, np.int32(expr.null_code))
            v = np.ones_like(v)
        return out, v

    if isinstance(expr, ir.DecimalAvg):
        sd, sv = np_eval(expr.sum, rows)
        cd, cv = np_eval(expr.count, rows)
        res = _np_avg_decimal_finalize(sd.astype(np.int64),
                                       cd.astype(np.int64))
        return res, sv & cv & (cd != 0)

    if isinstance(expr, ir.ScalarFunc):
        # two-limb decimal accumulation (SUM over DECIMAL — the mirror
        # of ops/project.py's $limb_* scalars; >> on int64 is arithmetic
        # in numpy, matching lax.shift_right_arithmetic)
        if expr.name == "$limb_hi":
            d, v = np_eval(expr.args[0], rows)
            return d.astype(np.int64) >> 32, v
        if expr.name == "$limb_lo":
            d, v = np_eval(expr.args[0], rows)
            return d.astype(np.int64) & np.int64(0xFFFFFFFF), v
        if expr.name == "$limb_combine":
            hd, hv = np_eval(expr.args[0], rows)
            ld, lv = np_eval(expr.args[1], rows)
            with np.errstate(**_NP_ERR):
                out = (hd.astype(np.int64) << 32) + ld.astype(np.int64)
            return out, hv & lv
        raise HostUnsupported(f"scalar function {expr.name}")

    raise HostUnsupported(type(expr).__name__)


def _np_global_aggregate(node: L.AggregateNode, rows: _HostRows
                         ) -> _HostRows:
    """Mirror of ops/aggregate.py global_aggregate: one always-live
    output row; sums accumulate int64 for integer inputs; empty/all-NULL
    inputs yield NULL (zero counts stay valid)."""
    arrays: List[np.ndarray] = []
    valids: List[np.ndarray] = []
    one = np.ones(1, dtype=np.bool_)
    for spec in node.aggs:
        if spec.func == "count_star":
            arrays.append(np.asarray([rows.n], dtype=np.int64))
            valids.append(one)
            continue
        idx = spec.arg.index
        data, valid = rows.arrays[idx], rows.valids[idx]
        cnt = int(valid.sum())
        if spec.func == "count":
            arrays.append(np.asarray([cnt], dtype=np.int64))
            valids.append(one)
            continue
        if spec.func == "sum":
            acc = np.int64 if np.issubdtype(data.dtype, np.integer) \
                else data.dtype
            with np.errstate(**_NP_ERR):
                s = np.where(valid, data.astype(acc), 0).sum()
            arrays.append(np.asarray([s], dtype=acc))
        else:                              # min / max
            ident = _np_identity(spec.func, data.dtype)
            red = np.min if spec.func == "min" else np.max
            masked = np.where(valid, data,
                              np.asarray(ident, dtype=data.dtype)) \
                if rows.n else np.asarray([ident], dtype=data.dtype)
            arrays.append(np.asarray([red(masked)], dtype=data.dtype))
        valids.append(np.asarray([cnt > 0]))
    return _HostRows(arrays, valids, 1)


def _np_sort(node: L.SortNode, rows: _HostRows) -> _HostRows:
    """Mirror of ops/sort.py sort_batch's key encoding (direction + null
    placement; NULL slots normalized so they compare equal), realized
    with a stable np.lexsort."""
    if rows.n == 0:
        return rows
    operands = []
    for spec in node.keys:
        data = rows.arrays[spec.index]
        valid = rows.valids[spec.index]
        null_rank = np.where(valid, 1, 0) if spec.nulls_first \
            else np.where(valid, 0, 1)
        d = np.where(valid, data, np.zeros((), data.dtype))
        if not spec.ascending:
            if d.dtype == np.bool_:
                d = ~d
            elif np.issubdtype(d.dtype, np.floating):
                d = -d
            else:
                d = np.invert(d)
        operands.append(null_rank.astype(np.int8))
        operands.append(d)
    # np.lexsort: LAST key is primary -> reverse the operand order
    perm = np.lexsort(tuple(reversed(operands)))
    out = _HostRows([a[perm] for a in rows.arrays],
                    [v[perm] for v in rows.valids], rows.n)
    if node.limit is not None:
        k = int(node.limit)
        out = _HostRows([a[:k] for a in out.arrays],
                        [v[:k] for v in out.valids], min(rows.n, k))
    return out


class HostRunner:
    """Executes a host-eligible plan on numpy — read-only over connector
    TableData, thread-safe, lock-free. `query_max_memory_mb` governs
    host executions too: every operator output charges the query's
    budget (cumulative, so the bound is conservative) and exceeding it
    raises the same user-facing QUERY_EXCEEDED_MEMORY the device path
    surfaces — routing to the host must not be a way around the
    operator's memory governance."""

    def __init__(self, catalog, limit_bytes: Optional[int] = None):
        self.catalog = catalog
        self.limit_bytes = limit_bytes
        self._charged = 0

    def _charge(self, rows: _HostRows) -> _HostRows:
        if self.limit_bytes is not None:
            self._charged += sum(a.nbytes for a in rows.arrays) + \
                sum(v.nbytes for v in rows.valids)
            if self._charged > self.limit_bytes:
                from .memory import ExceededMemoryLimitError
                raise ExceededMemoryLimitError(
                    "host", self._charged, self.limit_bytes)
        return rows

    def run(self, node: L.PlanNode) -> _HostRows:
        return self._charge(self._run(node))

    def _run(self, node: L.PlanNode) -> _HostRows:
        if isinstance(node, L.OutputNode):
            return self.run(node.child)
        if isinstance(node, L.ScanNode):
            data = self.catalog.get_table(node.catalog, node.schema_name,
                                          node.table)
            arrays, valids = [], []
            for i in node.column_indices:
                a = np.asarray(data.columns[i])
                arrays.append(a)
                v = None if data.valids is None else data.valids[i]
                valids.append(np.ones(len(a), dtype=np.bool_)
                              if v is None else np.asarray(v))
            from ..metrics import OPERATOR_ROWS
            OPERATOR_ROWS.inc(data.num_rows, operator="scan")
            return _HostRows(arrays, valids, data.num_rows)
        if isinstance(node, L.ValuesNode):
            arrays = [np.asarray(a) for a in node.arrays]
            valids = [np.ones(node.num_rows, dtype=np.bool_)
                      if v is None else np.asarray(v)
                      for v in node.valids]
            return _HostRows(arrays, valids, node.num_rows)
        if isinstance(node, L.FilterNode):
            child = self.run(node.child)
            d, v = np_eval(node.predicate, child)
            return child.take(np.asarray(d & v, dtype=np.bool_))
        if isinstance(node, L.ProjectNode):
            child = self.run(node.child)
            arrays, valids = [], []
            for e in node.exprs:
                d, v = np_eval(e, child)
                arrays.append(np.asarray(d))
                valids.append(np.asarray(v, dtype=np.bool_))
            return _HostRows(arrays, valids, child.n)
        if isinstance(node, L.AggregateNode):
            return _np_global_aggregate(node, self.run(node.child))
        if isinstance(node, L.SortNode):
            return _np_sort(node, self.run(node.child))
        if isinstance(node, L.LimitNode):
            child = self.run(node.child)
            k = int(node.count)
            return _HostRows([a[:k] for a in child.arrays],
                             [v[:k] for v in child.valids],
                             min(child.n, k))
        raise HostUnsupported(type(node).__name__)


def run_host(session, rel, root: L.OutputNode, t0: float):
    """Execute a pre-planned host-eligible query on numpy and decode it
    with the SAME scope/dictionary machinery as the device path — rows
    are produced by session.decode_rows either way, so formatting cannot
    diverge between routes."""
    import time
    limit = session.properties.get("query_max_memory_mb")
    runner = HostRunner(session.catalog,
                        limit_bytes=(int(limit) << 20)
                        if limit else None)
    out = runner.run(root)
    names = list(root.names)
    rows = session.decode_rows(rel, out.arrays, out.valids)
    from .session import QueryResult
    return QueryResult(names, rows, time.monotonic() - t0)
