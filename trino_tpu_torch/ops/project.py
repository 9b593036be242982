"""Expression evaluation: IR -> torch ops (filter + project).

Counterpart of ``trino_tpu/ops/project.py`` (Trino's PageProcessor
codegen tier). Every expression evaluates to ``(data, valid)`` with SQL
three-valued logic:
- arithmetic/comparison: result valid = all inputs valid
- AND/OR: Kleene logic
- filters treat NULL as false (WHERE semantics)

int64 arithmetic wraps as two's complement, decimals are scaled int64 with
HALF_UP (away from zero) rescaling, exactly as the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import ir
from ..batch import Batch, Column, torch_dtype
from ..types import TypeKind

# --------------------------------------------------------------------------
# decimal rescaling (Trino HALF_UP semantics)
# --------------------------------------------------------------------------


def rescale(data, from_scale: int, to_scale: int, xp=torch):
    """`xp` is torch for tensors or numpy for host arrays."""
    if to_scale == from_scale:
        return data
    if to_scale > from_scale:
        return data * (10 ** (to_scale - from_scale))
    d = 10 ** (from_scale - to_scale)
    half = d // 2
    # round half away from zero, like Trino's HALF_UP
    pos = (data + half) // d
    neg = -((-data + half) // d)
    return xp.where(data >= 0, pos, neg)


_FLIPPED_CMP = {'<': '>', '<=': '>=', '>': '<', '>=': '<=',
                '=': '=', '<>': '<>'}


def _decimal_compare(a, sa: int, b, sb: int, op: str, xp=torch):
    """Exact comparison of scaled-int64 decimals at different scales,
    never multiplying either operand (overflow-free). Pure operators, so
    it serves tensors and numpy arrays alike."""
    if sa == sb:
        return _apply_cmp(op, a, b)
    if sa > sb:
        return _decimal_compare(b, sb, a, sa, _FLIPPED_CMP[op], xp)
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
    return a <= hi                   # '<='


def _apply_cmp(op: str, l, r):
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


def _to_comparable(expr: ir.Expr, data: torch.Tensor, target):
    """Rescale/convert one comparison operand to the common type."""
    t = expr.dtype
    if target.kind is TypeKind.DECIMAL:
        raise AssertionError("decimal comparisons use _decimal_compare")
    if target.kind is TypeKind.DOUBLE:
        if t.kind is TypeKind.DECIMAL:
            return data.to(torch.float64) / (10 ** t.scale)
        return data.to(torch.float64)
    if target.kind is TypeKind.TIMESTAMP and t.kind is TypeKind.DATE:
        return data.to(torch.int64) * 86_400_000_000
    return data


# --------------------------------------------------------------------------
# date decomposition (days since epoch -> civil), Hinnant's algorithm
# --------------------------------------------------------------------------


def days_from_civil(y, m, d):
    """Inverse of civil_from_days."""
    y = y - (m <= 2).to(y.dtype)
    era = y // 400
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def civil_from_days(days):
    z = days.to(torch.int64) + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    year = torch.where(m <= 2, y + 1, y)
    return year, m, d


# --------------------------------------------------------------------------
# evaluator
# --------------------------------------------------------------------------


def _tdt(dtype) -> torch.dtype:
    return torch_dtype(dtype.np_dtype)


def eval_expr(expr: ir.Expr, batch: Batch):
    """Evaluate an IR expression over a batch. Returns (data, valid)."""
    n = batch.capacity
    dev = batch.device

    def ones():
        return torch.ones(n, dtype=torch.bool, device=dev)

    if isinstance(expr, ir.ColumnRef):
        col = batch.columns[expr.index]
        return col.data, col.valid

    if isinstance(expr, ir.Literal):
        if expr.value is None:
            z = torch.zeros(n, dtype=_tdt(expr.dtype), device=dev)
            return z, torch.zeros(n, dtype=torch.bool, device=dev)
        if expr.dtype.kind is TypeKind.VARCHAR:
            # string literal: code 0 into its single-entry pool
            return torch.zeros(n, dtype=torch.int32, device=dev), ones()
        v = torch.full((n,), expr.value, dtype=_tdt(expr.dtype), device=dev)
        return v, ones()

    if isinstance(expr, ir.Arith):
        ld, lv = eval_expr(expr.left, batch)
        rd, rv = eval_expr(expr.right, batch)
        valid = lv & rv
        out = expr.dtype
        lt, rt = expr.left.dtype, expr.right.dtype
        if out.kind is TypeKind.DECIMAL:
            if expr.op == '*':
                res = ld.to(torch.int64) * rd.to(torch.int64)
            else:
                l = rescale(ld, lt.scale, out.scale) \
                    if lt.kind is TypeKind.DECIMAL \
                    else ld.to(torch.int64) * (10 ** out.scale)
                r = rescale(rd, rt.scale, out.scale) \
                    if rt.kind is TypeKind.DECIMAL \
                    else rd.to(torch.int64) * (10 ** out.scale)
                res = l + r if expr.op == '+' else l - r
            return res, valid
        if out.kind is TypeKind.DOUBLE:
            l = _to_comparable(expr.left, ld, out)
            r = _to_comparable(expr.right, rd, out)
            if expr.op == '+':
                res = l + r
            elif expr.op == '-':
                res = l - r
            elif expr.op == '*':
                res = l * r
            else:
                # division by zero yields NULL (the reference's deviation)
                res = l / torch.where(r == 0, 1.0, r)
                valid = valid & (r != 0)
            return res, valid
        # integer-like (BIGINT/INTEGER/DATE)
        l = ld.to(_tdt(out))
        r = rd.to(_tdt(out))
        if expr.op == '+':
            res = l + r
        elif expr.op == '-':
            res = l - r
        elif expr.op == '*':
            res = l * r
        else:
            # SQL integer division truncates toward zero; // floors
            safe_r = torch.where(r == 0, torch.ones_like(r), r)
            q = l // safe_r
            rem = l - q * safe_r
            q = q + ((rem != 0) & ((l < 0) != (r < 0))).to(q.dtype)
            res = q
            valid = valid & (r != 0)
        return res, valid

    if isinstance(expr, ir.Negate):
        d, v = eval_expr(expr.arg, batch)
        return -d, v

    if isinstance(expr, ir.Compare):
        target = ir.comparable(expr.left, expr.right)
        ld, lv = eval_expr(expr.left, batch)
        rd, rv = eval_expr(expr.right, batch)
        op = expr.op
        if target.kind is TypeKind.DECIMAL:
            sa = expr.left.dtype.scale \
                if expr.left.dtype.kind is TypeKind.DECIMAL else 0
            sb = expr.right.dtype.scale \
                if expr.right.dtype.kind is TypeKind.DECIMAL else 0
            res = _decimal_compare(ld.to(torch.int64), sa,
                                   rd.to(torch.int64), sb, op)
            return res, lv & rv
        l = _to_comparable(expr.left, ld, target)
        r = _to_comparable(expr.right, rd, target)
        return _apply_cmp(op, l, r), lv & rv

    if isinstance(expr, ir.Logical):
        parts = [eval_expr(a, batch) for a in expr.args]
        d, v = parts[0]
        for (d2, v2) in parts[1:]:
            if expr.op == 'and':
                # Kleene AND: false dominates null
                out_v = (v & v2) | (v & ~d) | (v2 & ~d2)
                d = d & d2
            else:
                out_v = (v & v2) | (v & d) | (v2 & d2)
                d = d | d2
            v = out_v
        return d, v

    if isinstance(expr, ir.Not):
        d, v = eval_expr(expr.arg, batch)
        return ~d, v

    if isinstance(expr, ir.IsNull):
        d, v = eval_expr(expr.arg, batch)
        res = v if expr.negated else ~v
        return res, torch.ones_like(v)

    if isinstance(expr, ir.InList):
        d, v = eval_expr(expr.arg, batch)
        res = torch.zeros_like(v)
        for lit in expr.values:
            res = res | (d == torch.tensor(lit.value, dtype=d.dtype,
                                           device=dev))
        return res, v

    if isinstance(expr, ir.Between):
        lowered = ir.Logical('and', (
            ir.Compare('>=', expr.arg, expr.low),
            ir.Compare('<=', expr.arg, expr.high),
        ))
        return eval_expr(lowered, batch)

    if isinstance(expr, ir.Case):
        tdt = _tdt(expr.dtype)
        default = expr.default
        if default is not None:
            acc_d, acc_v = eval_expr(default, batch)
            acc_d = acc_d.to(tdt)
        else:
            acc_d = torch.zeros(n, dtype=tdt, device=dev)
            acc_v = torch.zeros(n, dtype=torch.bool, device=dev)
        # reverse order: first matching WHEN wins
        for cond, val in reversed(expr.whens):
            cd, cv = eval_expr(cond, batch)
            vd, vv = eval_expr(val, batch)
            take = cd & cv
            acc_d = torch.where(take, vd.to(tdt), acc_d)
            acc_v = torch.where(take, vv, acc_v)
        return acc_d, acc_v

    if isinstance(expr, ir.Cast):
        d, v = eval_expr(expr.arg, batch)
        src, dst = expr.arg.dtype, expr.dtype
        if src == dst:
            return d, v
        if dst.kind is TypeKind.DECIMAL:
            if src.kind is TypeKind.DECIMAL:
                return rescale(d, src.scale, dst.scale), v
            if src.kind is TypeKind.DOUBLE:
                # HALF_UP (away from zero), matching rescale()
                xs = d.to(torch.float64) * (10 ** dst.scale)
                half_up = torch.where(xs >= 0, torch.floor(xs + 0.5),
                                      torch.ceil(xs - 0.5))
                return half_up.to(torch.int64), v
            return d.to(torch.int64) * (10 ** dst.scale), v
        if dst.kind is TypeKind.DOUBLE:
            if src.kind is TypeKind.DECIMAL:
                return d.to(torch.float64) / (10 ** src.scale), v
            return d.to(torch.float64), v
        if dst.kind in (TypeKind.BIGINT, TypeKind.INTEGER):
            if src.kind is TypeKind.DECIMAL:
                return rescale(d, src.scale, 0).to(_tdt(dst)), v
            return d.to(_tdt(dst)), v
        if dst.kind is TypeKind.DATE:
            if src.kind is TypeKind.TIMESTAMP:
                return (d // 86_400_000_000).to(torch.int32), v
            return d.to(torch.int32), v
        if dst.kind is TypeKind.TIMESTAMP:
            if src.kind is TypeKind.DATE:
                return d.to(torch.int64) * 86_400_000_000, v
            return d.to(torch.int64), v
        raise NotImplementedError(f"cast {src} -> {dst}")

    if isinstance(expr, ir.ArrayConst):
        return torch.zeros(n, dtype=torch.int32, device=dev), ones()

    if isinstance(expr, ir.DerivedDict):
        d, v = eval_expr(expr.arg, batch)
        lut = torch.tensor(np.asarray(expr.lut, dtype=np.int32), device=dev)
        codes = d.to(torch.int64).clamp(0, len(expr.lut) - 1)
        out = lut[codes]
        if expr.null_code is not None:    # varchar coalesce-to-literal
            out = torch.where(v, out, int(expr.null_code))
            v = torch.ones_like(v)
        return out, v

    if isinstance(expr, ir.DictPredicate):
        d, v = eval_expr(expr.arg, batch)
        if len(expr.lut) == 0:      # empty pool: no code can match
            return torch.zeros_like(d, dtype=torch.bool), v
        lut = torch.tensor(np.asarray(expr.lut, dtype=np.bool_), device=dev)
        codes = d.to(torch.int64).clamp(0, len(expr.lut) - 1)
        return lut[codes], v

    if isinstance(expr, ir.DecimalAvg):
        from .aggregate import avg_decimal_finalize
        sd, sv = eval_expr(expr.sum, batch)
        cd, cv = eval_expr(expr.count, batch)
        res = avg_decimal_finalize(sd, cd, xp=torch)
        return res, sv & cv & (cd != 0)

    if isinstance(expr, ir.ExtractField):
        d, v = eval_expr(expr.arg, batch)
        is_ts = expr.arg.dtype.kind is TypeKind.TIMESTAMP
        micros_in_day = 86_400_000_000
        if expr.part.startswith('trunc_'):
            unit = expr.part[len('trunc_'):]
            if unit in ('hour', 'minute', 'second'):   # timestamp only
                step = {'hour': 3_600_000_000, 'minute': 60_000_000,
                        'second': 1_000_000}[unit]
                return d - d % step, v
            days = d // micros_in_day if is_ts else d
            if unit == 'day':
                out = days
            elif unit == 'week':
                out = days - (days + 3) % 7
            else:
                year, month, _day = civil_from_days(days)
                if unit == 'month':
                    out = days_from_civil(year, month, 1)
                elif unit == 'quarter':
                    q_month = ((month - 1) // 3) * 3 + 1
                    out = days_from_civil(year, q_month, 1)
                else:                                  # year
                    out = days_from_civil(year, torch.ones_like(month), 1)
            out = out.to(d.dtype)
            return (out * micros_in_day if is_ts else out), v
        if is_ts:
            days = d // micros_in_day
            rem = d - days * micros_in_day
            if expr.part == 'hour':
                return rem // 3_600_000_000, v
            if expr.part == 'minute':
                return (rem // 60_000_000) % 60, v
            if expr.part == 'second':
                return (rem // 1_000_000) % 60, v
            d = days
        year, month, day = civil_from_days(d)
        res = {'year': year, 'month': month, 'day': day}[expr.part]
        return res.to(torch.int64), v

    if isinstance(expr, ir.DictValueMap):
        d, v = eval_expr(expr.arg, batch)
        lut = torch.tensor(np.asarray(expr.values,
                                      dtype=expr.dtype.np_dtype),
                           device=dev)
        codes = d.to(torch.int64).clamp(0, len(expr.values) - 1)
        return lut[codes], v

    if isinstance(expr, ir.ScalarFunc):
        return eval_scalar_func(expr, batch)

    raise NotImplementedError(f"eval of {type(expr).__name__}")


def _shr_logical(x: torch.Tensor, s: int) -> torch.Tensor:
    return (x >> s) & ((1 << (64 - s)) - 1)


def eval_scalar_func(expr: ir.ScalarFunc, batch: Batch):
    """Built-in scalar functions, branch-free with three-valued logic."""
    name = expr.name
    parts = [eval_expr(a, batch) for a in expr.args]
    tdt = _tdt(expr.dtype) if expr.dtype.kind is not TypeKind.ARRAY \
        else None

    if name == "coalesce":
        d, v = parts[-1]
        d = d.to(tdt)
        for pd, pv in reversed(parts[:-1]):
            d = torch.where(pv, pd.to(tdt), d)
            v = pv | v
        return d, v

    if name == "nullif":
        (ad, av), (bd, bv) = parts
        eq = av & bv & (ad == bd.to(ad.dtype))
        return ad, av & ~eq

    if name in ("greatest", "least"):
        op = torch.maximum if name == "greatest" else torch.minimum
        d, v = parts[0]
        d = d.to(tdt)
        for pd, pv in parts[1:]:
            d = op(d, pd.to(tdt))
            v = v & pv          # NULL if any argument is NULL (Trino)
        return d, v

    (d, v) = parts[0]
    t = expr.args[0].dtype
    if name == "abs":
        return torch.abs(d), v
    if name == "round":
        digits = expr.params[0] if expr.params else 0
        if t.kind is TypeKind.DECIMAL:
            if digits >= t.scale:
                return d, v
            return rescale(rescale(d, t.scale, digits), digits, t.scale), v
        factor = 10.0 ** digits
        xs = d.to(torch.float64) * factor
        half_up = torch.where(xs >= 0, torch.floor(xs + 0.5),
                              torch.ceil(xs - 0.5))
        return half_up / factor, v
    if name in ("floor", "ceil"):
        if t.kind is TypeKind.DECIMAL:
            s = 10 ** t.scale
            q = d // s if name == "floor" else -((-d) // s)
            return q, v
        if d.dtype.is_floating_point:
            op = torch.floor if name == "floor" else torch.ceil
            return op(d), v
        return d.to(torch.int64), v
    if name == "mod":
        (rd, rv) = parts[1]
        r = rd.to(d.dtype)
        safe = torch.where(r == 0, torch.ones_like(r), r)
        if d.dtype.is_floating_point:
            res = d - torch.trunc(d / safe) * safe
        else:
            q = d // safe
            rem = d - q * safe
            # SQL mod truncates toward zero: sign follows the dividend
            res = torch.where((rem != 0) & ((d < 0) != (r < 0)),
                              rem - safe, rem)
            res = torch.where(rem == 0, rem, res)
        return res, v & parts[1][1] & (rd != 0)
    if name == "sqrt":
        x = d.to(torch.float64)
        return torch.sqrt(torch.abs(x)), v & (x >= 0)
    if name == "power":
        (rd, rv) = parts[1]
        return torch.pow(d.to(torch.float64), rd.to(torch.float64)), v & rv
    if name == "exp":
        return torch.exp(d.to(torch.float64)), v
    if name == "ln":
        x = d.to(torch.float64)
        return torch.log(torch.where(x > 0, x, 1.0)), v & (x > 0)

    # ---- two-limb decimal accumulation (sum over DECIMAL) ------------
    if name == "$limb_hi":
        return d.to(torch.int64) >> 32, v
    if name == "$limb_lo":
        return d.to(torch.int64) & 0xFFFFFFFF, v
    if name == "$limb_combine":
        (lod, lov) = parts[1]
        hi = d.to(torch.int64)
        return (hi << 32) + lod.to(torch.int64), v & lov

    # ---- HyperLogLog building blocks (approx_distinct) ---------------
    if name in ("$hll_bucket", "$hll_rho"):
        p = expr.params[0]
        h = _hll_hash64(d)
        if name == "$hll_bucket":
            return _shr_logical(h, 64 - p), v
        w = h << p
        rho = torch.minimum(_clz64(w) + 1,
                            torch.tensor(64 - p + 1, device=w.device))
        return rho.to(torch.int64), v
    if name == "$hll_pow":
        return torch.exp2(-d.to(torch.float64)), v
    if name == "$hll_est":
        m = float(expr.params[0])
        (vd, vv) = parts[0]
        (sd, sv) = parts[1]
        V = torch.where(vv, vd, 0).to(torch.float64)
        S = torch.where(sv, sd, 0.0).to(torch.float64)
        alpha = 0.7213 / (1.0 + 1.079 / m)
        raw = alpha * m * m / (S + (m - V))
        zeros = m - V
        lin = m * torch.log(torch.where(
            zeros > 0, m / torch.clamp(zeros, min=0.5), 1.0))
        est = torch.where((raw <= 2.5 * m) & (zeros > 0), lin, raw)
        est = torch.where(V == 0, 0.0, est)
        return torch.round(est).to(torch.int64), torch.ones_like(vv)
    raise NotImplementedError(f"scalar function {name}")


def _clz64(x: torch.Tensor) -> torch.Tensor:
    """Leading-zero count of int64 bit patterns (64 for zero)."""
    n = torch.zeros_like(x)
    y = x
    for s in (32, 16, 8, 4, 2, 1):
        top = _shr_logical(y, 64 - s) == 0
        n = n + torch.where(top, s, 0)
        y = torch.where(top, y << s, y)
    return n + (y == 0).to(x.dtype)


def _hll_hash64(d: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer over the lane value (wrapping int64; logical
    shifts). Doubles hash their bit pattern."""
    if d.dtype.is_floating_point:
        x = d.to(torch.float64).view(torch.int64)
    else:
        x = d.to(torch.int64)
    x = x + (-7046029254386353131)          # 0x9E3779B97F4A7C15
    x = x ^ _shr_logical(x, 30)
    x = x * (-4658895280553007687)          # 0xBF58476D1CE4E5B9
    x = x ^ _shr_logical(x, 27)
    x = x * (-7723592293110705685)          # 0x94D049BB133111EB
    x = x ^ _shr_logical(x, 31)
    return x


def filter_mask(expr: ir.Expr, batch: Batch) -> torch.Tensor:
    """WHERE semantics: NULL -> excluded."""
    d, v = eval_expr(expr, batch)
    return d & v


def apply_filter(batch: Batch, expr: ir.Expr) -> Batch:
    """Filter = AND into the live mask; no data movement."""
    return batch.with_live(batch.live & filter_mask(expr, batch))


def project(batch: Batch, exprs) -> Batch:
    """Evaluate projection list into a new Batch (same capacity/live)."""
    cols = []
    for e in exprs:
        d, v = eval_expr(e, batch)
        cols.append(Column(data=d, valid=v))
    return Batch(columns=tuple(cols), live=batch.live)


def filter_project(batch: Batch, filter_expr, project_exprs) -> Batch:
    """Fused filter+project (the PageProcessor equivalent)."""
    b = apply_filter(batch, filter_expr) if filter_expr is not None \
        else batch
    return project(b, project_exprs)


def filter_project_fused(batch: Batch, exprs, predicate) -> Batch:
    """Project-then-filter (Filter over Project)."""
    return apply_filter(project(batch, exprs), predicate)
