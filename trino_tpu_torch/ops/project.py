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

import ctypes
import ctypes.util
import dataclasses
import functools
import math

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
        c = _double_literal(expr)
        if c is not None:
            return torch.full_like(data, c, dtype=torch.float64)
        if t.kind is TypeKind.DECIMAL:
            # mirrors XLA's rewrite of a division by a constant (reference)
            return data.to(torch.float64) * (1.0 / (10 ** t.scale))
        return data.to(torch.float64)
    if target.kind is TypeKind.TIMESTAMP and t.kind is TypeKind.DATE:
        return data.to(torch.int64) * 86_400_000_000
    return data


# --------------------------------------------------------------------------
# DOUBLE chains of products and quotients by literals, folded as XLA's
# algebraic simplifier folds them in the reference's compiled projection
# --------------------------------------------------------------------------
#
# The reference evaluates a projection inside one jit, and XLA rewrites
# every division by a constant into a multiplication by its reciprocal and
# folds chained constant factors into one; the port computes the same
# folded factor on the host and multiplies once. The order of the folds
# decides the factor's last bit, so `_fold_factor` replays the simplifier
# on the chain's HLO (read from the reference's pass dumps and its
# `algebraic_simplifier` log, and checked against the compiled reference
# over random chains of up to six factors):
#
# - a sweep visits every instruction once, operands first; what a rewrite
#   makes is visited in the next sweep. Sweeps repeat until nothing
#   changes, then constant folding runs, and the pair repeats until the
#   module is stable;
# - `A / broadcast(c)` becomes `A * broadcast(1/c)` (a new constant);
#   `(A / B) / C` becomes `A / (B * C)`; `A * 1` and `A / 1` become `A`;
# - `(A * c1) * c2` becomes `A * (c1 * c2)`, on vectors and on scalars,
#   where c1 and c2 are constants; the product is an expression, not a
#   constant, until the next constant folding;
# - `(A * c) * broadcast(s)`, s a scalar expression, becomes
#   `A * broadcast(s * c)`;
# - an elementwise op whose operands are all broadcasts is sunk below one
#   broadcast;
# - a SQL division's divisor is `where(r == 0, 1, r)`: the select sinks
#   below its broadcast in one sweep, its scalar operands lose their
#   broadcasts in the next and it becomes the constant in the third, so a
#   divide by it folds two sweeps after a divide by a plain constant (a
#   decimal scale, `round`'s factor).
#
# A literal operand itself is folded before XLA sees it: a decimal
# literal's double is its value divided by 10^s, correctly rounded.

# ops of a chain, innermost first: (kind, constant, level); kind "mul" or
# "div", level 0 for a plain constant, 1 for a SQL divisor (the select)


def _double_literal(expr: ir.Expr):
    """The double a literal operand (or a cast of one) becomes, or None."""
    if isinstance(expr, ir.Cast) and expr.dtype.kind is TypeKind.DOUBLE:
        expr = expr.arg
    if not isinstance(expr, ir.Literal) or expr.value is None or \
            isinstance(expr.value, bool):
        return None
    t = expr.dtype
    if t.kind is TypeKind.DECIMAL:
        return float(expr.value) / float(10 ** t.scale)
    if t.kind in (TypeKind.DOUBLE, TypeKind.BIGINT, TypeKind.INTEGER):
        return float(expr.value)
    return None


def _round_of_double(e: ir.Expr):
    """`round(x, d)` of a non-decimal x (the double rounding), or None."""
    if isinstance(e, ir.ScalarFunc) and e.name == "round" and \
            e.args[0].dtype.kind is not TypeKind.DECIMAL and \
            e.dtype.kind is TypeKind.DOUBLE:
        return e
    return None


def _double_chain(expr: ir.Expr):
    """`expr` as (base, ops): a non-literal term and the products and
    quotients by literals applied to it, innermost first. A decimal base
    (a CAST to double, or a decimal operand of a double operation) starts
    with its scale's quotient; a `round` of a double ends its own chain
    with the quotient by its factor."""
    ops = []
    e = expr
    while isinstance(e, ir.Arith) and e.dtype.kind is TypeKind.DOUBLE and \
            e.op in ('*', '/'):
        rc = _double_literal(e.right)
        if rc is not None and (e.op == '*' or rc != 0):
            ops.append(("mul", rc, 0) if e.op == '*' else ("div", rc, 1))
            e = e.left
        elif e.op == '*' and _double_literal(e.left) is not None:
            ops.append(("mul", _double_literal(e.left), 0))
            e = e.right
        else:
            break
    if isinstance(e, ir.Cast) and e.dtype.kind is TypeKind.DOUBLE and \
            e.arg.dtype.kind is TypeKind.DECIMAL:
        e = e.arg
    if e.dtype.kind is TypeKind.DECIMAL:
        ops.append(("div", float(10 ** e.dtype.scale), 0))
    elif _round_of_double(e) is not None:
        ops.append(("div", _round_factor(e), 0))
    return e, ops[::-1]


def _round_factor(e: ir.ScalarFunc) -> float:
    return 10.0 ** (e.params[0] if e.params else 0)


def _is_const(n) -> bool:
    """A broadcast of a scalar constant (`m::Broadcast(m::ConstantScalar)`)
    or, on scalars, the constant itself."""
    return n[0] == "c" or (n[0] == "bc" and n[1][0] == "c")


def _sweep(n, changed):
    """One visit of the simplifier over the HLO node `n`, operands first;
    sets changed[0] when a rewrite fires. Nodes: ("x",) the base; ("bc",
    s) a broadcast of scalar s; ("mul", a, b) and ("div", a, b) on
    vectors; ("c", v) a scalar constant; ("smul", a, b) a scalar product;
    ("vsel", v) and ("ssel", v, t) the SQL divisor's select before and
    after it sinks below its broadcast."""
    kind = n[0]
    if kind in ("x", "c"):
        return n
    if kind == "vsel":
        changed[0] = True
        return ("bc", ("ssel", n[1], 0))
    if kind == "ssel":
        changed[0] = True
        return ("c", n[1]) if n[2] >= 1 else ("ssel", n[1], n[2] + 1)
    if kind == "bc":
        return ("bc", _sweep(n[1], changed))
    a, b = _sweep(n[1], changed), _sweep(n[2], changed)
    if kind == "smul":
        for inner, c2 in ((a, b), (b, a)):
            if inner[0] != "smul" or c2[0] != "c":
                continue
            for base, c1 in ((inner[1], inner[2]), (inner[2], inner[1])):
                if base[0] != "c" and c1[0] == "c":
                    changed[0] = True
                    return ("smul", base, ("smul", c1, c2))
        return ("smul", a, b)
    out = _rewrite(kind, a, b)
    if out is None:
        return (kind, a, b)
    changed[0] = True
    return out


def _rewrite(kind: str, a, b):
    """The rewrite the simplifier makes of the vector `a * b` or `a / b`
    whose operands were already visited, or None."""
    if kind == "mul":
        for one, other in ((a, b), (b, a)):
            if _is_const(one) and one[1][1] == 1.0:
                return other
    elif _is_const(b) and b[1][1] == 1.0:
        return a
    if a[0] == "bc" and b[0] == "bc":           # sink the broadcasts
        return ("bc", ("smul", a[1], b[1]))
    if kind == "div":
        if a[0] == "div":
            return ("div", a[1], ("mul", a[2], b))
        if _is_const(b):
            return ("mul", a, ("bc", ("c", 1.0 / b[1][1])))
        return None
    for inner, other in ((a, b), (b, a)):
        if inner[0] != "mul" or other[0] != "bc":
            continue
        for base, c in ((inner[1], inner[2]), (inner[2], inner[1])):
            if _is_const(base) or not _is_const(c):
                continue
            if _is_const(other):
                return ("mul", base, ("bc", ("smul", c[1], other[1])))
            return ("mul", base, ("bc", ("smul", other[1], c[1])))
    return None


def _constant_fold(n):
    """XLA's constant folding: scalar products of constants, and a
    sunk select, become constants."""
    kind = n[0]
    if kind == "ssel":
        return ("c", n[1])
    if kind == "smul":
        a, b = _constant_fold(n[1]), _constant_fold(n[2])
        if a[0] == "c" and b[0] == "c":
            return ("c", a[1] * b[1])
        return ("smul", a, b)
    if kind == "bc":
        return ("bc", _constant_fold(n[1]))
    if kind in ("mul", "div"):
        return (kind, _constant_fold(n[1]), _constant_fold(n[2]))
    return n


def _fold_factor(ops):
    """The one factor XLA leaves of `ops` (see above), or None when the
    chain does not end as a single product of the base."""
    node = ("x",)
    for kind, k, level in ops:
        if kind == "mul":
            node = ("mul", node, ("bc", ("c", k)))
        else:
            node = ("div", node, ("vsel", k) if level else ("bc", ("c", k)))
    for _ in range(64):                      # the simplification pipeline
        before = node
        for _ in range(64):                  # algsimp: sweeps to a fixpoint
            changed = [False]
            node = _sweep(node, changed)
            if not changed[0]:
                break
        node = _constant_fold(node)
        if node == before:
            break
    if node == ("x",):
        return 1.0
    if node[0] == "mul":
        for base, c in ((node[1], node[2]), (node[2], node[1])):
            if base == ("x",) and _is_const(c):
                return c[1][1]
    return None


def _chain_factor(expr: ir.Expr, batch: Batch, extra=()):
    """`expr` followed by the products and quotients `extra` as (base, k,
    valid): the float64 base and the one factor XLA leaves; None where the
    chain does not fold to one product."""
    base, ops = _double_chain(expr)
    ops = ops + list(extra)
    if not ops or isinstance(base, ir.Literal):
        return None
    k = _fold_factor(ops)
    if k is None:
        return None
    rnd = _round_of_double(base)
    if rnd is not None:
        d, v = _eval_round_half_up(rnd, batch)
    else:
        d, v = eval_expr(base, batch)
    return d.to(torch.float64), k, v


def _eval_chain(expr: ir.Expr, batch: Batch, extra=()):
    """`expr` followed by the products and quotients `extra`, as a float64
    tensor folded as the reference's compiled code computes it; None
    where the chain does not fold to one product."""
    folded = _chain_factor(expr, batch, extra)
    if folded is None:
        return None
    d, k, v = folded
    return (d if k == 1.0 else d * k), v


def _children(e: ir.Expr):
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, ir.Expr):
            yield v
        elif isinstance(v, tuple):
            yield from (x for x in v if isinstance(x, ir.Expr))


def _load_order(e: ir.Expr, order: dict) -> dict:
    """Column loads numbered in the order the compiled loop first reads
    them: operands left to right, depth first."""
    if isinstance(e, ir.ColumnRef):
        order.setdefault(e.index, len(order) + 1)
    for c in _children(e):
        _load_order(c, order)
    return order


def _ir_rank(e: ir.Expr, order: dict) -> int:
    """LLVM Reassociate's rank of `e`'s value in the compiled loop: a load
    ranks by its order, an instruction one above its highest operand, a
    constant (and a subtree of constants, which XLA folds) 0."""
    if isinstance(e, ir.ColumnRef):
        return order[e.index]
    r = max((_ir_rank(c, order) for c in _children(e)), default=0)
    return r + 1 if r else 0


def _product_rank(side: ir.Expr, order: dict):
    """The rank of `side` when the compiled code can fuse it into an add
    as a product: a chain folded to one factor, or a product of two
    DOUBLE terms; None otherwise. Constant subtrees are folded by XLA,
    never fused."""
    if side.dtype.kind not in (TypeKind.DOUBLE, TypeKind.DECIMAL) or \
            _ir_rank(side, order) == 0:
        return None
    base, ops = _double_chain(side)
    if ops and not isinstance(base, ir.Literal):
        k = _fold_factor(ops)
        if k is not None and k != 1.0:
            return _ir_rank(base, order) + \
                (base.dtype.kind is not TypeKind.DOUBLE) + 1
        return None
    if isinstance(side, ir.Arith) and side.op == '*' and \
            side.dtype.kind is TypeKind.DOUBLE:
        return 1 + max(_ir_rank(t, order) +
                       (t.dtype.kind is not TypeKind.DOUBLE)
                       for t in (side.left, side.right))
    return None


def _product_terms(side: ir.Expr, batch: Batch):
    """(x, k, valid) of a side `_product_rank` accepted: x * k is its
    value before rounding."""
    folded = _chain_factor(side, batch)
    if folded is not None:
        return folded
    (ad, av), (bd, bv) = (eval_expr(side.left, batch),
                          eval_expr(side.right, batch))
    return (_to_comparable(side.left, ad, side.dtype),
            _to_comparable(side.right, bd, side.dtype), av & bv)


def _eval_contracted(expr: ir.Arith, batch: Batch):
    """A DOUBLE `L + R` or `L - R` with a product operand (a chain folded
    to one factor: a decimal operand's scale, products and quotients by
    literals; or a product of two DOUBLE terms), as one fused
    multiply-add: the reference's compiled code contracts it so. LLVM's
    combine fuses the first operand's product when it can; Reassociate
    first puts the lower-ranked operand of an add first, while a subtract
    keeps its order (`R - x*k` becomes `fma(-x, k, R)`). None when neither
    operand is a product."""
    order = _load_order(expr, {})
    left = _product_rank(expr.left, order)
    right = _product_rank(expr.right, order) \
        if left is None or expr.op == '+' else None
    if left is None and right is None:
        return None
    use_left = right is None or (left is not None and left <= right)
    side, other = (expr.left, expr.right) if use_left \
        else (expr.right, expr.left)
    x, k, xv = _product_terms(side, batch)
    od, ov = eval_expr(other, batch)
    z = _to_comparable(other, od, expr.dtype)
    if use_left:
        z = z if expr.op == '+' else -z
    elif expr.op == '-':
        x = -x
    return fma_like_reference(x, k, z), xv & ov


def _eval_round_half_up(expr: ir.ScalarFunc, batch: Batch):
    """`round(x, d)` of a double before its quotient by 10^d: x's chain
    with the product by 10^d folded in, rounded half away from zero."""
    factor = _round_factor(expr)
    arg = expr.args[0]
    folded = _eval_chain(arg, batch, [("mul", factor, 0)])
    if folded is not None:
        xs, v = folded
    else:
        d, v = eval_expr(arg, batch)
        xs = d.to(torch.float64) * factor
    half_up = torch.where(xs >= 0, torch.floor(xs + 0.5),
                          torch.ceil(xs - 0.5))
    return half_up, v


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
        if expr.dtype.kind is TypeKind.DOUBLE and expr.op in ('*', '/'):
            folded = _eval_chain(expr, batch)
            if folded is not None:
                return folded
        if expr.dtype.kind is TypeKind.DOUBLE and expr.op in ('+', '-'):
            fused = _eval_contracted(expr, batch)
            if fused is not None:
                return fused
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
                # HALF_UP (away from zero), matching rescale(); the
                # product by 10^s folds into the argument's chain
                folded = _eval_chain(expr.arg, batch,
                                     [("mul", float(10 ** dst.scale), 0)])
                xs = folded[0] if folded is not None else \
                    d.to(torch.float64) * (10 ** dst.scale)
                half_up = torch.where(xs >= 0, torch.floor(xs + 0.5),
                                      torch.ceil(xs - 0.5))
                return half_up.to(torch.int64), v
            return d.to(torch.int64) * (10 ** dst.scale), v
        if dst.kind is TypeKind.DOUBLE:
            c = _double_literal(expr)
            if c is not None:
                return torch.full_like(d, c, dtype=torch.float64), v
            if src.kind is TypeKind.DECIMAL:
                # mirrors XLA's rewrite of a division by a constant
                return d.to(torch.float64) * (1.0 / (10 ** src.scale)), v
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


# --------------------------------------------------------------------------
# sqrt, exp, ln and power as the reference's compiled CPU code rounds them
# --------------------------------------------------------------------------
#
# XLA's CPU backend lowers sqrt to the correctly rounded instruction, ln and
# power to glibc's `log` and `pow`, and exp to its own `xla.exp.f64`: a clamp,
# a rounded exponent, a Padé form of exp on the reduced argument and a
# two-step scale by 2^n. LLVM then contracts every add or subtract whose
# operand is a product used once into a fused multiply-add, and the compiled
# code runs with subnormals flushed to zero, on input and on output. The
# port rounds as it does: sqrt through numpy's correctly rounded sqrt on the
# CPU (CUDA's double sqrt is IEEE already), ln and power through glibc on the
# CPU, and exp by replaying `xla.exp.f64` op by op, its contractions through
# `fma_like_reference`, on every device. On a CUDA tensor ln and power are
# the card's own `log` and `pow`, which need not round as glibc does.

_MIN_NORMAL = 2.2250738585072014e-308


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """A subnormal becomes a zero of its sign, as under FTZ and DAZ."""
    return torch.where(x.abs() < _MIN_NORMAL, x * 0.0, x)


def _split(a: torch.Tensor):
    t = a * 134217729.0                       # 2^27 + 1: Veltkamp's split
    hi = t - (t - a)
    return hi, a - hi


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fma_like_reference(a, b, c) -> torch.Tensor:
    """a * b + c rounded once, as the fused multiply-add rounds it, from
    float64 operations that each round on their own (Boldo and Melquiond's
    emulation: an exact product, an exact sum, a sum rounded to odd, a last
    sum rounded to nearest). Exact when no step overflows or underflows."""
    a, b, c = torch.broadcast_tensors(*(torch.as_tensor(
        v, dtype=torch.float64,
        device=next(t.device for t in (a, b, c) if torch.is_tensor(t)))
        for v in (a, b, c)))
    uh = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    ul = ((ah * bh - uh) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, uh)
    v, err = _two_sum(tl, ul)
    odd = (v.view(torch.int64) & 1) == 1
    toward = torch.where(err > 0, math.inf, -math.inf).to(v.dtype)
    v = torch.where((err != 0) & ~odd, torch.nextafter(v, toward), v)
    out = th + v
    plain = uh + c
    return torch.where(torch.isfinite(out), out, plain)


_EXP_LO = float.fromhex("-0x1.6232bdd7abcd2p+9")      # below: 0
_EXP_HI = float.fromhex("0x1.62e42fefa39efp+9")       # above: inf
_EXP_LOG2E = float.fromhex("0x1.71547652b82fep+0")
_EXP_LN2_HI = float.fromhex("0x1.62e4000000000p-1")
_EXP_LN2_LO = float.fromhex("0x1.7f7d1cf79abcap-20")
_EXP_P = (float.fromhex("0x1.089cdd5e44be8p-13"),
          float.fromhex("0x1.f06d10cca2c7ep-6"))
_EXP_Q = (float.fromhex("0x1.92eb6bc365fa0p-19"),
          float.fromhex("0x1.4ae39b508b6c0p-9"),
          float.fromhex("0x1.d17099887e074p-3"))
_EXP_N_MAX = 2099
_ONE_BITS = 0x3FF0000000000000


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2^k as a double built from its exponent bits (k an int64 tensor)."""
    return (k * (1 << 52) + _ONE_BITS).view(torch.float64)


def exp_like_reference(x: torch.Tensor) -> torch.Tensor:
    """XLA's `xla.exp.f64` as compiled for the CPU."""
    x = flush_subnormal(x)
    fma = fma_like_reference
    c = torch.maximum(torch.minimum(x, torch.full_like(x, _EXP_HI)),
                      torch.full_like(x, _EXP_LO))
    n = torch.floor(fma(c, _EXP_LOG2E, 0.5))
    g = fma(-n, _EXP_LN2_LO, fma(-n, _EXP_LN2_HI, c))
    g2 = g * g
    p = fma(fma(g2, _EXP_P[0], _EXP_P[1]), g2, 1.0) * g
    q = fma(fma(fma(g2, _EXP_Q[0], _EXP_Q[1]), g2, _EXP_Q[2]), g2, 2.0)
    e = (p / (q - p)) * 2.0 + 1.0
    ni = torch.nan_to_num(n, nan=0.0).to(torch.int64) \
        .clamp(-_EXP_N_MAX, _EXP_N_MAX)
    b = ni >> 2
    f1 = _pow2(b)
    out = flush_subnormal(((e * f1) * f1) * f1 * _pow2(ni - 3 * b))
    out = torch.where(x < _EXP_LO, torch.zeros_like(out), out)
    return torch.where(x > _EXP_HI, torch.full_like(out, math.inf), out)


@functools.lru_cache(maxsize=None)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for fn, nargs in (("log", 1), ("pow", 2)):
        f = getattr(lib, fn)
        f.restype = ctypes.c_double
        f.argtypes = [ctypes.c_double] * nargs
    return lib


def _glibc(fn: str, *xs: torch.Tensor) -> torch.Tensor:
    """glibc's `fn` element by element over CPU float64 tensors."""
    arrays = torch.broadcast_tensors(*xs)
    f = np.frompyfunc(getattr(_libm(), fn), len(arrays), 1)
    with np.errstate(all="ignore"):
        out = f(*(a.contiguous().numpy() for a in arrays))
    return torch.from_numpy(np.asarray(out, dtype=np.float64).copy()) \
        .reshape(arrays[0].shape)


def sqrt_like_reference(x: torch.Tensor) -> torch.Tensor:
    x = flush_subnormal(x)
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.contiguous().numpy()))
    return torch.sqrt(x)


def log_like_reference(x: torch.Tensor) -> torch.Tensor:
    x = flush_subnormal(x)
    return _glibc("log", x) if x.device.type == "cpu" else torch.log(x)


def pow_like_reference(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    # glibc settles a negative base (from the exponent's integrality) and
    # an exponent below 2^-65 (the answer is 1) from their bits before any
    # arithmetic; only past those does a subnormal base read as zero
    x = torch.where((x < 0) | (y.abs() < 2.0 ** -65), x, flush_subnormal(x))
    out = _glibc("pow", x, y) if x.device.type == "cpu" \
        else torch.pow(x, y)
    return flush_subnormal(out)


def _shr_logical(x: torch.Tensor, s: int) -> torch.Tensor:
    return (x >> s) & ((1 << (64 - s)) - 1)


def eval_scalar_func(expr: ir.ScalarFunc, batch: Batch):
    """Built-in scalar functions, branch-free with three-valued logic."""
    name = expr.name
    if _round_of_double(expr) is not None:
        return _eval_chain(expr, batch)
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
        return half_up * (1.0 / factor), v
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
        x = flush_subnormal(d.to(torch.float64))
        return sqrt_like_reference(torch.abs(x)), v & (x >= 0)
    if name == "power":
        (rd, rv) = parts[1]
        return pow_like_reference(d.to(torch.float64),
                                  rd.to(torch.float64)), v & rv
    if name == "exp":
        return exp_like_reference(d.to(torch.float64)), v
    if name == "ln":
        x = flush_subnormal(d.to(torch.float64))
        return log_like_reference(torch.where(x > 0, x, 1.0)), v & (x > 0)

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
