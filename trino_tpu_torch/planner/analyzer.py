"""Port copy of ``trino_tpu/planner/analyzer.py`` (no edits beyond import
targets noted inline).

Analyzer: scopes, name resolution, and AST -> typed IR lowering.

Reference: Trino splits this across Analyzer/ExpressionAnalyzer
(sql/analyzer/Analyzer.java:47) producing an Analysis consumed by
LogicalPlanner. We fuse analysis into planning (planner.py) and keep here
the scope machinery and expression lowering, including the
dictionary-predicate lowering that replaces Trino's LikeMatcher and slice
comparisons for VARCHAR (strings never reach the device; SURVEY.md §7).
"""

from __future__ import annotations

import datetime
import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

from .. import ir
from ..batch import Field
from ..types import (BIGINT, BOOLEAN, DATE, DOUBLE, VARCHAR, DataType,
                     TypeKind, common_super_type, decimal)
from ..sql import ast_nodes as A

EPOCH = datetime.date(1970, 1, 1)


class AnalysisError(Exception):
    pass


@dataclass
class ScopeColumn:
    qualifier: Optional[str]      # table alias (lower-case)
    name: str                     # column name (lower-case)
    dtype: DataType
    index: int                    # position in the relation's output
    field: Optional[Field] = None  # carries dictionary for VARCHAR


class Scope:
    def __init__(self, columns: List[ScopeColumn]):
        self.columns = columns

    def resolve(self, parts: Tuple[str, ...]) -> ScopeColumn:
        parts = tuple(p.lower() for p in parts)
        if len(parts) == 1:
            matches = [c for c in self.columns if c.name == parts[0]]
        elif len(parts) == 2:
            matches = [c for c in self.columns
                       if c.qualifier == parts[0] and c.name == parts[1]]
        else:
            raise AnalysisError(f"unsupported name {'.'.join(parts)}")
        if not matches:
            raise AnalysisError(f"column '{'.'.join(parts)}' not found")
        if len(matches) > 1:
            raise AnalysisError(f"column '{'.'.join(parts)}' is ambiguous")
        return matches[0]

    def try_resolve(self, parts) -> Optional[ScopeColumn]:
        try:
            return self.resolve(parts)
        except AnalysisError:
            return None


AGG_NAMES = {"sum", "avg", "count", "min", "max",
             # variance family decomposes to sum/sum-of-squares/count with
             # a post-aggregation finalizer (AccumulatorCompiler's
             # VarianceState, operator/aggregation/VarianceAggregation)
             "stddev", "stddev_samp", "stddev_pop",
             "variance", "var_samp", "var_pop",
             # approx_distinct computes the EXACT distinct count through
             # the sort kernel's dedup — on TPU the sort network makes
             # exactness cheaper than per-group HLL register scatters,
             # and 0% error is within the reference's 2.3% contract
             # (ApproximateCountDistinctAggregation)
             "approx_distinct",
             "bool_and", "bool_or", "every"}

VARIANCE_AGGS = {"stddev", "stddev_samp", "stddev_pop",
                 "variance", "var_samp", "var_pop"}


def contains_aggregate(node: A.Node) -> bool:
    if isinstance(node, A.WindowFunc):
        # the window call itself is not an aggregation, but aggregates may
        # appear in its args (sum(sum(x)) OVER ..) or its OVER clause
        # (rank() OVER (ORDER BY sum(x)))
        return any(contains_aggregate(c) for c in ast_children(node))
    if isinstance(node, A.FunctionCall) and node.name in AGG_NAMES:
        return True
    for child in ast_children(node):
        if contains_aggregate(child):
            return True
    return False


def ast_children(node: A.Node):
    if isinstance(node, A.BinaryOp):
        return (node.left, node.right)
    if isinstance(node, A.UnaryOp):
        return (node.arg,)
    if isinstance(node, (A.IsNullPredicate,)):
        return (node.arg,)
    if isinstance(node, A.BetweenPredicate):
        return (node.arg, node.low, node.high)
    if isinstance(node, A.InPredicate):
        return (node.arg,) + node.values
    if isinstance(node, A.LikePredicate):
        return (node.arg, node.pattern)
    if isinstance(node, A.FunctionCall):
        return node.args
    if isinstance(node, A.WindowFunc):
        return node.args + node.partition_by + \
            tuple(o.expr for o in node.order_by)
    if isinstance(node, A.CastExpr):
        return (node.arg,)
    if isinstance(node, A.ExtractExpr):
        return (node.arg,)
    if isinstance(node, A.CaseExpr):
        out = [] if node.operand is None else [node.operand]
        for c, v in node.whens:
            out += [c, v]
        if node.default is not None:
            out.append(node.default)
        return tuple(out)
    return ()


# --------------------------------------------------------------------------
# literal typing & constant folding
# --------------------------------------------------------------------------

def number_literal(text: str) -> ir.Literal:
    if "." not in text:
        return ir.Literal(int(text), BIGINT)
    intpart, frac = text.split(".")
    scale = len(frac)
    digits = (intpart + frac).lstrip("0") or "0"
    value = int(intpart + frac) if intpart + frac else 0
    return ir.Literal(value, decimal(max(len(digits), 1), scale))


def date_literal(iso: str) -> ir.Literal:
    d = datetime.date.fromisoformat(iso)
    return ir.Literal((d - EPOCH).days, DATE)


def timestamp_literal(text: str) -> ir.Literal:
    from ..types import TIMESTAMP
    dt = datetime.datetime.fromisoformat(text)
    epoch = datetime.datetime(1970, 1, 1)
    micros = int((dt - epoch).total_seconds() * 1_000_000)
    return ir.Literal(micros, TIMESTAMP)


def add_months(d: datetime.date, n: int) -> datetime.date:
    y, m0 = divmod(d.year * 12 + d.month - 1 + n, 12)
    last = [31, 29 if y % 4 == 0 and (y % 100 != 0 or y % 400 == 0) else 28,
            31, 30, 31, 30, 31, 31, 30, 31, 30, 31][m0]
    return datetime.date(y, m0 + 1, min(d.day, last))


def fold_date_interval(base_days: int, interval: A.IntervalLit,
                       subtract: bool) -> int:
    n = -interval.value if (interval.negative != subtract) else interval.value
    base = EPOCH + datetime.timedelta(days=base_days)
    if interval.unit == "day":
        return base_days + n
    months = n * (12 if interval.unit == "year" else 1)
    return (add_months(base, months) - EPOCH).days


# --------------------------------------------------------------------------
# LIKE -> regex over dictionary pool
# --------------------------------------------------------------------------

def like_to_regex(pattern: str, escape: Optional[str]) -> re.Pattern:
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if escape and ch == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return re.compile("".join(out), re.DOTALL)


# --------------------------------------------------------------------------
# expression lowering
# --------------------------------------------------------------------------

class ExpressionLowerer:
    """Lowers an AST expression (no aggregates) to typed IR over a scope.

    `planner` (optional) enables uncorrelated scalar subquery lowering:
    the subquery is planned independently and embedded as a
    ScalarSubqueryRef the executor folds to a constant. Correlated
    subqueries fail to plan here and are handled by the planner's
    subquery-predicate pass (decorrelation to joins)."""

    def __init__(self, scope: Scope, planner=None, window_slots=None):
        self.scope = scope
        self.planner = planner
        # keep the caller's dict object: plan_aggregation populates it
        # after constructing the lowerer
        self.window_slots = window_slots if window_slots is not None else {}

    def lower(self, node: A.Node) -> ir.Expr:
        if isinstance(node, A.WindowFunc):
            slot = self.window_slots.get(node)
            if slot is None:
                raise AnalysisError(
                    f"window function {node.name}() not allowed here")
            return slot
        if isinstance(node, A.Identifier):
            col = self.scope.resolve(node.parts)
            return ir.ColumnRef(col.index, col.dtype, col.name)
        if isinstance(node, A.NumberLit):
            return number_literal(node.text)
        if isinstance(node, A.StringLit):
            # bare string literal: only meaningful against dictionary
            # columns; handled contextually below. Standalone -> error when
            # it reaches device lowering.
            return _StringConst(node.value)
        if isinstance(node, A.BoolLit):
            return ir.Literal(node.value, BOOLEAN)
        if isinstance(node, A.NullLit):
            return ir.Literal(None, BIGINT)
        if isinstance(node, A.DateLit):
            return date_literal(node.value)
        if isinstance(node, A.TimestampLit):
            return timestamp_literal(node.value)
        if isinstance(node, A.IntervalLit):
            raise AnalysisError(
                "INTERVAL literal only supported in date +/- INTERVAL")
        if isinstance(node, A.ArrayLiteral):
            return self.lower_array_literal(node)

        if isinstance(node, A.BinaryOp):
            return self.lower_binary(node)
        if isinstance(node, A.UnaryOp):
            if node.op == "not":
                return ir.Not(self.to_bool(self.lower(node.arg)))
            arg = self.lower(node.arg)
            if node.op == "-":
                if isinstance(arg, ir.Literal):
                    return ir.Literal(-arg.value if arg.value is not None
                                      else None, arg.dtype)
                return ir.Negate(arg, arg.dtype)
            return arg

        if isinstance(node, A.IsNullPredicate):
            return ir.IsNull(self.lower(node.arg), negated=node.negated)

        if isinstance(node, A.BetweenPredicate):
            arg = self.lower(node.arg)
            low = self.lower(node.low)
            high = self.lower(node.high)
            if arg.dtype.kind is TypeKind.VARCHAR and (
                    isinstance(low, _StringConst) or
                    isinstance(high, _StringConst)):
                pred = self.dict_range(arg, low, high)
            else:
                low = self.coerce_const(low, arg)
                high = self.coerce_const(high, arg)
                pred = ir.Between(arg, low, high)
            return ir.Not(pred) if node.negated else pred

        if isinstance(node, A.InPredicate):
            arg = self.lower(node.arg)
            vals = [self.lower(v) for v in node.values]
            if arg.dtype.kind is TypeKind.VARCHAR:
                if not all(isinstance(v, _StringConst) for v in vals):
                    raise AnalysisError("IN on varchar requires string "
                                        "literals")
                strings = {v.value for v in vals}   # duplicates are fine
                pred = self.dict_lut(arg, lambda s: s in strings)
            else:
                lits = []
                for v in vals:
                    v = self.coerce_const(v, arg)
                    if not isinstance(v, ir.Literal):
                        raise AnalysisError("IN requires literal values")
                    lits.append(v)
                pred = ir.InList(arg, tuple(lits))
            return ir.Not(pred) if node.negated else pred

        if isinstance(node, A.LikePredicate):
            arg = self.lower(node.arg)
            if arg.dtype.kind is not TypeKind.VARCHAR:
                raise AnalysisError("LIKE requires a varchar argument")
            if not isinstance(node.pattern, A.StringLit):
                raise AnalysisError("LIKE pattern must be a literal")
            escape = None
            if node.escape is not None:
                if not isinstance(node.escape, A.StringLit):
                    raise AnalysisError("ESCAPE must be a literal")
                escape = node.escape.value
            rx = like_to_regex(node.pattern.value, escape)
            pred = self.dict_lut(arg, lambda s: rx.fullmatch(s) is not None)
            return ir.Not(pred) if node.negated else pred

        if isinstance(node, A.CaseExpr):
            return self.lower_case(node)

        if isinstance(node, A.CastExpr):
            arg = self.lower(node.arg)
            target = parse_type(node.type_name)
            if isinstance(arg, _StringConst):
                return self.cast_string_const(arg, target)
            return ir.Cast(arg, target)

        if isinstance(node, A.ExtractExpr):
            arg = self.lower(node.arg)
            if arg.dtype.kind not in (TypeKind.DATE, TypeKind.TIMESTAMP):
                raise AnalysisError(
                    "EXTRACT requires a date or timestamp argument")
            if node.part in ("hour", "minute", "second") and \
                    arg.dtype.kind is not TypeKind.TIMESTAMP:
                raise AnalysisError(
                    f"EXTRACT({node.part}) requires a timestamp")
            return ir.ExtractField(node.part, arg)

        if isinstance(node, A.FunctionCall):
            if node.name in AGG_NAMES:
                raise AnalysisError(
                    f"aggregate {node.name}() not allowed here")
            if node.name in ("substring", "substr"):
                return self.lower_substring(node)
            return self.lower_scalar_func(node)

        if isinstance(node, A.InSubquery):
            # non-conjunct position (inside OR / select item): plan the
            # uncorrelated subquery now, fold to InList at execution
            # (conjunct-position IN decorrelates to semi/anti joins before
            # lowering ever sees it)
            if self.planner is None:
                raise AnalysisError(
                    "IN subquery not allowed in this context")
            arg = self.lower(node.arg)
            sub = self.planner.plan_query(node.query)  # raises if correlated
            if len(sub.scope.columns) != 1:
                raise AnalysisError("IN subquery must return one column")
            arg_field = self.planner.field_for(arg, self.scope)
            ref = ir.InSubqueryRef(arg, sub.node, arg_field,
                                   sub.scope.columns[0].field)
            return ir.Not(ref) if node.negated else ref

        if isinstance(node, A.ScalarSubquery):
            if self.planner is None:
                raise AnalysisError(
                    "scalar subquery not allowed in this context")
            sub = self.planner.plan_query(node.query)   # raises if correlated
            if len(sub.scope.columns) != 1:
                raise AnalysisError("scalar subquery must return one column")
            return ir.ScalarSubqueryRef(sub.node, sub.scope.columns[0].dtype)

        raise AnalysisError(f"unsupported expression {type(node).__name__}")

    def lower_substring(self, node: A.FunctionCall) -> ir.Expr:
        """substring(varchar_col, start, length): transform the string pool
        host-side; device codes are unchanged (DerivedDict)."""
        if len(node.args) != 3:
            raise AnalysisError("substring(col, start, length) expected")
        arg = self.lower(node.args[0])
        if arg.dtype.kind is not TypeKind.VARCHAR:
            raise AnalysisError("substring requires a varchar argument")
        try:
            start = int(node.args[1].text)
            length = int(node.args[2].text)
        except (AttributeError, ValueError):
            raise AnalysisError("substring start/length must be integers")
        pool = self.pool_of(arg)
        transformed = [s[start - 1:start - 1 + length] for s in pool]
        new_pool = tuple(sorted(set(transformed)))
        index = {s: i for i, s in enumerate(new_pool)}
        lut = tuple(index[s] for s in transformed)
        return ir.DerivedDict(arg, lut, new_pool, arg.dtype)

    def lower_array_literal(self, node: "A.ArrayLiteral") -> ir.Expr:
        """ARRAY[...] of constants -> pool entry (tree/ArrayConstructor).
        Elements must be literals; NULL elements allowed."""
        from ..types import array_of
        elems = []
        elem_t = None
        for item in node.items:
            e = self.lower(item)
            if isinstance(e, _StringConst):
                elems.append(e.value)
                et = VARCHAR
            elif isinstance(e, ir.Literal):
                elems.append(e.value)
                et = e.dtype
            else:
                raise AnalysisError(
                    "ARRAY[...] elements must be constants")
            if e_is_null := (elems[-1] is None):
                continue
            if elem_t is None or elem_t.kind is TypeKind.BIGINT:
                elem_t = et
            elif et.kind is not TypeKind.BIGINT and et != elem_t:
                elem_t = common_super_type(elem_t, et)
        if elem_t is None:
            elem_t = BIGINT
        return ir.ArrayConst((tuple(elems),), array_of(elem_t))

    def lower_scalar_func(self, node: A.FunctionCall) -> ir.Expr:
        """Built-in scalar functions (metadata/InternalFunctionBundle.java's
        registry role): numeric ones lower to ir.ScalarFunc, varchar ones to
        host-side dictionary-pool transforms."""
        name = node.name
        args = [self.lower(a) for a in node.args]

        # -- varchar functions: pool transforms / LUTs --------------------
        if name in ("upper", "lower", "trim", "ltrim", "rtrim"):
            if len(args) != 1:
                raise AnalysisError(f"{name} takes one argument")
            fn = {"upper": str.upper, "lower": str.lower,
                  "trim": str.strip, "ltrim": str.lstrip,
                  "rtrim": str.rstrip}[name]
            return self.dict_transform(args[0], fn)
        if name == "length":
            if len(args) != 1:
                raise AnalysisError("length takes one argument")
            pool = self.pool_of(args[0])
            return ir.DictValueMap(args[0],
                                   tuple(len(s) for s in pool), BIGINT)
        if name == "cardinality":
            if len(args) != 1 or \
                    args[0].dtype.kind is not TypeKind.ARRAY:
                raise AnalysisError("cardinality takes an array")
            pool = self.pool_of(args[0])
            return ir.DictValueMap(args[0],
                                   tuple(len(t) for t in pool), BIGINT)
        if name == "contains":
            if len(args) != 2 or \
                    args[0].dtype.kind is not TypeKind.ARRAY:
                raise AnalysisError("contains(array, constant)")
            pool = self.pool_of(args[0])
            needle = args[1]
            if isinstance(needle, _StringConst):
                v = needle.value
            elif isinstance(needle, ir.Literal):
                v = needle.value
            else:
                raise AnalysisError("contains needle must be a constant")
            from ..types import BOOLEAN as _B
            return ir.DictPredicate(args[0],
                                    tuple(v in t for t in pool), _B)
        if name == "coalesce" and len(args) == 2 and \
                not isinstance(args[0], _StringConst) and \
                args[0].dtype.kind is TypeKind.VARCHAR and \
                isinstance(args[1], _StringConst):
            # varchar coalesce-to-literal: pool transform whose NULL rows
            # take the literal's code. Pools must stay lexicographically
            # sorted (code order == string order is relied on by varchar
            # range compares, ORDER BY, min/max), so an unseen literal is
            # INSERTED at its sorted position and existing codes at or
            # after the insertion point shift up by one.
            import bisect
            col, lit = args[0], args[1].value
            pool = tuple(self.pool_of(col))
            if lit in pool:
                return ir.DerivedDict(col, tuple(range(len(pool))), pool,
                                      col.dtype,
                                      null_code=pool.index(lit))
            ins = bisect.bisect_left(pool, lit)
            new_pool = pool[:ins] + (lit,) + pool[ins:]
            lut = tuple(i if i < ins else i + 1 for i in range(len(pool)))
            return ir.DerivedDict(col, lut, new_pool, col.dtype,
                                  null_code=ins)
        if name == "concat":
            return self.lower_concat(args)
        if name == "replace":
            if len(args) != 3 or not isinstance(args[1], _StringConst) \
                    or not isinstance(args[2], _StringConst):
                raise AnalysisError(
                    "replace(col, 'from', 'to') with literal patterns")
            a, b = args[1].value, args[2].value
            return self.dict_transform(args[0],
                                       lambda s: s.replace(a, b))
        if name == "starts_with":
            if len(args) != 2 or not isinstance(args[1], _StringConst):
                raise AnalysisError(
                    "starts_with(col, 'prefix') with a literal prefix")
            prefix = args[1].value
            return self.dict_lut(args[0],
                                 lambda s: s.startswith(prefix))
        if name in ("strpos", "position"):
            if len(args) != 2 or not isinstance(args[1], _StringConst):
                raise AnalysisError(
                    f"{name}(col, 'needle') with a literal needle")
            needle = args[1].value
            pool = self.pool_of(args[0])
            return ir.DictValueMap(
                args[0], tuple(s.find(needle) + 1 for s in pool), BIGINT)
        if name == "split_part":
            if len(args) != 3 or not isinstance(args[1], _StringConst) \
                    or not isinstance(args[2], ir.Literal):
                raise AnalysisError(
                    "split_part(col, 'delim', n) with literal delim/n")
            delim, idx = args[1].value, int(args[2].value)
            if idx < 1:
                raise AnalysisError("split_part index starts at 1")

            def part(s, d=delim, i=idx):
                fields = s.split(d)
                return fields[i - 1] if i <= len(fields) else ""
            return self.dict_transform(args[0], part)
        if name == "regexp_like":
            if len(args) != 2 or not isinstance(args[1], _StringConst):
                raise AnalysisError(
                    "regexp_like(col, 'pattern') with a literal pattern")
            import re as _re
            pat = _re.compile(args[1].value)
            return self.dict_lut(args[0],
                                 lambda s: pat.search(s) is not None)
        if name == "date_trunc":
            if len(args) != 2 or not isinstance(args[0], _StringConst):
                raise AnalysisError(
                    "date_trunc('unit', x) with a literal unit")
            unit = args[0].value.lower()
            x = args[1]
            kinds = ("year", "quarter", "month", "week", "day")
            if x.dtype.kind is TypeKind.TIMESTAMP:
                kinds = kinds + ("hour", "minute", "second")
            if x.dtype.kind not in (TypeKind.DATE, TypeKind.TIMESTAMP) \
                    or unit not in kinds:
                raise AnalysisError(
                    f"date_trunc unit {unit!r} unsupported for "
                    f"{x.dtype.kind.value}")
            return ir.ExtractField(f"trunc_{unit}", x, x.dtype)
        if name in ("year", "month", "day"):
            if len(args) != 1 or args[0].dtype.kind not in (
                    TypeKind.DATE, TypeKind.TIMESTAMP):
                raise AnalysisError(f"{name} requires a date argument")
            return ir.ExtractField(name, args[0])
        if name in ("hour", "minute", "second"):
            if len(args) != 1 or \
                    args[0].dtype.kind is not TypeKind.TIMESTAMP:
                raise AnalysisError(f"{name} requires a timestamp")
            return ir.ExtractField(name, args[0])

        # -- numeric / conditional ----------------------------------------
        for a in args:
            if isinstance(a, _StringConst):
                raise AnalysisError(
                    f"{name}() does not take string literals")
        if name in ("coalesce", "nullif", "greatest", "least"):
            if name == "nullif" and len(args) != 2:
                raise AnalysisError("nullif takes two arguments")
            if len(args) < 2:
                raise AnalysisError(f"{name} takes at least two arguments")
            out_t = args[0].dtype
            if name != "nullif":
                for a in args[1:]:
                    out_t = common_super_type(out_t, a.dtype)
            return ir.ScalarFunc(name, tuple(args), out_t)
        if name in ("abs", "round", "floor", "ceil", "ceiling"):
            t = args[0].dtype
            digits = ()
            if name == "round" and len(args) == 2:
                if not isinstance(args[1], ir.Literal):
                    raise AnalysisError("round digits must be a literal")
                digits = (int(args[1].value),)
                args = args[:1]
            if name in ("floor", "ceil", "ceiling"):
                out_t = BIGINT if t.kind in (TypeKind.DECIMAL,
                                             TypeKind.BIGINT,
                                             TypeKind.INTEGER) else DOUBLE
                return ir.ScalarFunc("ceil" if name == "ceiling" else name,
                                     tuple(args), out_t)
            return ir.ScalarFunc(name, tuple(args), t, digits)
        if name == "mod":
            if len(args) != 2:
                raise AnalysisError("mod takes two arguments")
            out_t = common_super_type(args[0].dtype, args[1].dtype)
            return ir.ScalarFunc(name, tuple(args), out_t)
        if name in ("sqrt", "power", "pow", "exp", "ln"):
            return ir.ScalarFunc("power" if name == "pow" else name,
                                 tuple(args), DOUBLE)
        raise AnalysisError(f"unsupported function {name}()")

    def dict_transform(self, col: ir.Expr, fn) -> ir.Expr:
        """Apply a host string transform to the pool (DerivedDict)."""
        pool = self.pool_of(col)
        transformed = [fn(s) for s in pool]
        new_pool = tuple(sorted(set(transformed)))
        index = {s: i for i, s in enumerate(new_pool)}
        lut = tuple(index[s] for s in transformed)
        return ir.DerivedDict(col, lut, new_pool, col.dtype
                              if not isinstance(col, _StringConst)
                              else VARCHAR)

    def lower_concat(self, args) -> ir.Expr:
        """col || literal / literal || col (pool transform). col || col
        would explode the pool cross-product — unsupported."""
        cols = [a for a in args
                if not isinstance(a, _StringConst)]
        if len(cols) != 1:
            raise AnalysisError(
                "concat supports one varchar column plus literals")
        col = cols[0]
        if col.dtype.kind is not TypeKind.VARCHAR:
            raise AnalysisError("concat requires varchar arguments")
        prefix = ""
        suffix = ""
        before = True
        for a in args:
            if a is col:
                before = False
            elif isinstance(a, _StringConst):
                if before:
                    prefix += a.value
                else:
                    suffix += a.value
        return self.dict_transform(col,
                                   lambda s: f"{prefix}{s}{suffix}")

    # ---- helpers ----------------------------------------------------------

    def to_bool(self, e: ir.Expr) -> ir.Expr:
        if e.dtype.kind is not TypeKind.BOOLEAN:
            raise AnalysisError("expected boolean expression")
        return e

    def lower_binary(self, node: A.BinaryOp) -> ir.Expr:
        op = node.op
        if op in ("and", "or"):
            return ir.Logical(op, (self.to_bool(self.lower(node.left)),
                                   self.to_bool(self.lower(node.right))))
        if op in ("=", "<>", "<", "<=", ">", ">="):
            left = self.lower(node.left)
            right = self.lower(node.right)
            if isinstance(left, _StringConst) and \
                    right.dtype.kind is TypeKind.VARCHAR:
                return self.dict_compare(right, flip(op), left.value)
            if isinstance(right, _StringConst) and \
                    left.dtype.kind is TypeKind.VARCHAR:
                return self.dict_compare(left, op, right.value)
            if isinstance(left, _StringConst) or \
                    isinstance(right, _StringConst):
                raise AnalysisError("string comparison requires a varchar "
                                    "column side")
            if left.dtype.kind is TypeKind.VARCHAR and \
                    right.dtype.kind is TypeKind.VARCHAR:
                return self.varchar_compare(op, left, right)
            return ir.Compare(op, left, right)
        if op in ("+", "-"):
            # date +/- interval folds at plan time for literal dates,
            # lowers to day arithmetic for day intervals on columns
            if isinstance(node.right, A.IntervalLit):
                left = self.lower(node.left)
                iv = node.right
                if isinstance(left, ir.Literal) and \
                        left.dtype.kind is TypeKind.DATE:
                    return ir.Literal(
                        fold_date_interval(left.value, iv, op == "-"),
                        DATE)
                if left.dtype.kind is TypeKind.DATE and iv.unit == "day":
                    n = -iv.value if (iv.negative != (op == "-")) \
                        else iv.value
                    return ir.arith("+", left, ir.Literal(n, BIGINT))
                raise AnalysisError(
                    "month/year intervals only fold against date literals")
        if op in ("+", "-", "*", "/", "%"):
            left = self.lower(node.left)
            right = self.lower(node.right)
            if op == "%":
                out_t = common_super_type(left.dtype, right.dtype)
                return ir.ScalarFunc("mod", (left, right), out_t)
            return ir.arith(op, left, right)
        if op == "||":
            return self.lower_concat([self.lower(node.left),
                                      self.lower(node.right)])
        raise AnalysisError(f"unsupported operator {op!r}")

    def varchar_compare(self, op: str, left: ir.Expr,
                        right: ir.Expr) -> ir.Expr:
        """varchar-vs-varchar comparison: dictionary codes are only
        comparable within one pool (pools are kept lexicographically
        sorted, so code order == string order). Differing pools: =/<>
        compare through a right->left pool remap (-1 = absent, never
        equal); range comparisons would need a merged ordering — raise."""
        lpool = self.pool_of(left)
        rpool = self.pool_of(right)
        if lpool == rpool:
            return ir.Compare(op, left, right)
        if op not in ("=", "<>"):
            raise AnalysisError(
                "ordered varchar comparison across different dictionaries "
                "is unsupported")
        # both sides become BIGINT codes in the LEFT pool's space
        index = {s: j for j, s in enumerate(lpool)}
        lut = tuple(index.get(s, -1) for s in rpool)
        return ir.Compare(op, ir.Cast(left, BIGINT),
                          ir.DictValueMap(right, lut, BIGINT))

    def lower_case(self, node: A.CaseExpr) -> ir.Expr:
        whens = []
        for cond_ast, val_ast in node.whens:
            if node.operand is not None:
                cond_ast = A.BinaryOp("=", node.operand, cond_ast)
            whens.append((self.to_bool(self.lower(cond_ast)),
                          self.lower(val_ast)))
        default = None if node.default is None else self.lower(node.default)
        # result type: common super type of branch values
        vals = [v for _, v in whens] + ([default] if default else [])
        out_t = vals[0].dtype
        for v in vals[1:]:
            from ..types import common_super_type
            out_t = common_super_type(out_t, v.dtype)
        whens = tuple((c, self.coerce_to(v, out_t)) for c, v in whens)
        default = self.coerce_to(default, out_t) if default else None
        return ir.Case(whens, default, out_t)

    def coerce_to(self, e: ir.Expr, t: DataType) -> ir.Expr:
        if e.dtype == t:
            return e
        return ir.Cast(e, t)

    def coerce_const(self, e: ir.Expr, like: ir.Expr) -> ir.Expr:
        """Coerce literal to the column's type (e.g. decimal rescale)."""
        if isinstance(e, _StringConst):
            raise AnalysisError("cannot compare string to non-varchar")
        return e

    def cast_string_const(self, s: "_StringConst", t: DataType) -> ir.Expr:
        if t.kind is TypeKind.DATE:
            return date_literal(s.value)
        if t.kind is TypeKind.DECIMAL:
            return ir.Literal(
                int(round(float(s.value) * 10 ** t.scale)), t)
        if t.kind in (TypeKind.BIGINT, TypeKind.INTEGER):
            return ir.Literal(int(s.value), t)
        if t.kind is TypeKind.DOUBLE:
            return ir.Literal(float(s.value), t)
        raise AnalysisError(f"cannot cast string literal to {t}")

    # ---- dictionary predicates --------------------------------------------

    def pool_of(self, col: ir.Expr) -> tuple:
        if isinstance(col, ir.DerivedDict):
            return col.pool
        if isinstance(col, ir.ArrayConst):
            return col.pool
        if not isinstance(col, ir.ColumnRef):
            raise AnalysisError("varchar predicate requires a plain column")
        sc = next(c for c in self.scope.columns if c.index == col.index
                  and c.dtype.kind in (TypeKind.VARCHAR, TypeKind.ARRAY))
        if sc.field is None or sc.field.dictionary is None:
            raise AnalysisError(f"column {sc.name} has no dictionary")
        return sc.field.dictionary

    def dict_lut(self, col: ir.Expr, pred) -> ir.Expr:
        pool = self.pool_of(col)
        return ir.DictPredicate(col, tuple(bool(pred(s)) for s in pool))

    def dict_compare(self, col: ir.Expr, op: str, s: str) -> ir.Expr:
        ops = {"=": lambda x: x == s, "<>": lambda x: x != s,
               "<": lambda x: x < s, "<=": lambda x: x <= s,
               ">": lambda x: x > s, ">=": lambda x: x >= s}
        return self.dict_lut(col, ops[op])

    def dict_range(self, col: ir.Expr, low, high) -> ir.Expr:
        lo = low.value if isinstance(low, _StringConst) else None
        hi = high.value if isinstance(high, _StringConst) else None
        if lo is None or hi is None:
            raise AnalysisError("varchar BETWEEN requires string literals")
        return self.dict_lut(col, lambda x: lo <= x <= hi)


@dataclass(frozen=True)
class _StringConst(ir.Expr):
    """Pre-lowering marker for string literals; must be consumed by a
    dictionary predicate before reaching the device."""
    value: str

    @property
    def dtype(self):
        raise AnalysisError(
            f"string literal {self.value!r} used outside a varchar "
            f"comparison context")


def materialize_string(e: ir.Expr) -> ir.Expr:
    """A string literal escaping to a value context (SELECT 'a') becomes a
    VARCHAR Literal with a single-entry pool (code 0); field_for attaches
    the dictionary."""
    if isinstance(e, _StringConst):
        from ..types import VARCHAR
        return ir.Literal(e.value, VARCHAR)
    return e


def flip(op: str) -> str:
    return {"=": "=", "<>": "<>", "<": ">", "<=": ">=",
            ">": "<", ">=": "<="}[op]


def parse_type(name: str) -> DataType:
    name = name.lower()
    if name in ("bigint",):
        return BIGINT
    if name in ("integer", "int", "smallint", "tinyint"):
        from ..types import INTEGER
        return INTEGER
    if name == "double":
        return DOUBLE
    if name == "boolean":
        return BOOLEAN
    if name == "date":
        return DATE
    if name == "timestamp":
        from ..types import TIMESTAMP
        return TIMESTAMP
    m = re.fullmatch(r"decimal\((\d+),(\d+)\)", name)
    if m:
        return decimal(int(m.group(1)), int(m.group(2)))
    if name == "varchar":
        from ..types import VARCHAR
        return VARCHAR
    raise AnalysisError(f"unknown type {name}")
