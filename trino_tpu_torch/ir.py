"""Port copy of ``trino_tpu/ir.py`` (no edits beyond import targets noted
inline).

Engine-internal typed expression IR.

Reference: Trino lowers analyzed AST expressions to its own IR (sql/ir/, 29
files: Call, Constant, Comparison, Logical, ...) which the bytecode compilers
consume (sql/gen/ExpressionCompiler.java:38). Ours is the input to the JAX
tracer in ops/project.py — jit + XLA fusion replaces bytecode generation.

Every node is typed (``dtype``). The analyzer (planner/analyzer.py) produces
only well-typed trees; the compiler assumes them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from .types import (BIGINT, BOOLEAN, DATE, DOUBLE, DataType, TypeKind,
                    common_super_type, decimal)


class Expr:
    dtype: DataType


@dataclass(frozen=True)
class ColumnRef(Expr):
    index: int          # position in the input batch
    dtype: DataType
    name: str = ""      # for debugging / explain


@dataclass(frozen=True)
class Literal(Expr):
    value: object       # python int/float/bool/str/None; DECIMAL as scaled int
    dtype: DataType


@dataclass(frozen=True)
class Arith(Expr):
    """+ - * / following Trino's decimal scale rules
    (spi/type/DecimalOperators semantics for short decimals):
    add/sub -> max scale; mul -> s1+s2; div -> lowered to DOUBLE."""
    op: str             # '+', '-', '*', '/'
    left: Expr
    right: Expr
    dtype: DataType


@dataclass(frozen=True)
class Negate(Expr):
    arg: Expr
    dtype: DataType


@dataclass(frozen=True)
class Compare(Expr):
    op: str             # '=', '<>', '<', '<=', '>', '>='
    left: Expr
    right: Expr
    dtype: DataType = BOOLEAN


@dataclass(frozen=True)
class Logical(Expr):
    """AND/OR with Kleene three-valued logic (Trino sql/ir/Logical.java)."""
    op: str             # 'and', 'or'
    args: tuple         # tuple[Expr, ...]
    dtype: DataType = BOOLEAN


@dataclass(frozen=True)
class Not(Expr):
    arg: Expr
    dtype: DataType = BOOLEAN


@dataclass(frozen=True)
class IsNull(Expr):
    arg: Expr
    negated: bool = False
    dtype: DataType = BOOLEAN


@dataclass(frozen=True)
class InList(Expr):
    arg: Expr
    values: tuple       # tuple[Literal, ...] coerced to arg's physical rep
    dtype: DataType = BOOLEAN


@dataclass(frozen=True)
class Between(Expr):
    arg: Expr
    low: Expr
    high: Expr
    dtype: DataType = BOOLEAN


@dataclass(frozen=True)
class Case(Expr):
    """Searched CASE. whens = ((cond, value), ...)."""
    whens: tuple
    default: Optional[Expr]
    dtype: DataType


@dataclass(frozen=True)
class Cast(Expr):
    arg: Expr
    dtype: DataType


@dataclass(frozen=True)
class DictPredicate(Expr):
    """Boolean predicate over a dictionary-encoded VARCHAR column, evaluated
    host-side over the string pool into a code->bool lookup table at plan
    time (LIKE, =, IN on strings). Device work is a single gather.

    This is the TPU answer to Trino's LikeMatcher DFA (likematcher/) and
    dictionary-aware processing in PageProcessor (SURVEY.md §7 strings)."""
    arg: Expr           # must be a VARCHAR ColumnRef
    lut: tuple          # tuple[bool, ...], len == dictionary size
    dtype: DataType = BOOLEAN


@dataclass(frozen=True)
class ScalarSubqueryRef(Expr):
    """Uncorrelated scalar subquery: holds the planned subplan. The executor
    runs it once, extracts the single value, and substitutes a Literal
    before tracing (Trino: uncorrelated subqueries execute as independent
    stages feeding a semi-join/filter; here they fold to a constant)."""
    plan: object        # L.OutputNode (opaque to avoid import cycle)
    dtype: DataType

    def __hash__(self):
        return id(self.plan)

    def __eq__(self, other):
        return self is other


@dataclass(frozen=True)
class DerivedDict(Expr):
    """VARCHAR expression computed by transforming the string pool
    host-side (e.g. substring over every pool entry) and remapping codes
    through `lut` into a deduplicated `pool`. Device work is one gather;
    canonical codes make GROUP BY / joins on the derived value correct
    even when source strings collide after the transform
    (SURVEY.md §7 strings policy)."""
    arg: Expr           # VARCHAR ColumnRef (or nested DerivedDict)
    lut: tuple          # old code -> new code (int), len == source pool
    pool: tuple         # deduplicated transformed pool (new code -> str)
    dtype: DataType     # VARCHAR
    null_code: Optional[int] = None   # coalesce: NULL rows take this
    #                                   code and become valid


@dataclass(frozen=True, eq=False)
class InSubqueryRef(Expr):
    """x IN (uncorrelated subquery) in a non-conjunct position (inside OR,
    select items). The executor folds it to InList over the executed
    subquery's values, with Kleene NULL injection when the subquery
    contains NULLs (x IN S is NULL when unmatched and S has NULL).
    Top-level conjuncts never reach this node — they decorrelate to
    semi/anti joins first. Hashes by identity (carries a plan)."""
    arg: "Expr"
    plan: object                 # logical plan of the subquery
    arg_field: object            # Optional[Field] — probe dictionary
    sub_field: object            # Optional[Field] — subquery dictionary

    @property
    def dtype(self):
        from .types import BOOLEAN
        return BOOLEAN

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


@dataclass(frozen=True)
class ScalarFunc(Expr):
    """Generic elementwise scalar function (abs/round/mod/coalesce/...).

    The engine analog of Trino's operator/scalar/ built-ins resolved via
    InternalFunctionBundle — evaluated branch-free in ops/project.py."""
    name: str
    args: tuple                  # tuple[Expr, ...]
    dtype: DataType
    params: tuple = ()           # static extras (e.g. round digits)


@dataclass(frozen=True)
class DictValueMap(Expr):
    """Map dictionary codes to precomputed host values (e.g. length(col)):
    one device gather through a per-code LUT."""
    arg: Expr                    # varchar codes
    values: tuple                # per-code value
    dtype: DataType


@dataclass(frozen=True)
class ArrayConst(Expr):
    """ARRAY[...] of constants: device sees pool id 0, the single-entry
    element pool rides in the expression (the dictionary discipline,
    types.py ARRAY)."""
    pool: tuple                  # ((elem, elem, ...),)
    dtype: DataType


@dataclass(frozen=True)
class DecimalAvg(Expr):
    """Exact decimal AVG finalizer: round-half-away-from-zero of
    sum/count at the argument's scale (Trino avg(decimal) semantics,
    computed with integer ops on device)."""
    sum: Expr
    count: Expr
    dtype: DataType


@dataclass(frozen=True)
class ExtractField(Expr):
    """EXTRACT(YEAR/MONTH/DAY FROM date_expr) — computes civil fields from
    epoch days on device."""
    part: str           # 'year', 'month', 'day'
    arg: Expr
    dtype: DataType = BIGINT


# --------------------------------------------------------------------------
# Constructors with type inference (used by the analyzer)
# --------------------------------------------------------------------------

def arith(op: str, left: Expr, right: Expr) -> Expr:
    lt, rt = left.dtype, right.dtype
    if op == '/':
        # Trino returns DECIMAL with complex scale rules; we lower division
        # to DOUBLE (documented deviation; exact where it matters — avg —
        # is handled by aggregate finalizers).
        if TypeKind.DOUBLE in (lt.kind, rt.kind) or \
           TypeKind.DECIMAL in (lt.kind, rt.kind):
            return Arith(op, left, right, DOUBLE)
        return Arith(op, left, right, common_super_type(lt, rt))
    if op == '*' and lt.kind is TypeKind.DECIMAL and rt.kind is TypeKind.DECIMAL:
        out = decimal(min(18, lt.precision + rt.precision), lt.scale + rt.scale)
        return Arith(op, left, right, out)
    if {lt.kind, rt.kind} == {TypeKind.DATE} and op == '-':
        return Arith(op, left, right, BIGINT)  # date difference in days
    return Arith(op, left, right, common_super_type(lt, rt))


def comparable(left: Expr, right: Expr) -> tuple:
    """Common comparison type for two sides (analyzer inserts Casts)."""
    return common_super_type(left.dtype, right.dtype)


def walk(expr: Expr):
    """Yield every node in the tree (pre-order)."""
    yield expr
    children = ()
    if isinstance(expr, Arith):
        children = (expr.left, expr.right)
    elif isinstance(expr, (Negate, Not, Cast, ExtractField, DictPredicate,
                           DerivedDict, DictValueMap)):
        children = (expr.arg,)
    elif isinstance(expr, ScalarFunc):
        children = expr.args
    elif isinstance(expr, InSubqueryRef):
        children = (expr.arg,)
    elif isinstance(expr, IsNull):
        children = (expr.arg,)
    elif isinstance(expr, Compare):
        children = (expr.left, expr.right)
    elif isinstance(expr, Logical):
        children = expr.args
    elif isinstance(expr, InList):
        children = (expr.arg,)
    elif isinstance(expr, Between):
        children = (expr.arg, expr.low, expr.high)
    elif isinstance(expr, Case):
        children = tuple(c for w in expr.whens for c in w) + \
            ((expr.default,) if expr.default is not None else ())
    elif isinstance(expr, DecimalAvg):
        children = (expr.sum, expr.count)
    for c in children:
        yield from walk(c)


def referenced_columns(expr: Expr) -> set:
    return {n.index for n in walk(expr) if isinstance(n, ColumnRef)}


def remap_columns(expr: Expr, mapping) -> Expr:
    """Rebuild an expression with ColumnRef indices translated through
    `mapping` (used by the column-pruning optimizer pass)."""
    if isinstance(expr, ColumnRef):
        return ColumnRef(mapping[expr.index], expr.dtype, expr.name)
    if isinstance(expr, (Literal, ArrayConst)):
        return expr
    if isinstance(expr, Arith):
        return Arith(expr.op, remap_columns(expr.left, mapping),
                     remap_columns(expr.right, mapping), expr.dtype)
    if isinstance(expr, Negate):
        return Negate(remap_columns(expr.arg, mapping), expr.dtype)
    if isinstance(expr, Compare):
        return Compare(expr.op, remap_columns(expr.left, mapping),
                       remap_columns(expr.right, mapping))
    if isinstance(expr, Logical):
        return Logical(expr.op, tuple(remap_columns(a, mapping)
                                      for a in expr.args))
    if isinstance(expr, Not):
        return Not(remap_columns(expr.arg, mapping))
    if isinstance(expr, IsNull):
        return IsNull(remap_columns(expr.arg, mapping), expr.negated)
    if isinstance(expr, InList):
        return InList(remap_columns(expr.arg, mapping), expr.values)
    if isinstance(expr, Between):
        return Between(remap_columns(expr.arg, mapping),
                       remap_columns(expr.low, mapping),
                       remap_columns(expr.high, mapping))
    if isinstance(expr, Case):
        return Case(tuple((remap_columns(c, mapping),
                           remap_columns(v, mapping))
                          for c, v in expr.whens),
                    None if expr.default is None
                    else remap_columns(expr.default, mapping), expr.dtype)
    if isinstance(expr, Cast):
        return Cast(remap_columns(expr.arg, mapping), expr.dtype)
    if isinstance(expr, DictPredicate):
        return DictPredicate(remap_columns(expr.arg, mapping), expr.lut)
    if isinstance(expr, DecimalAvg):
        return DecimalAvg(remap_columns(expr.sum, mapping),
                          remap_columns(expr.count, mapping), expr.dtype)
    if isinstance(expr, ExtractField):
        return ExtractField(expr.part, remap_columns(expr.arg, mapping),
                            expr.dtype)
    if isinstance(expr, DerivedDict):
        return DerivedDict(remap_columns(expr.arg, mapping), expr.lut,
                           expr.pool, expr.dtype, expr.null_code)
    if isinstance(expr, ScalarFunc):
        return ScalarFunc(expr.name,
                          tuple(remap_columns(a, mapping)
                                for a in expr.args),
                          expr.dtype, expr.params)
    if isinstance(expr, DictValueMap):
        return DictValueMap(remap_columns(expr.arg, mapping), expr.values,
                            expr.dtype)
    if isinstance(expr, ScalarSubqueryRef):
        return expr          # no column refs into the enclosing batch
    if isinstance(expr, InSubqueryRef):
        return InSubqueryRef(remap_columns(expr.arg, mapping), expr.plan,
                             expr.arg_field, expr.sub_field)
    raise NotImplementedError(type(expr).__name__)


def transform(expr: Expr, fn) -> Expr:
    """Pre-order structural rewrite: fn(node) -> replacement or None (to
    recurse into children). Generic over all IR dataclasses."""
    import dataclasses
    r = fn(expr)
    if r is not None:
        return r
    if not dataclasses.is_dataclass(expr):
        return expr
    changes = {}
    for f in dataclasses.fields(expr):
        v = getattr(expr, f.name)
        nv = _transform_value(v, fn)
        if nv is not v:
            changes[f.name] = nv
    return dataclasses.replace(expr, **changes) if changes else expr


def _transform_value(v, fn):
    if isinstance(v, Expr):
        return transform(v, fn)
    if isinstance(v, tuple):
        items = tuple(_transform_value(x, fn) for x in v)
        if any(a is not b for a, b in zip(items, v)):
            return items
    return v
