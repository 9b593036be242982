"""Port copy of ``trino_tpu/sql/ast_nodes.py`` (no edits beyond import targets
noted inline).

Untyped SQL AST.

Reference: core/trino-parser's 296 immutable tree classes
(core/trino-parser/.../tree/). We model the subset the engine executes;
the analyzer (planner/analyzer.py) resolves names and types.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class Node:
    pass


# ---- expressions ----------------------------------------------------------

@dataclass(frozen=True)
class Identifier(Node):
    parts: Tuple[str, ...]          # qualified name, original case


@dataclass(frozen=True)
class NumberLit(Node):
    text: str                       # literal text; analyzer types it


@dataclass(frozen=True)
class StringLit(Node):
    value: str


@dataclass(frozen=True)
class BoolLit(Node):
    value: bool


@dataclass(frozen=True)
class NullLit(Node):
    pass


@dataclass(frozen=True)
class DateLit(Node):
    value: str                      # ISO yyyy-mm-dd


@dataclass(frozen=True)
class TimestampLit(Node):
    value: str                      # ISO yyyy-mm-dd hh:mm:ss


@dataclass(frozen=True)
class IntervalLit(Node):
    value: int
    unit: str                       # 'year' | 'month' | 'day'
    negative: bool = False


@dataclass(frozen=True)
class BinaryOp(Node):
    op: str                         # arithmetic/comparison/'and'/'or'
    left: Node
    right: Node


@dataclass(frozen=True)
class UnaryOp(Node):
    op: str                         # '-' | '+' | 'not'
    arg: Node


@dataclass(frozen=True)
class IsNullPredicate(Node):
    arg: Node
    negated: bool


@dataclass(frozen=True)
class BetweenPredicate(Node):
    arg: Node
    low: Node
    high: Node
    negated: bool


@dataclass(frozen=True)
class InPredicate(Node):
    arg: Node
    values: Tuple[Node, ...]        # literal list; subquery variant separate
    negated: bool


@dataclass(frozen=True)
class InSubquery(Node):
    arg: Node
    query: "Query"
    negated: bool


@dataclass(frozen=True)
class ExistsPredicate(Node):
    query: "Query"
    negated: bool


@dataclass(frozen=True)
class ScalarSubquery(Node):
    query: "Query"


@dataclass(frozen=True)
class LikePredicate(Node):
    arg: Node
    pattern: Node
    escape: Optional[Node]
    negated: bool


@dataclass(frozen=True)
class FunctionCall(Node):
    name: str                       # lower-case
    args: Tuple[Node, ...]
    distinct: bool = False
    is_star: bool = False           # count(*)


@dataclass(frozen=True)
class WindowFrame(Node):
    """ROWS/RANGE BETWEEN <start> AND <end>. Bounds are one of
    'unbounded_preceding' | 'current_row' | 'unbounded_following'."""
    unit: str                       # 'rows' | 'range'
    start: str
    end: str


@dataclass(frozen=True)
class WindowFunc(Node):
    """fn(args) OVER (PARTITION BY ... ORDER BY ... [frame])
    (tree/WindowOperation + WindowSpecification in the reference parser)."""
    name: str                       # lower-case
    args: Tuple[Node, ...]
    is_star: bool                   # count(*) OVER ...
    partition_by: Tuple[Node, ...]
    order_by: Tuple["OrderItem", ...]
    frame: Optional[WindowFrame]


@dataclass(frozen=True)
class CastExpr(Node):
    arg: Node
    type_name: str                  # e.g. 'bigint', 'decimal(12,2)', 'date'


@dataclass(frozen=True)
class ExtractExpr(Node):
    part: str                       # 'year' | 'month' | 'day'
    arg: Node


@dataclass(frozen=True)
class CaseExpr(Node):
    operand: Optional[Node]         # simple CASE when not None
    whens: Tuple[Tuple[Node, Node], ...]
    default: Optional[Node]


# ---- relations ------------------------------------------------------------

@dataclass(frozen=True)
class TableRef(Node):
    name: Tuple[str, ...]           # possibly qualified
    alias: Optional[str] = None


@dataclass(frozen=True)
class SubqueryRef(Node):
    query: "Query"
    alias: str


@dataclass(frozen=True)
class UnnestRef(Node):
    """UNNEST(expr) [WITH ORDINALITY] [AS alias(col [, ord])] in FROM —
    a lateral expansion over the preceding relations (tree/Unnest.java)."""
    arg: Node
    alias: Optional[str] = None
    colnames: Optional[Tuple[str, ...]] = None
    ordinality: bool = False


@dataclass(frozen=True)
class ArrayLiteral(Node):
    """ARRAY[e1, e2, ...] (tree/ArrayConstructor.java)."""
    items: Tuple[Node, ...]


@dataclass(frozen=True)
class Join(Node):
    kind: str                       # 'inner'|'left'|'right'|'full'|'cross'
    left: Node
    right: Node
    condition: Optional[Node]       # ON expr (None for cross / comma)


# ---- query structure ------------------------------------------------------

@dataclass(frozen=True)
class SelectItem(Node):
    expr: Optional[Node]            # None for '*'
    alias: Optional[str] = None
    star_qualifier: Optional[Tuple[str, ...]] = None  # for t.*


@dataclass(frozen=True)
class OrderItem(Node):
    expr: Node
    ascending: bool = True
    nulls_first: Optional[bool] = None


@dataclass(frozen=True)
class Query(Node):
    select: Tuple[SelectItem, ...]
    distinct: bool
    relation: Optional[Node]        # table tree (None: SELECT without FROM)
    where: Optional[Node]
    group_by: Tuple[Node, ...]
    having: Optional[Node]
    order_by: Tuple[OrderItem, ...]
    limit: Optional[int]
    ctes: Tuple = ()                # WITH name AS (query), ...
    grouping_sets: Tuple = ()       # sets of indexes into group_by
                                    # (ROLLUP/CUBE/GROUPING SETS); empty =
                                    # single implicit full set


@dataclass(frozen=True)
class SetOp(Node):
    """UNION / INTERSECT / EXCEPT over two query bodies. ORDER BY / LIMIT
    attached here bind to the combined result (SqlBase.g4 queryNoWith:
    queryTerm (ORDER BY ...)? (LIMIT ...)?)."""
    op: str                         # 'union' | 'intersect' | 'except'
    all_rows: bool                  # ALL vs DISTINCT
    left: Node                      # Query | SetOp | Values
    right: Node
    order_by: Tuple[OrderItem, ...] = ()
    limit: Optional[int] = None
    ctes: Tuple = ()


@dataclass(frozen=True)
class Values(Node):
    """VALUES (row), (row), ... — an inline table (tree/Values.java)."""
    rows: Tuple[Tuple[Node, ...], ...]


@dataclass(frozen=True)
class ValuesRef(Node):
    """(VALUES ...) AS alias (col, ...) in a FROM clause."""
    values: Values
    alias: str
    column_names: Optional[Tuple[str, ...]] = None


@dataclass(frozen=True)
class Explain(Node):
    query: Node
    analyze: bool = False


@dataclass(frozen=True)
class ShowTables(Node):
    catalog: Optional[str] = None
    schema: Optional[str] = None


@dataclass(frozen=True)
class ShowCatalogs(Node):
    pass


@dataclass(frozen=True)
class ShowSchemas(Node):
    catalog: Optional[str] = None


@dataclass(frozen=True)
class ShowSession(Node):
    pass


@dataclass(frozen=True)
class ShowColumns(Node):
    """SHOW COLUMNS FROM t / DESCRIBE t (tree/ShowColumns.java)."""
    table: Tuple[str, ...]


@dataclass(frozen=True)
class SetSession(Node):
    name: str
    value: Node                     # literal


@dataclass(frozen=True)
class CreateTable(Node):
    """CREATE TABLE [AS query]; plain form takes (name, type) columns."""
    table: Tuple[str, ...]
    columns: Tuple = ()             # ((name, type_name), ...)
    query: Optional[Node] = None    # CTAS
    if_not_exists: bool = False


@dataclass(frozen=True)
class DropTable(Node):
    table: Tuple[str, ...]
    if_exists: bool = False


@dataclass(frozen=True)
class InsertInto(Node):
    table: Tuple[str, ...]
    query: Node                     # Query | Values


@dataclass(frozen=True)
class Update(Node):
    """UPDATE t SET c = expr, ... [WHERE pred]."""
    table: Tuple[str, ...]
    assignments: Tuple              # ((column_name, expr_ast), ...)
    where: Optional[Node]


@dataclass(frozen=True)
class Delete(Node):
    """DELETE FROM t [WHERE pred]."""
    table: Tuple[str, ...]
    where: Optional[Node]


@dataclass(frozen=True)
class MergeInto(Node):
    """MERGE INTO target [alias] USING source [alias] ON cond
    WHEN [NOT] MATCHED [AND cond] THEN UPDATE SET ... | DELETE |
    INSERT (...) VALUES (...).
    Clause order is significant (first matching clause wins, like the
    reference's MergeProcessorOperator row routing)."""
    target: Tuple[str, ...]
    target_alias: Optional[str]
    source: Node                    # relation AST (TableRef / derived)
    on: Node
    clauses: Tuple                  # tuple[MergeClause, ...]


@dataclass(frozen=True)
class MergeClause(Node):
    matched: bool
    condition: Optional[Node]       # the AND condition, if any
    action: str                     # 'update' | 'delete' | 'insert'
    assignments: Tuple = ()         # update: ((column_name, expr), ...)
    insert_columns: Tuple = ()      # insert: (column_name, ...)
    insert_values: Tuple = ()       # insert: (expr, ...)
