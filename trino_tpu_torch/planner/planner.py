"""Port copy of ``trino_tpu/planner/planner.py`` (no edits beyond the device-
layer import targets noted inline).

Logical planner: analyzed AST -> logical plan.

Reference: LogicalPlanner/QueryPlanner/RelationPlanner
(sql/planner/LogicalPlanner.java:231) plus the subset of optimizer behavior
that is load-bearing for TPC-H:

- predicate pushdown: WHERE conjuncts applied at the earliest relation where
  all referenced columns exist (PredicatePushDown.java's effect)
- join graph: comma/cross joins + equi-conjuncts assembled into a left-deep
  join tree in FROM order; probe/build orientation chosen so the build side
  is unique on its keys when provable from primary keys
  (DetermineJoinDistributionType.java:51's role, driven by PK metadata
  instead of stats for now)
- aggregate extraction: distinct aggregate calls become AggregateNode slots;
  AVG decomposes into SUM+COUNT with an exact finalizer projection
  (HashAggregationOperator PARTIAL/FINAL + AccumulatorCompiler's job)
- aggregation strategy choice: dense 'direct' when all keys are
  dictionary-coded with a small domain product, else 'sort'
  (GroupByHash.createGroupByHash's Bigint-vs-Flat decision, re-targeted)
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import ir
from ..batch import Field, Schema
from ..catalog import Catalog
from ..sql import ast_nodes as A
from ..types import (BIGINT, BOOLEAN, DOUBLE, VARCHAR, DataType, TypeKind,
                     common_super_type)
from . import logical as L
from .analyzer import (AGG_NAMES, VARIANCE_AGGS, AnalysisError,
                       ExpressionLowerer, Scope, ScopeColumn, ast_children,
                       contains_aggregate, date_literal, flip,
                       materialize_string, number_literal, parse_type)

from ..ops.aggregate import MAX_DIRECT_GROUPS  # dense-domain cutoff (64)

DEFAULT_SORT_GROUPS = 1 << 16    # sort-agg output capacity default
# HyperLogLog precision for approx_distinct: 2^12 registers gives ~1.6%
# standard error (inside the reference's 2.3% default,
# ApproximateCountDistinctAggregation.java's maxStandardError)
HLL_P = 12


def _scale_of(dtype) -> int:
    return dtype.scale if dtype is not None and \
        dtype.kind is TypeKind.DECIMAL else 0


def _remap_lut(lpool: tuple, rpool: tuple) -> tuple:
    """Per-code LUT translating rpool codes into lpool codes; -1 = the
    string is absent from lpool (matches no valid code)."""
    index = {s: j for j, s in enumerate(lpool)}
    return tuple(index.get(s, -1) for s in rpool)


@dataclass
class PlannedRelation:
    node: L.PlanNode
    scope: Scope


class Planner:
    def __init__(self, catalog: Catalog, default_catalog: str = "tpch",
                 default_schema: str = "tiny", properties=None):
        self.catalog = catalog
        self.default_catalog = default_catalog
        self.default_schema = default_schema
        self.properties = properties or {}
        self.ctes: Dict[str, A.Query] = {}   # WITH-bound names, lexically scoped
        # (from_node, from_scope, window_slots) of the latest plain select —
        # lets ORDER BY lower hidden sort expressions over the FROM scope
        self._plain_from: Optional[tuple] = None

    # ------------------------------------------------------------------
    # relations
    # ------------------------------------------------------------------

    def plan_table(self, ref: A.TableRef) -> PlannedRelation:
        parts = [p.lower() for p in ref.name]
        if len(parts) == 1 and parts[0] in self.ctes:
            # a CTE body must not see its own binding (non-recursive WITH)
            saved = self.ctes
            self.ctes = {k: v for k, v in self.ctes.items()
                         if k != parts[0]}
            try:
                sub = self.plan_query(saved[parts[0]])
            finally:
                self.ctes = saved
            return self.wrap_subplan(sub, (ref.alias or parts[0]).lower())
        if len(parts) == 3:
            cat, sch, tbl = parts
        elif len(parts) == 2:
            cat, (sch, tbl) = self.default_catalog, parts
        else:
            cat, sch, tbl = self.default_catalog, self.default_schema, \
                parts[0]
        data = self.catalog.get_table(cat, sch, tbl)
        schema: Schema = data.schema
        qualifier = (ref.alias or tbl).lower()
        output = tuple((f.name, f.dtype) for f in schema)
        node = L.ScanNode(cat, sch, tbl, schema,
                          tuple(range(len(schema.fields))), output)
        cols = [ScopeColumn(qualifier, f.name.lower(), f.dtype, i, f)
                for i, f in enumerate(schema.fields)]
        return PlannedRelation(node, Scope(cols))

    def wrap_subplan(self, sub: "PlannedRelation",
                     alias: str) -> PlannedRelation:
        """Embed a planned subquery/CTE as a relation under `alias`."""
        node = sub.node.child if isinstance(sub.node, L.OutputNode) \
            else sub.node
        cols = [ScopeColumn(alias, name.lower(), dtype, i, fld)
                for i, ((name, dtype), fld) in enumerate(
                    zip(node.output, sub_fields(sub)))]
        return PlannedRelation(node, Scope(cols))

    # ------------------------------------------------------------------
    # VALUES and set operations
    # ------------------------------------------------------------------

    def eval_const_ast(self, node: A.Node) -> ir.Literal:
        """Evaluate a constant VALUES cell at plan time (tree/Values.java
        rows are bound during analysis in the reference too)."""
        if isinstance(node, A.NumberLit):
            return number_literal(node.text)
        if isinstance(node, A.StringLit):
            return ir.Literal(node.value, VARCHAR)
        if isinstance(node, A.BoolLit):
            return ir.Literal(node.value, BOOLEAN)
        if isinstance(node, A.NullLit):
            return ir.Literal(None, None)
        if isinstance(node, A.DateLit):
            return date_literal(node.value)
        if isinstance(node, A.TimestampLit):
            from .analyzer import timestamp_literal
            return timestamp_literal(node.value)
        if isinstance(node, A.UnaryOp) and node.op == "-":
            lit = self.eval_const_ast(node.arg)
            if lit.value is None:
                return lit
            return ir.Literal(-lit.value, lit.dtype)
        if isinstance(node, A.BinaryOp) and node.op in "+-*":
            l = self.eval_const_ast(node.left)
            r = self.eval_const_ast(node.right)
            if l.dtype is not None and r.dtype is not None and \
                    l.dtype.kind is TypeKind.BIGINT and \
                    r.dtype.kind is TypeKind.BIGINT:
                v = {"+": lambda a, b: a + b, "-": lambda a, b: a - b,
                     "*": lambda a, b: a * b}[node.op](l.value, r.value)
                return ir.Literal(v, BIGINT)
        if isinstance(node, A.CastExpr):
            lit = self.eval_const_ast(node.arg)
            dst = parse_type(node.type_name)
            return ir.Literal(_convert_const(lit.value, lit.dtype, dst), dst)
        raise AnalysisError(
            f"unsupported constant expression in VALUES: "
            f"{type(node).__name__}")

    def plan_values_ref(self, ref: A.ValuesRef) -> PlannedRelation:
        rows = ref.values.rows
        arity = len(rows[0])
        for r in rows:
            if len(r) != arity:
                raise AnalysisError("VALUES rows have mixed column counts")
        cells = [[self.eval_const_ast(c) for c in r] for r in rows]
        names = [n.lower() for n in ref.column_names] \
            if ref.column_names else [f"_col{j}" for j in range(arity)]
        if ref.column_names and len(ref.column_names) != arity:
            raise AnalysisError("VALUES column alias count mismatch")

        arrays, valids, fields, output, cols = [], [], [], [], []
        alias = ref.alias.lower()
        for j in range(arity):
            col_lits = [row[j] for row in cells]
            dtype = None
            for lit in col_lits:
                if lit.dtype is None:
                    continue
                dtype = lit.dtype if dtype is None else \
                    common_super_type(dtype, lit.dtype)
            if dtype is None:
                dtype = BIGINT      # all-NULL column
            valid = np.array([lit.dtype is not None and lit.value is not None
                              for lit in col_lits], dtype=np.bool_)
            dictionary = None
            if dtype.kind is TypeKind.VARCHAR:
                # pool must be SORTED (code order == string order is the
                # engine-wide invariant sorts and min/max rely on)
                strings = [lit.value if lit.value is not None else ""
                           for lit in col_lits]
                pool = sorted(set(strings))
                index = {s: k for k, s in enumerate(pool)}
                data = np.asarray([index[s] for s in strings],
                                  dtype=dtype.np_dtype)
                dictionary = tuple(pool)
            else:
                data = np.asarray(
                    [_convert_const(lit.value, lit.dtype, dtype) or 0
                     for lit in col_lits], dtype=dtype.np_dtype)
            fld = Field(names[j], dtype, dictionary)
            arrays.append(data)
            valids.append(valid)
            fields.append(fld)
            output.append((names[j], dtype))
            cols.append(ScopeColumn(alias, names[j], dtype, j, fld))
        node = L.ValuesNode(tuple(arrays), tuple(valids), len(rows),
                            tuple(fields), tuple(output))
        return PlannedRelation(node, Scope(cols))

    def plan_values_statement(self, v: A.Values) -> PlannedRelation:
        rel = self.plan_values_ref(A.ValuesRef(v, "values"))
        names = tuple(n for n, _ in rel.node.output)
        out = L.OutputNode(rel.node, names, rel.node.output)
        return PlannedRelation(out, rel.scope)

    def plan_body(self, node: A.Node) -> PlannedRelation:
        """Plan a set-op operand to a relation (no OutputNode root)."""
        if isinstance(node, A.Values):
            return self.plan_values_ref(A.ValuesRef(node, "values"))
        sub = self.plan_query(node)
        return self.wrap_subplan(sub, "$setop")

    def plan_setop(self, q: A.SetOp) -> PlannedRelation:
        left = self.plan_body(q.left)
        right = self.plan_body(q.right)
        if len(left.node.output) != len(right.node.output):
            raise AnalysisError(
                f"set operation column count mismatch: "
                f"{len(left.node.output)} vs {len(right.node.output)}")
        left, right, out_fields, lremaps, rremaps = \
            self.align_setop(left, right)
        names = [c.name for c in left.scope.columns]
        output = tuple((nm, f.dtype) for nm, f in zip(names, out_fields))
        op = q.op + ("_all" if q.all_rows else "")
        node = L.SetOpNode(op, left.node, right.node, tuple(lremaps),
                           tuple(rremaps), output)
        cols = [ScopeColumn(None, nm, f.dtype, i, f)
                for i, (nm, f) in enumerate(zip(names, out_fields))]
        rel = PlannedRelation(node, Scope(cols))

        if q.order_by:
            keys = []
            for item in q.order_by:
                idx = self.resolve_setop_order(item.expr, names)
                nulls_first = item.nulls_first
                if nulls_first is None:
                    nulls_first = not item.ascending
                keys.append(L.SortKey(idx, item.ascending, nulls_first))
            rel = PlannedRelation(
                L.SortNode(rel.node, tuple(keys), q.limit, rel.node.output),
                rel.scope)
        elif q.limit is not None:
            rel = PlannedRelation(
                L.LimitNode(rel.node, q.limit, rel.node.output), rel.scope)
        out = L.OutputNode(rel.node, tuple(names), rel.node.output)
        return PlannedRelation(out, rel.scope)

    def resolve_setop_order(self, ast: A.Node, names: List[str]) -> int:
        if isinstance(ast, A.NumberLit) and "." not in ast.text:
            k = int(ast.text)
            if not (1 <= k <= len(names)):
                raise AnalysisError(f"ORDER BY ordinal {k} out of range")
            return k - 1
        if isinstance(ast, A.Identifier) and len(ast.parts) == 1:
            nm = ast.parts[0].lower()
            if nm in names:
                return names.index(nm)
        raise AnalysisError(
            "ORDER BY over a set operation must reference an output "
            "column name or ordinal")

    def align_setop(self, left: PlannedRelation, right: PlannedRelation):
        """Coerce both sides to common column types; merge VARCHAR
        dictionaries (right codes remap through the merged pool)."""
        lcols, rcols = left.scope.columns, right.scope.columns
        lcasts, rcasts, out_fields, lremaps, rremaps = [], [], [], [], []
        for i, (lc, rc) in enumerate(zip(lcols, rcols)):
            lt, rt = lc.dtype, rc.dtype
            if lt.kind is TypeKind.VARCHAR or rt.kind is TypeKind.VARCHAR:
                if lt.kind is not rt.kind:
                    raise AnalysisError(
                        "set operation mixes VARCHAR and non-VARCHAR")
                ld = lc.field.dictionary if lc.field else ()
                rd = rc.field.dictionary if rc.field else ()
                if ld == rd:
                    lremaps.append(None)
                    rremaps.append(None)
                    out_fields.append(Field(lc.name, lt, ld))
                else:
                    # merged pool is SORTED: the engine-wide invariant that
                    # dictionary code order == string order (ORDER BY and
                    # min/max on varchar sort codes directly) must survive
                    # the merge, so both sides get a remap LUT
                    merged = sorted(set(ld) | set(rd))
                    index = {s: k for k, s in enumerate(merged)}
                    lr = tuple(index[s] for s in ld)
                    rr = tuple(index[s] for s in rd)
                    lremaps.append(
                        None if lr == tuple(range(len(ld))) else lr)
                    rremaps.append(
                        None if rr == tuple(range(len(rd))) else rr)
                    out_fields.append(Field(lc.name, lt, tuple(merged)))
                lcasts.append(None)
                rcasts.append(None)
                continue
            try:
                target = common_super_type(lt, rt)
            except Exception:
                raise AnalysisError(
                    f"set operation type mismatch on column {i}: "
                    f"{lt} vs {rt}")
            lcasts.append(None if lt == target else target)
            rcasts.append(None if rt == target else target)
            out_fields.append(Field(lc.name, target, None))
            lremaps.append(None)
            rremaps.append(None)
        left = _cast_relation(left, lcasts)
        right = _cast_relation(right, rcasts)
        return left, right, out_fields, lremaps, rremaps

    def plan_relation_tree(self, rel: A.Node, unnests=None) \
            -> Tuple[List[PlannedRelation], List[A.Node]]:
        """Flatten the FROM tree into base relations + ON conjuncts.
        UNNEST items collect into `unnests` (lateral: they expand the
        combined preceding relations); passing None rejects them."""
        relations: List[PlannedRelation] = []
        conjuncts: List[A.Node] = []

        def walk(node: A.Node):
            if isinstance(node, A.UnnestRef):
                if unnests is None:
                    raise AnalysisError(
                        "UNNEST not supported in this position")
                unnests.append(node)
            elif isinstance(node, A.TableRef):
                relations.append(self.plan_table(node))
            elif isinstance(node, A.ValuesRef):
                relations.append(self.plan_values_ref(node))
            elif isinstance(node, A.SubqueryRef):
                sub = self.plan_query(node.query)
                relations.append(self.wrap_subplan(sub, node.alias.lower()))
            elif isinstance(node, A.Join):
                if node.kind not in ("inner", "cross", "left", "right",
                                     "full"):
                    raise AnalysisError(
                        f"{node.kind} join not yet supported")
                if node.kind in ("left", "right", "full"):
                    # outer joins keep tree structure: handled pairwise
                    left = self.combine_relations(*self.subtree(node.left))
                    right = self.combine_relations(*self.subtree(node.right))
                    planner = {"left": self.plan_left_join,
                               "right": self.plan_right_join,
                               "full": self.plan_full_join}[node.kind]
                    relations.append(planner(left, right, node.condition))
                    return
                walk(node.left)
                walk(node.right)
                if node.condition is not None:
                    split_conjuncts(node.condition, conjuncts)
            else:
                raise AnalysisError(
                    f"unsupported relation {type(node).__name__}")

        walk(rel)
        return relations, conjuncts

    def subtree(self, node: A.Node):
        rels, conj = self.plan_relation_tree(node)
        return rels, conj

    def combine_relations(self, relations, conjuncts) -> PlannedRelation:
        if len(relations) == 1 and not conjuncts:
            return relations[0]
        return self.build_join_tree(relations, list(conjuncts))

    # ------------------------------------------------------------------
    # join tree assembly
    # ------------------------------------------------------------------

    def build_join_tree(self, relations: List[PlannedRelation],
                        conjuncts: List[A.Node]) -> PlannedRelation:
        """Left-deep join tree; equi-conjuncts become join keys,
        single-relation conjuncts push down, leftovers become filters.

        Order: cost-driven greedy — start from the largest relation (it
        stays the probe side throughout) and at each step join the
        connected relation with the smallest estimated cardinality, so
        build sides stay small and selective dimensions reduce the probe
        early. This is the greedy core of Trino's ReorderJoins
        (iterative/rule/ReorderJoins.java:97) driven by the row-count /
        selectivity estimates in estimate_rows (cost/StatsCalculator's
        role)."""
        pending = [self.apply_local_filters(r, conjuncts)
                   for r in relations]
        if 2 < len(pending) <= self.DP_REORDER_MAX:
            planned = self._dp_reorder(pending, conjuncts)
            if planned is not None:
                return self._maybe_multijoin(planned)
        pending.sort(key=lambda r: -self.estimate_rows(r.node))
        acc = pending.pop(0)
        while pending:
            connected = [r for r in pending
                         if self.has_equi_edge(acc, r, conjuncts)]
            if not connected:
                # cross join (NestedLoopJoinOperator's role): join on a
                # synthesized constant key so the expansion kernel
                # produces the cartesian product — the common shape is
                # single-row aggregate subqueries placed side by side
                # (TPC-DS q28/q88)
                chosen = min(pending, key=lambda r:
                             self.estimate_rows(r.node))
                pending.remove(chosen)
                acc = self.cross_join_pair(acc, chosen)
                acc = self.apply_local_filters(acc, conjuncts)
                continue
            chosen = min(connected, key=lambda r:
                         self.join_output_estimate(acc, r, conjuncts))
            pending.remove(chosen)
            acc = self.join_pair(acc, chosen, conjuncts, kind="inner")
            acc = self.apply_local_filters(acc, conjuncts)
        return self._maybe_multijoin(acc)

    def _maybe_multijoin(self, rel: PlannedRelation) -> PlannedRelation:
        """Star detector (round 17): fuse the ladder's longest
        fact-to-dims prefix into a MultiJoinNode when the session allows
        it.  The rewrite is plan-shape only — the executor owns every
        runtime degrade back to the pairwise path."""
        # port: the K4 gate lives beside the port's hash kernels; `auto`
        # resolves on, as on the TPU, whatever the device
        from ..ops.hashtable import resolve_multiway_mode as resolve_mode
        setting = self.properties.get("enable_multiway_join", "auto")
        if resolve_mode(setting) == "off":
            return rel
        max_dims = int(self.properties.get("multiway_max_dims", 5))
        fused = L.fuse_star_joins(rel.node, max_dims)
        if fused is rel.node:
            return rel
        return PlannedRelation(fused, rel.scope)

    # cost-based join reordering explores all connected bushy splits up
    # to this many relations (2^n subsets; TPC-DS join graphs past ~10
    # relations fall back to the greedy order)
    DP_REORDER_MAX = 10

    def _dp_reorder(self, pending, conjuncts) -> \
            Optional[PlannedRelation]:
        """Cost-based bushy join reordering (ReorderJoins.java:97 /
        IterativeOptimizer's memo, reduced to a subset DP: each memo
        group is a relation subset; the winning split per group is the
        plan). Cardinalities come from stats.py NDVs with the standard
        independence assumption; cost = probe rows + 2x build rows +
        output rows per join, summed over the tree. Unlike the greedy
        left-deep order, a selective dimension can join a dimension
        FIRST (bushy build subtrees) — TPC-H q5's orders x customer build
        side is the canonical win. None = graph disconnected (caller's
        greedy handles cross joins) or no stats-resolvable edges."""
        n = len(pending)
        rows = [max(1.0, self.estimate_rows(r.node)) for r in pending]
        stats = [self.chain_column_stats(r.node) for r in pending]

        # edges[(i, j)] = [(denominator, uniq_i, uniq_j)] per conjunct:
        # denominator is the max-NDV cardinality reduction; uniq_* says
        # that side is provably unique on its end of the edge (the FK ->
        # unique-PK direction), which is what makes a dense single-key
        # build possible
        edges: Dict[Tuple[int, int], List[Tuple[float, bool, bool]]] = {}
        for c in conjuncts:
            eq = as_equi(c)
            if eq is None:
                continue
            a, b = eq
            for i in range(n):
                for j in range(i + 1, n):
                    for x, y in ((a, b), (b, a)):
                        ci = pending[i].scope.try_resolve(x)
                        cj = pending[j].scope.try_resolve(y)
                        if ci is None or cj is None:
                            continue
                        ndvs = [max(1.0, s.ndv) for s in (
                            stats[i].get(ci.index) if stats[i] else None,
                            stats[j].get(cj.index) if stats[j] else None)
                            if s is not None]
                        denom = max(ndvs) if ndvs else \
                            min(rows[i], rows[j])
                        edges.setdefault((i, j), []).append(
                            (max(1.0, denom),
                             self.is_unique(pending[i], [ci.index]),
                             self.is_unique(pending[j], [cj.index])))
                        break
        if not edges:
            return None

        def n1_closed(mask: int, anchor: int) -> bool:
            """True if every relation in `mask` is reachable from
            `anchor` via N:1 edges (each hop lands on a side unique on
            its edge column) — then the subset joined in anchor-rooted
            order has at most one row per anchor row, so it stays unique
            on anchor's keys."""
            seen = 1 << anchor
            grew = True
            while grew:
                grew = False
                for (i, j), metas in edges.items():
                    if not ((mask >> i) & 1 and (mask >> j) & 1):
                        continue
                    for _, ui, uj in metas:
                        if (seen >> i) & 1 and not (seen >> j) & 1 and uj:
                            seen |= 1 << j
                            grew = True
                        if (seen >> j) & 1 and not (seen >> i) & 1 and ui:
                            seen |= 1 << i
                            grew = True
            return seen & mask == mask

        def split_is_dense(a: int, b: int) -> bool:
            """A cross edge whose build end is unique AND whose build
            subset is N:1-closed from that end admits a single-key dense
            unique-build join (key minimization drops other edges)."""
            for probe_m, build_m in ((a, b), (b, a)):
                for (i, j), metas in edges.items():
                    for _, ui, uj in metas:
                        if (probe_m >> i) & 1 and (build_m >> j) & 1 \
                                and uj and n1_closed(build_m, j):
                            return True
                        if (probe_m >> j) & 1 and (build_m >> i) & 1 \
                                and ui and n1_closed(build_m, i):
                            return True
            return False

        def connected(mask: int) -> bool:
            first = (mask & -mask).bit_length() - 1
            seen = 1 << first
            frontier = [first]
            while frontier:
                u = frontier.pop()
                for v in range(n):
                    if not (mask >> v) & 1 or (seen >> v) & 1:
                        continue
                    e = (min(u, v), max(u, v))
                    if e in edges:
                        seen |= 1 << v
                        frontier.append(v)
            return seen == mask
        full = (1 << n) - 1
        if not connected(full):
            return None

        # per-subset cardinality: product of base rows over the standard
        # 1/max-NDV reduction for every internal equi edge — identical
        # for every split of the subset, so the DP is well-defined
        card: List[float] = [0.0] * (1 << n)
        for mask in range(1, 1 << n):
            est = 1.0
            for i in range(n):
                if (mask >> i) & 1:
                    est *= rows[i]
            for (i, j), metas in edges.items():
                if (mask >> i) & 1 and (mask >> j) & 1:
                    for d, _, _ in metas:
                        est /= d
            card[mask] = max(1.0, est)

        # probe work scales with the probe side's BATCH CAPACITY, which
        # stays at the largest base relation's size along the fact spine
        # (the chunked loop never compacts), not with the post-join
        # cardinality — cost probes by the dominant base row count
        maxbase = [0.0] * (1 << n)
        for mask in range(1, 1 << n):
            i = (mask & -mask).bit_length() - 1
            rest = mask ^ (1 << i)
            maxbase[mask] = max(rows[i], maxbase[rest])

        INF = float("inf")
        cost = [INF] * (1 << n)
        split: List[Optional[Tuple[int, int]]] = [None] * (1 << n)
        for i in range(n):
            cost[1 << i] = 0.0
        for mask in range(1, 1 << n):
            if mask & (mask - 1) == 0 or not connected(mask):
                continue
            # enumerate proper sub-splits (A, B); A keeps the lowest bit
            # so each unordered split is visited once
            low = mask & -mask
            sub = (mask - 1) & mask
            while sub:
                a, b = sub, mask ^ sub
                if (a & low) and cost[a] < INF and cost[b] < INF and \
                        any(((a >> i) & 1) != ((a >> j) & 1)
                            for (i, j) in edges
                            if (mask >> i) & 1 and (mask >> j) & 1):
                    if card[a] >= card[b]:
                        probe_m, build_m = a, b
                    else:
                        probe_m, build_m = b, a
                    probe_r = max(card[probe_m], maxbase[probe_m])
                    build_r = card[build_m]
                    # non-dense joins (multi-key or no unique build) run
                    # the sorted kernels — measured ~4-10x the dense
                    # LUT's gather cost on this backend, so weigh them
                    # out of contention unless nothing dense exists.
                    # Probe rows weigh 3x: every probe-side join costs
                    # 2-3 HBM gathers per probe row (the measured
                    # bottleneck), so folding dimensions into build
                    # subtrees (fewer fact-side joins) wins even when it
                    # grows the build a little.
                    factor = 1.0 if split_is_dense(a, b) else 6.0
                    c = cost[a] + cost[b] + \
                        factor * (3.0 * probe_r + 2.0 * build_r) + \
                        card[mask]
                    if c < cost[mask]:
                        cost[mask] = c
                        split[mask] = (a, b)
                sub = (sub - 1) & mask
            if split[mask] is None:
                return None       # connected mask with no connected
                                  # split: bail to the greedy order

        def rec(mask: int) -> PlannedRelation:
            if mask & (mask - 1) == 0:
                return pending[mask.bit_length() - 1]
            a, b = split[mask]
            # larger estimated side goes left (probe): join_pair flips
            # to the unique side for the build anyway, but left-ness
            # decides which side stays the streaming spine
            if card[a] < card[b]:
                a, b = b, a
            out = self.join_pair(rec(a), rec(b), conjuncts, kind="inner")
            return self.apply_local_filters(out, conjuncts)

        return rec(full)

    def join_output_estimate(self, acc: PlannedRelation,
                             r: PlannedRelation, conjuncts) -> float:
        """Estimated |acc join r| — the greedy reorder cost (the
        ReorderJoins objective reduced to output cardinality). With no
        key stats it degrades to the build-side row count (the round-1
        smallest-build heuristic)."""
        rows_r = self.estimate_rows(r.node)
        denom = None
        astats = self.chain_column_stats(acc.node)
        rstats = self.chain_column_stats(r.node)
        for c in conjuncts:
            eq = as_equi(c)
            if eq is None:
                continue
            a, b = eq
            for x, y in ((a, b), (b, a)):
                ca = acc.scope.try_resolve(x)
                cr = r.scope.try_resolve(y)
                if ca is None or cr is None:
                    continue
                ndvs = [max(1.0, s.ndv) for s in (
                    astats.get(ca.index) if astats else None,
                    rstats.get(cr.index) if rstats else None)
                    if s is not None]
                if ndvs:
                    m = max(ndvs)
                    denom = m if denom is None else max(denom, m)
        if denom is None:
            return rows_r
        rows_a = self.estimate_rows(acc.node)
        return max(1.0, rows_a * rows_r / denom)

    def plan_unnest(self, rel: PlannedRelation,
                    u: A.UnnestRef) -> PlannedRelation:
        """Lateral UNNEST over the combined preceding relations
        (tree/Unnest.java -> UnnestOperator.java:42)."""
        lowerer = ExpressionLowerer(rel.scope, planner=self)
        arg = lowerer.lower(u.arg)
        if arg.dtype.kind is not TypeKind.ARRAY:
            raise AnalysisError("UNNEST argument must be an array")
        fld = self.field_for(arg, rel.scope)
        if fld is None or fld.dictionary is None:
            raise AnalysisError("UNNEST array lost its element pool")
        node = rel.node
        if isinstance(arg, ir.ColumnRef):
            array_col = arg.index
        else:
            exprs = tuple(ir.ColumnRef(i, dt) for i, (_, dt)
                          in enumerate(node.output)) + (arg,)
            out = tuple(node.output) + (("$unnest_arr", arg.dtype),)
            node = L.ProjectNode(node, exprs, out)
            array_col = len(out) - 1

        elem_t = arg.dtype.element
        elem_name = (u.colnames[0] if u.colnames else "$unnest").lower()
        elem_pool = None
        if elem_t.kind is TypeKind.VARCHAR:
            elem_pool = tuple(sorted(
                {v for tup in fld.dictionary for v in tup
                 if v is not None}))
        output = tuple(node.output) + ((elem_name, elem_t),)
        if u.ordinality:
            ord_name = (u.colnames[1] if u.colnames and
                        len(u.colnames) > 1 else "ordinality").lower()
            output = output + ((ord_name, BIGINT),)
        unnest = L.UnnestNode(node, array_col, tuple(fld.dictionary),
                              elem_name, elem_t, elem_pool, u.ordinality,
                              output)
        alias = (u.alias or "$unnest").lower()
        n0 = len(node.output)
        cols = list(rel.scope.columns)
        elem_field = Field(elem_name, elem_t, dictionary=elem_pool)
        cols.append(ScopeColumn(alias, elem_name, elem_t, n0, elem_field))
        if u.ordinality:
            cols.append(ScopeColumn(alias, output[-1][0], BIGINT,
                                    n0 + 1, None))
        return PlannedRelation(unnest, Scope(cols))

    def cross_join_pair(self, left: PlannedRelation,
                        right: PlannedRelation) -> PlannedRelation:
        """Cartesian product via a constant-key equi-join: both sides gain
        a $ck=0 column; the expansion kernel's 1:N fan-out does the rest.
        The appended key columns stay out of the scope (like make_join's
        remapped varchar keys)."""
        zero = ir.Literal(0, BIGINT)

        def with_key(node: L.PlanNode):
            exprs = tuple(ir.ColumnRef(i, dt)
                          for i, (_, dt) in enumerate(node.output))
            out = tuple(node.output) + (("$ck", BIGINT),)
            return L.ProjectNode(node, exprs + (zero,), out), \
                len(node.output)

        pnode, pk = with_key(left.node)
        bnode, bk = with_key(right.node)
        out = tuple(pnode.output) + tuple(bnode.output)
        node = L.JoinNode("inner", pnode, bnode, (pk,), (bk,), None,
                          False, out)
        n_left = len(pnode.output)
        cols = list(left.scope.columns) + [
            ScopeColumn(c.qualifier, c.name, c.dtype, c.index + n_left,
                        c.field) for c in right.scope.columns]
        return PlannedRelation(node, Scope(cols))

    # ---- cardinality estimation (cost/StatsCalculator.java:22's role) --

    FILTER_SELECTIVITY = {"=": 0.05, "<>": 0.9, "<": 0.3, "<=": 0.3,
                          ">": 0.3, ">=": 0.3}

    def estimate_rows(self, node: L.PlanNode) -> float:
        if isinstance(node, L.ScanNode):
            stats = self.catalog.get_table_stats(
                node.catalog, node.schema_name, node.table)
            if stats is not None:
                return float(stats.row_count)
            return 1e6
        if isinstance(node, L.FilterNode):
            return self.estimate_rows(node.child) * \
                self.predicate_selectivity(
                    node.predicate, self.chain_column_stats(node.child))
        if isinstance(node, (L.ProjectNode, L.WindowNode, L.SortNode)):
            return self.estimate_rows(node.child)
        if isinstance(node, L.LimitNode):
            return min(float(node.count), self.estimate_rows(node.child))
        if isinstance(node, L.AggregateNode):
            if not node.group_keys:
                return 1.0
            child_rows = self.estimate_rows(node.child)
            ndv = self.group_ndv_product(node)
            if ndv is not None:
                return max(1.0, min(child_rows, ndv))
            return max(1.0, child_rows / 10)
        if isinstance(node, L.JoinNode):
            probe = self.estimate_rows(node.left)
            if node.kind in ("semi", "anti"):
                return probe * 0.5
            if node.kind == "mark":
                return probe
            build = self.estimate_rows(node.right)
            key_ndv = self.join_key_ndv(node)
            if key_ndv is not None and key_ndv > 0:
                # |L join R| ~= |L|*|R| / max(ndv) (JoinStatsRule)
                return max(1.0, probe * build / key_ndv)
            return probe if node.build_unique else probe * 2
        if isinstance(node, L.ValuesNode):
            return float(node.num_rows)
        if isinstance(node, L.SetOpNode):
            return self.estimate_rows(node.left) + \
                self.estimate_rows(node.right)
        return 1e6

    def chain_column_stats(self, node: L.PlanNode):
        """Per-output-column ColumnStats for Filter/Project/Join trees
        over scans (None where unknown). Joins concatenate probe++build
        column stats (NDVs are upper bounds post-join — callers cap by
        row estimates). The seam where connector statistics enter the
        cost model (spi/statistics -> FilterStatsCalculator)."""
        chain = []
        while isinstance(node, (L.FilterNode, L.ProjectNode)):
            chain.append(node)
            node = node.child
        if isinstance(node, L.JoinNode):
            left = self.chain_column_stats(node.left) or {}
            cur = dict(left)
            if node.kind in ("inner", "left"):
                right = self.chain_column_stats(node.right) or {}
                n_probe = len(node.left.output)
                for i, s in right.items():
                    cur[n_probe + i] = s
        elif isinstance(node, L.ScanNode):
            stats = self.catalog.get_table_stats(
                node.catalog, node.schema_name, node.table)
            if stats is None:
                return None
            cur = {}
            for i, ci in enumerate(node.column_indices):
                cur[i] = stats.columns.get(
                    node.table_schema.fields[ci].name)
        else:
            return None
        for nd in reversed(chain):
            if isinstance(nd, L.ProjectNode):
                cur = {i: cur.get(e.index)
                       if isinstance(e, ir.ColumnRef) else None
                       for i, e in enumerate(nd.exprs)}
        return cur

    def join_key_ndv(self, node: L.JoinNode):
        """max NDV across the equi-key pair (the join-size denominator)."""
        lstats = self.chain_column_stats(node.left)
        rstats = self.chain_column_stats(node.right)
        best = None
        for lk, rk in zip(node.left_keys, node.right_keys):
            ln = lstats.get(lk) if lstats else None
            rn = rstats.get(rk) if rstats else None
            ndvs = [s.ndv for s in (ln, rn) if s is not None]
            if ndvs:
                m = max(ndvs)
                best = m if best is None else max(best, m)
        return best

    def group_ndv_product(self, node: L.AggregateNode):
        cstats = self.chain_column_stats(node.child)
        if cstats is None:
            return None
        prod = 1.0
        for k in node.group_keys:
            s = cstats.get(k)
            if s is None:
                return None
            prod *= max(1.0, s.ndv)
        return prod

    def predicate_selectivity(self, pred: ir.Expr,
                              colstats=None) -> float:
        """Selectivities: dictionary predicates are near-exact (fraction
        of pool values passing); numeric comparisons interpolate against
        column min/max + NDV when stats are known, else fall back to the
        fixed heuristics (FilterStatsCalculator's structure)."""
        if isinstance(pred, ir.DictPredicate):
            if len(pred.lut) == 0:
                return 0.1
            return max(0.01, sum(pred.lut) / len(pred.lut))
        if isinstance(pred, ir.Compare):
            s = self._stats_compare_selectivity(pred, colstats)
            if s is not None:
                return s
            return self.FILTER_SELECTIVITY.get(pred.op, 0.33)
        if isinstance(pred, ir.Between):
            s = self._range_fraction(pred.arg, pred.low, pred.high,
                                     colstats)
            return s if s is not None else 0.25
        if isinstance(pred, ir.InList):
            cs = self._col_stats(pred.arg, colstats)
            if cs is not None and cs.ndv > 0:
                return min(1.0, len(pred.values) / cs.ndv)
            return min(0.9, 0.05 * len(pred.values))
        if isinstance(pred, ir.Logical):
            parts = [self.predicate_selectivity(a, colstats)
                     for a in pred.args]
            if pred.op == "and":
                out = 1.0
                for p in parts:
                    out *= p
                return out
            out = 0.0
            for p in parts:
                out = out + p - out * p
            return out
        if isinstance(pred, ir.Not):
            return 1.0 - self.predicate_selectivity(pred.arg, colstats)
        return 0.33

    @staticmethod
    def _col_stats(e: ir.Expr, colstats):
        if colstats is None or not isinstance(e, ir.ColumnRef):
            return None
        return colstats.get(e.index)

    def _stats_compare_selectivity(self, pred: ir.Compare, colstats):
        col, lit = pred.left, pred.right
        op = pred.op
        if isinstance(col, ir.Literal) and isinstance(lit, ir.ColumnRef):
            col, lit = lit, col
            op = flip(op)
        if not isinstance(lit, ir.Literal) or lit.value is None:
            return None
        cs = self._col_stats(col, colstats)
        if cs is None:
            return None
        if op == '=':
            return 1.0 / max(1.0, cs.ndv)
        if op == '<>':
            return 1.0 - 1.0 / max(1.0, cs.ndv)
        if cs.min_val is None or cs.max_val is None or \
                cs.max_val <= cs.min_val:
            return None
        try:
            v = float(lit.value)
            # column stats are over the stored (scaled-int) decimal
            # representation; normalize the literal to the column's scale
            v *= 10.0 ** (_scale_of(col.dtype) - _scale_of(lit.dtype))
        except (TypeError, ValueError):
            return None
        frac = (v - cs.min_val) / (cs.max_val - cs.min_val)
        frac = min(1.0, max(0.0, frac))
        return frac if op in ('<', '<=') else 1.0 - frac

    def _range_fraction(self, arg, low, high, colstats):
        cs = self._col_stats(arg, colstats)
        if cs is None or cs.min_val is None or cs.max_val is None or \
                cs.max_val <= cs.min_val or \
                not isinstance(low, ir.Literal) or \
                not isinstance(high, ir.Literal) or \
                low.value is None or high.value is None:
            return None
        try:
            ref = _scale_of(arg.dtype)
            lo = float(low.value) * 10.0 ** (ref - _scale_of(low.dtype))
            hi = float(high.value) * 10.0 ** (ref - _scale_of(high.dtype))
        except (TypeError, ValueError):
            return None
        span = cs.max_val - cs.min_val
        frac = (min(hi, cs.max_val) - max(lo, cs.min_val)) / span
        return min(1.0, max(0.0, frac))

    def has_equi_edge(self, left: PlannedRelation, right: PlannedRelation,
                      conjuncts: List[A.Node]) -> bool:
        for c in conjuncts:
            eq = as_equi(c)
            if eq is None:
                continue
            a, b = eq
            if (left.scope.try_resolve(a) and right.scope.try_resolve(b)) or \
               (left.scope.try_resolve(b) and right.scope.try_resolve(a)):
                return True
        return False

    def apply_local_filters(self, rel: PlannedRelation,
                            conjuncts: List[A.Node]) -> PlannedRelation:
        """Push down any pending conjunct fully resolvable in this scope."""
        applied = []
        preds = []
        for c in conjuncts:
            lowerer = ExpressionLowerer(rel.scope, planner=self)
            try:
                preds.append(lowerer.to_bool(lowerer.lower(c)))
                applied.append(c)
            except AnalysisError:
                continue
        for c in applied:
            conjuncts.remove(c)
        if not preds:
            return rel
        pred = preds[0] if len(preds) == 1 else ir.Logical(
            "and", tuple(preds))
        node = L.FilterNode(rel.node, pred, rel.node.output)
        return PlannedRelation(node, rel.scope)

    def join_pair(self, left: PlannedRelation, right: PlannedRelation,
                  conjuncts: List[A.Node], kind: str) -> PlannedRelation:
        """Extract equi-conjuncts linking left & right; orient probe/build."""
        left_keys: List[int] = []
        right_keys: List[int] = []
        used: List[A.Node] = []
        for c in conjuncts:
            eq = as_equi(c)
            if eq is None:
                continue
            a, b = eq
            la = left.scope.try_resolve(a)
            rb = right.scope.try_resolve(b)
            if la is not None and rb is not None:
                left_keys.append(la.index)
                right_keys.append(rb.index)
                used.append(c)
                continue
            lb = left.scope.try_resolve(b)
            ra = right.scope.try_resolve(a)
            if lb is not None and ra is not None:
                left_keys.append(lb.index)
                right_keys.append(ra.index)
                used.append(c)
        if not left_keys:
            raise AnalysisError(
                "cross join without equi-condition not yet supported")

        # Key minimization (inner joins): when several equi edges link the
        # two sides, using them ALL as join keys forces the multi-column
        # packed-key kernels (sorted path — no dense LUT). If ONE key pair
        # alone proves build uniqueness with a dense domain, join on just
        # that key and leave the other equalities in `conjuncts` — the
        # caller's apply_local_filters turns them into a (free) post-join
        # filter. TPC-H q5's c_custkey=o_custkey AND c_nationkey=
        # s_nationkey is the canonical shape: the nationkey equality
        # becomes a filter, keeping every join single-key dense.
        if kind == "inner" and len(left_keys) > 1:
            for j in range(len(left_keys)):
                for a, b, ak, bk in ((left, right, left_keys, right_keys),
                                     (right, left, right_keys, left_keys)):
                    if not self.is_unique(b, [bk[j]]):
                        continue
                    dom = self._dense_key_domain(
                        b.node, [bk[j]],
                        [self._scope_field(b.scope, bk[j])])
                    if dom is None:
                        continue
                    used = [used[j]]
                    left_keys = [left_keys[j]]
                    right_keys = [right_keys[j]]
                    break
                else:
                    continue
                break
        for c in used:
            conjuncts.remove(c)

        # orientation: build side should be unique on its keys if provable;
        # LEFT joins pin the preserved side as probe (no freedom)
        right_unique = self.is_unique(right, right_keys)
        left_unique = self.is_unique(left, left_keys)
        if kind == "left" or right_unique or not left_unique:
            probe, build = left, right
            probe_keys, build_keys = left_keys, right_keys
            build_unique = right_unique
        else:
            probe, build = right, left
            probe_keys, build_keys = right_keys, left_keys
            build_unique = left_unique

        node = self.make_join(
            kind, probe.node, build.node, probe_keys, build_keys, None,
            build_unique,
            probe_fields=[self._scope_field(probe.scope, i)
                          for i in probe_keys],
            build_fields=[self._scope_field(build.scope, i)
                          for i in build_keys])
        n_left = len(probe.node.output)
        cols = list(probe.scope.columns) + [
            ScopeColumn(c.qualifier, c.name, c.dtype, c.index + n_left,
                        c.field) for c in build.scope.columns]
        return PlannedRelation(node, Scope(cols))

    @staticmethod
    def _scope_field(scope: Scope, index: int) -> Optional[Field]:
        for c in scope.columns:
            if c.index == index:
                return c.field
        return None

    def make_join(self, kind: str, probe_node: L.PlanNode,
                  build_node: L.PlanNode, probe_keys, build_keys,
                  residual, build_unique: bool, *,
                  probe_fields, build_fields,
                  null_aware: bool = False) -> L.JoinNode:
        """THE JoinNode constructor: every join-building path funnels
        through here so varchar keys always get dictionary alignment.

        Codes only match within one pool; where a key pair is
        varchar-vs-varchar with differing pools, the build side gains an
        appended BIGINT key column remapping its codes into the probe pool
        (-1 = absent, matches no valid code) — the dictionary-aware twin
        of Trino's type-coerced join clauses."""
        probe_keys = list(probe_keys)
        build_keys = list(build_keys)
        build_key_domain = self._dense_key_domain(
            build_node, build_keys, build_fields)
        extra: List[ir.Expr] = []
        extra_cols: List[Tuple[str, DataType]] = []
        nb = len(build_node.output)
        for i, (pf, bf) in enumerate(zip(probe_fields, build_fields)):
            pk, bk0 = probe_keys[i], build_keys[i]
            p_varchar = probe_node.output[pk][1].kind is TypeKind.VARCHAR
            b_varchar = build_node.output[bk0][1].kind is TypeKind.VARCHAR
            if not (p_varchar and b_varchar):
                continue
            lpool = pf.dictionary if pf is not None else None
            rpool = bf.dictionary if bf is not None else None
            if lpool is None or rpool is None:
                # silent code-matching would be wrong — refuse loudly
                raise AnalysisError(
                    "varchar join key lost its dictionary; cannot align "
                    "pools")
            if lpool == rpool:
                continue
            bk = build_keys[i]
            dt = build_node.output[bk][1]
            extra.append(ir.DictValueMap(ir.ColumnRef(bk, dt),
                                         _remap_lut(lpool, rpool), BIGINT))
            extra_cols.append((f"$jk{len(extra_cols)}", BIGINT))
            build_keys[i] = nb + len(extra) - 1
        if extra:
            exprs = tuple(
                [ir.ColumnRef(j, dt) for j, (_, dt)
                 in enumerate(build_node.output)] + extra)
            build_node = L.ProjectNode(
                build_node, exprs,
                tuple(build_node.output) + tuple(extra_cols))
        if kind in ("inner", "left"):
            output = tuple(probe_node.output) + tuple(build_node.output)
        elif kind == "mark":
            # mark join: probe columns + the EXISTS truth column
            output = tuple(probe_node.output) + (("$mark", BOOLEAN),)
        else:
            output = tuple(probe_node.output)
        # DetermineJoinDistributionType.java:51's choice, by estimated
        # build bytes: small builds replicate over the mesh (all_gather),
        # large ones hash-repartition both sides (all_to_all). The
        # session can force either (join_distribution_type).
        forced = self.properties.get("join_distribution_type", "auto")
        if forced in ("broadcast", "partitioned"):
            distribution = forced
        elif kind != "inner" or residual is not None or null_aware:
            # only inner equi-joins can co-partition on the mesh today;
            # predicting "partitioned" for shapes the executor must
            # demote would make every EXPLAIN verdict a miss
            distribution = "broadcast"
        else:
            threshold_mb = self.properties.get(
                "broadcast_join_threshold_mb", 32)
            build_bytes = self.estimate_rows(build_node) * \
                max(1, len(build_node.output)) * 8
            distribution = "broadcast" \
                if build_bytes < (threshold_mb << 20) else "partitioned"
        if extra:
            build_key_domain = None    # remapped varchar keys can be -1
        return L.JoinNode(kind, probe_node, build_node,
                          tuple(probe_keys), tuple(build_keys), residual,
                          build_unique, output, null_aware=null_aware,
                          distribution=distribution,
                          build_key_domain=build_key_domain)

    # dense-LUT memory caps: absolute 2^30 entries (4GB of int32), and
    # 256x the build rows so only wildly sparse domains stay on the
    # sorted path. The sparsity cap is deliberately loose: scatter cost
    # is O(domain memset + rows) and probe cost is O(probe gathers) —
    # both independent of sparsity — so the only real cost of a sparse
    # LUT is HBM, and a measured 33M-probe dense join runs ~2s where the
    # sorted fallback takes ~60s. (A cost-reordered bushy build side is
    # often SMALL relative to its key domain — a 16x cap silently
    # knocked those joins off the dense path.)
    _DENSE_DOMAIN_CAP = 1 << 30

    def _dense_key_domain(self, build_node, build_keys, build_fields):
        """Static [0, domain) bound for a single build key, from exact
        connector min/max stats (integer keys) or the dictionary pool
        size (same-pool varchar keys)."""
        if len(build_keys) != 1:
            return None
        bk = build_keys[0]
        dt = build_node.output[bk][1]
        if dt.kind is TypeKind.VARCHAR:
            bf = build_fields[0]
            if bf is not None and bf.dictionary is not None:
                return max(1, len(bf.dictionary))
            return None
        if dt.kind not in (TypeKind.BIGINT, TypeKind.INTEGER,
                           TypeKind.DATE):
            return None
        cstats = self.chain_column_stats(build_node)
        s = cstats.get(bk) if cstats else None
        if s is None or s.min_val is None or s.min_val < 0:
            return None
        d = int(s.max_val) + 2
        rows = self.estimate_rows(build_node)
        if d > self._DENSE_DOMAIN_CAP or d > max(1 << 22, 256 * rows):
            return None
        return 1 << (d - 1).bit_length()      # pow2: stable jit cache

    def plan_left_join(self, left: PlannedRelation, right: PlannedRelation,
                       condition: Optional[A.Node]) -> PlannedRelation:
        conjuncts: List[A.Node] = []
        if condition is not None:
            split_conjuncts(condition, conjuncts)
        # ON conjuncts referencing only the build side filter the match
        # candidates, never the preserved side — push them into the build
        # input (Trino PredicatePushDown's inner-side pushdown for outer
        # joins). Preserved-side-only ON conjuncts cannot be pushed.
        right = self.apply_local_filters(right, conjuncts)
        rel = self.join_pair(left, right, conjuncts, kind="left")
        if conjuncts:
            raise AnalysisError("non-equi LEFT JOIN condition unsupported")
        return rel

    def plan_right_join(self, left: PlannedRelation,
                        right: PlannedRelation,
                        condition: Optional[A.Node]) -> PlannedRelation:
        """RIGHT JOIN = LEFT JOIN with sides swapped, re-projected back to
        (left columns, right columns) order (Trino's planner performs the
        same flip — there is no RIGHT at the operator level)."""
        rel = self.plan_left_join(right, left, condition)
        n_right = len(right.node.output)
        total = len(rel.node.output)
        perm = list(range(n_right, total)) + list(range(n_right))
        exprs = tuple(ir.ColumnRef(p, rel.node.output[p][1]) for p in perm)
        output = tuple(rel.node.output[p] for p in perm)
        node = L.ProjectNode(rel.node, exprs, output)
        new_pos = {old: new for new, old in enumerate(perm)}
        cols = sorted((ScopeColumn(c.qualifier, c.name, c.dtype,
                                   new_pos[c.index], c.field)
                       for c in rel.scope.columns),
                      key=lambda c: c.index)
        return PlannedRelation(node, Scope(cols))

    def plan_full_join(self, left: PlannedRelation,
                       right: PlannedRelation,
                       condition: Optional[A.Node]) -> PlannedRelation:
        """FULL JOIN = LEFT JOIN union-all (right rows with no match,
        NULL-padded on the left) — the lowering Trino reaches via
        LookupJoinOperator + LookupOuterOperator, expressed set-at-a-time."""
        conjuncts: List[A.Node] = []
        if condition is not None:
            split_conjuncts(condition, conjuncts)
        lj = self.join_pair(left, right, conjuncts, kind="left")
        if conjuncts:
            raise AnalysisError("non-equi FULL JOIN condition unsupported")
        # the left-join output may carry appended $jk alignment columns;
        # project back to the visible (left ++ right) layout for the union
        n_vis = len(left.node.output) + len(right.node.output)
        lj_node: L.PlanNode = lj.node
        if len(lj_node.output) != n_vis:
            lj_node = L.ProjectNode(
                lj_node,
                tuple(ir.ColumnRef(i, dt)
                      for i, (_, dt) in enumerate(lj_node.output[:n_vis])),
                tuple(lj_node.output[:n_vis]))
        # right rows with no left match (anti join, probe = right)
        conj2: List[A.Node] = []
        if condition is not None:
            split_conjuncts(condition, conj2)
        rk: List[int] = []
        lk: List[int] = []
        for c in list(conj2):
            eq = as_equi(c)
            if eq is None:
                continue
            a, b = eq
            ra, lb = right.scope.try_resolve(a), left.scope.try_resolve(b)
            if ra is not None and lb is not None:
                rk.append(ra.index)
                lk.append(lb.index)
                continue
            rb, la = right.scope.try_resolve(b), left.scope.try_resolve(a)
            if rb is not None and la is not None:
                rk.append(rb.index)
                lk.append(la.index)
        anti = self.make_join(
            "anti", right.node, left.node, tuple(rk), tuple(lk), None,
            False,
            probe_fields=[self._scope_field(right.scope, i) for i in rk],
            build_fields=[self._scope_field(left.scope, i) for i in lk])
        pad_exprs = tuple(
            [ir.Literal(None, dt) for _, dt in left.node.output] +
            [ir.ColumnRef(i, dt)
             for i, (_, dt) in enumerate(right.node.output)])
        pad = L.ProjectNode(anti, pad_exprs, lj_node.output)
        none_maps = (None,) * len(lj_node.output)
        full = L.SetOpNode("union_all", lj_node, pad, none_maps,
                           none_maps, lj_node.output)
        return PlannedRelation(full, lj.scope)

    def is_unique(self, rel: PlannedRelation, key_indices: List[int]) -> bool:
        return self.node_unique_on(rel.node, frozenset(key_indices))

    def node_unique_on(self, node: L.PlanNode, keys: frozenset) -> bool:
        """True if `node`'s output is provably unique on the given column
        positions. The planner's stand-in for Trino's stats-derived
        distinct-count reasoning (DetermineJoinDistributionType.java:51):
        primary keys at scans, propagated through filters, unique-build
        joins (probe multiplicity preserved) and aggregations (output is
        unique on its group keys)."""
        if isinstance(node, (L.FilterNode, L.SortNode, L.LimitNode)):
            return self.node_unique_on(node.child, keys)
        if isinstance(node, L.ProjectNode):
            mapped = set()
            for i in keys:
                e = node.exprs[i]
                if not isinstance(e, ir.ColumnRef):
                    return False
                mapped.add(e.index)
            return self.node_unique_on(node.child, frozenset(mapped))
        if isinstance(node, L.ScanNode):
            data = self.catalog.get_table(node.catalog, node.schema_name,
                                          node.table)
            if not data.primary_key:
                return False
            key_names = {node.output[i][0].lower() for i in keys}
            return set(k.lower() for k in data.primary_key) <= key_names
        if isinstance(node, L.JoinNode):
            if node.kind in ("inner", "left") and node.build_unique:
                n_probe = len(node.left.output)
                if all(i < n_probe for i in keys):
                    return self.node_unique_on(node.left, keys)
            if node.kind in ("semi", "anti"):
                return self.node_unique_on(node.left, keys)
            return False
        if isinstance(node, L.AggregateNode):
            n_group = len(node.group_keys)
            return set(range(n_group)) <= keys
        return False

    # ------------------------------------------------------------------
    # query planning
    # ------------------------------------------------------------------

    def plan_query(self, q) -> PlannedRelation:
        if isinstance(q, A.Values):
            return self.plan_values_statement(q)
        saved_ctes = self.ctes
        if q.ctes:
            self.ctes = dict(self.ctes)
            for name, cq in q.ctes:
                self.ctes[name.lower()] = cq
        try:
            if isinstance(q, A.SetOp):
                return self.plan_setop(q)
            return self.plan_query_body(q)
        finally:
            self.ctes = saved_ctes

    def plan_query_body(self, q: A.Query) -> PlannedRelation:
        unnests: List[A.UnnestRef] = []
        if q.relation is None:
            # SELECT without FROM: single-row zero-column input relation
            # (Trino: Query with an implicit single-row ValuesNode)
            relations, on_conjuncts = [PlannedRelation(
                L.ValuesNode((), (), 1, (), ()), Scope([]))], []
        else:
            relations, on_conjuncts = self.plan_relation_tree(q.relation,
                                                              unnests)
        if not relations and unnests:
            # FROM UNNEST(ARRAY[...]) alone: expand a single-row input
            relations = [PlannedRelation(
                L.ValuesNode((), (), 1, (), ()), Scope([]))]

        conjuncts: List[A.Node] = list(on_conjuncts)
        if q.where is not None:
            split_conjuncts(q.where, conjuncts)
        add_or_common_conjuncts(conjuncts)

        if len(relations) == 1:
            rel = self.apply_local_filters(relations[0], conjuncts)
        else:
            rel = self.build_join_tree(relations, conjuncts)
        for u in unnests:
            rel = self.plan_unnest(rel, u)
            rel = self.apply_local_filters(rel, conjuncts)
        # residual multi-relation predicates (e.g. q19's OR-of-blocks)
        # become filters over the joined scope
        rel = self.apply_local_filters(rel, conjuncts)
        # subquery predicates: decorrelate to semi/anti/aggregate joins
        # (the role of Trino's TransformCorrelated* / TransformUncorrelated*
        # iterative rules, sql/planner/iterative/rule/)
        progress = True
        while progress and conjuncts:
            progress = False
            for c in list(conjuncts):
                new_rel = self.plan_subquery_conjunct(rel, c)
                if new_rel is not None:
                    conjuncts.remove(c)
                    rel = self.apply_local_filters(new_rel, conjuncts)
                    progress = True
                    break
        if conjuncts:
            raise AnalysisError(
                f"unplaced predicate(s): {conjuncts}")

        has_agg = any(contains_aggregate(i.expr) for i in q.select
                      if i.expr is not None) or q.group_by or \
            (q.having is not None)

        if has_agg:
            rel, select_scope_exprs, names = self.plan_aggregation(q, rel)
        else:
            rel, select_scope_exprs, names = self.plan_plain_select(q, rel)

        # DISTINCT via group-by-all-columns (Trino rewrites the same way)
        if q.distinct:
            node = rel.node
            ncols = len(node.output)
            rel = PlannedRelation(
                L.AggregateNode(node, tuple(range(ncols)), (), "sort", (),
                                DEFAULT_SORT_GROUPS, node.output),
                rel.scope)

        # ORDER BY over the select output scope (+ alias resolution);
        # expressions not in the select list become hidden sort columns
        # appended to the projection and dropped after the sort (Trino's
        # PruneOrderByInAggregation / hidden-symbol ordering scheme)
        if q.order_by:
            plain_from = self._plain_from
            proj = rel.node
            lower_hidden = None
            if (not has_agg and not q.distinct and
                    isinstance(proj, L.ProjectNode) and
                    plain_from is not None and
                    plain_from[0] is proj.child):
                _, from_scope, wslots = plain_from
                lower_hidden = ExpressionLowerer(
                    from_scope, planner=self, window_slots=wslots).lower
            else:
                # aggregation: the post-agg rewrite closure lowers
                # ORDER BY expressions over (group keys, agg slots,
                # grouping() columns)
                post_agg = getattr(self, "_post_agg", None)
                if not q.distinct and post_agg is not None and \
                        post_agg[0] is rel.node:
                    lower_hidden = post_agg[1]
            can_hide = lower_hidden is not None
            idxs = []
            for item in q.order_by:
                try:
                    idx = self.resolve_order_expr(item.expr, q, rel, names)
                except AnalysisError:
                    if not can_hide:
                        raise
                    idx = None
                idxs.append(idx)
            if any(i is None for i in idxs):
                exprs = list(proj.exprs)
                out_cols = list(proj.output)
                for k, item in enumerate(q.order_by):
                    if idxs[k] is None:
                        e = materialize_string(lower_hidden(item.expr))
                        exprs.append(e)
                        out_cols.append((f"$sort{len(out_cols)}", e.dtype))
                        idxs[k] = len(out_cols) - 1
                base: L.PlanNode = L.ProjectNode(proj.child, tuple(exprs),
                                                 tuple(out_cols))
            else:
                base = rel.node
            keys = []
            for idx, item in zip(idxs, q.order_by):
                nulls_first = item.nulls_first
                if nulls_first is None:
                    nulls_first = not item.ascending   # Trino default
                keys.append(L.SortKey(idx, item.ascending, nulls_first))
            sorted_node: L.PlanNode = L.SortNode(base, tuple(keys), q.limit,
                                                 base.output)
            if base is not rel.node:      # drop hidden sort columns
                sorted_node = L.ProjectNode(
                    sorted_node,
                    tuple(ir.ColumnRef(i, dt)
                          for i, (_, dt) in enumerate(proj.output)),
                    proj.output)
            rel = PlannedRelation(sorted_node, rel.scope)
        elif q.limit is not None:
            rel = PlannedRelation(
                L.LimitNode(rel.node, q.limit, rel.node.output), rel.scope)

        out = L.OutputNode(rel.node, tuple(names), rel.node.output)
        return PlannedRelation(out, rel.scope)

    # ---- plain select -----------------------------------------------------

    def expand_star(self, q: A.Query, scope: Scope):
        items = []
        for item in q.select:
            if item.expr is None:
                qual = None
                if item.star_qualifier:
                    qual = item.star_qualifier[-1].lower()
                for c in scope.columns:
                    if qual is None or c.qualifier == qual:
                        items.append((A.Identifier((c.qualifier, c.name)),
                                      c.name))
            else:
                name = item.alias or default_name(item.expr)
                items.append((item.expr, name.lower()))
        return items

    def plan_plain_select(self, q: A.Query, rel: PlannedRelation):
        items = self.expand_star(q, rel.scope)

        # window functions: plan WindowNode(s) below the final projection
        wcalls: List[A.WindowFunc] = []
        for ast, _ in items:
            self.collect_windows(ast, wcalls)
        for o in q.order_by:
            self.collect_windows(o.expr, wcalls)
        window_slots: Dict[A.WindowFunc, ir.Expr] = {}
        wfields: Dict[A.WindowFunc, Optional[Field]] = {}
        scope = rel.scope
        if wcalls:
            wl = ExpressionLowerer(scope, planner=self)
            node, window_slots, wfields = self.plan_windows(
                rel.node, wcalls, wl.lower, scope)
            rel = PlannedRelation(node, scope)

        lowerer = ExpressionLowerer(scope, planner=self,
                                    window_slots=window_slots)
        exprs = []
        names = []
        out_cols = []
        new_scope = []
        for i, (ast, name) in enumerate(items):
            e = materialize_string(lowerer.lower(ast))
            exprs.append(e)
            names.append(name)
            out_cols.append((name, e.dtype))
            fld = self.field_for(e, scope)
            if fld is None and isinstance(ast, A.WindowFunc):
                fld = wfields.get(ast)
            new_scope.append(ScopeColumn(None, name, e.dtype, i, fld))
        node = L.ProjectNode(rel.node, tuple(exprs), tuple(out_cols))
        self._plain_from = (rel.node, scope, window_slots)
        return PlannedRelation(node, Scope(new_scope)), exprs, names

    # ---- window functions -------------------------------------------------

    WINDOW_NAMES = {"row_number", "rank", "dense_rank", "ntile", "lead",
                    "lag", "first_value", "last_value"} | AGG_NAMES

    def collect_windows(self, node: A.Node, out: List[A.WindowFunc]) -> None:
        if isinstance(node, A.WindowFunc):
            if node.name not in self.WINDOW_NAMES:
                raise AnalysisError(
                    f"unsupported window function {node.name}()")
            if node not in out:
                out.append(node)
            return                    # args of a window call have no windows
        for ch in ast_children(node):
            self.collect_windows(ch, out)

    @staticmethod
    def frame_mode(call: A.WindowFunc) -> str:
        """SQL frame -> kernel frame (ops/window.py FRAMES)."""
        if not call.order_by:
            return "partition"
        f = call.frame
        if f is None:
            return "range_running"    # SQL default frame
        kind = "rows" if f.unit == "rows" else "range"
        if f.start != "unbounded_preceding":
            # bounded frames: (ROWS|RANGE) BETWEEN p PRECEDING AND
            # (CURRENT ROW | f FOLLOWING) — FramedWindowFunction's role.
            # RANGE bounds are VALUE offsets over the single numeric
            # ORDER BY key (WindowOperator.java:70 frame semantics).
            if f.start.endswith("_preceding") and f.start[0].isdigit():
                p = int(f.start.split("_")[0])
            elif f.start == "current_row":
                p = 0
            else:
                raise AnalysisError(
                    "only UNBOUNDED PRECEDING, n PRECEDING or CURRENT "
                    "ROW frame starts are supported")
            if f.end == "current_row":
                fl = 0
            elif f.end.endswith("_following") and f.end[0].isdigit():
                fl = int(f.end.split("_")[0])
            else:
                raise AnalysisError(
                    f"unsupported {f.unit.upper()} frame end {f.end!r}")
            return f"{kind}_bounded:{p}:{fl}"
        if f.end == "current_row":
            return "rows_running" if f.unit == "rows" else "range_running"
        if f.end.endswith("_following") and f.end[0].isdigit():
            fl = int(f.end.split("_")[0])
            if f.unit != "rows":
                # UNBOUNDED PRECEDING .. v FOLLOWING by value
                return f"range_bounded:{(1 << 62)}:{fl}"
            # UNBOUNDED PRECEDING .. f FOLLOWING: bounded with a huge
            # preceding span (partition sizes are < 2^31)
            return f"rows_bounded:{(1 << 31) - 1}:{fl}"
        if f.end.endswith("_preceding") and f.end[0].isdigit():
            raise AnalysisError(
                "frames ending before CURRENT ROW are unsupported")
        return "partition"            # UNBOUNDED FOLLOWING

    def plan_windows(self, node: L.PlanNode, calls: List[A.WindowFunc],
                     lower, scope: Scope):
        """Plan window calls over `node`: a pass-through pre-projection
        adding window inputs, then one WindowNode per distinct
        (PARTITION BY, ORDER BY) group (Trino merges compatible
        specifications into shared WindowNodes the same way —
        MergeAdjacentWindows / PushdownWindow rules).

        Returns (new_node, slots {call -> ir.Expr over new output},
        fields {call -> Field or None}).
        """
        base_n = len(node.output)
        pre_exprs = [ir.ColumnRef(i, dt, nm)
                     for i, (nm, dt) in enumerate(node.output)]
        pre_cols = list(node.output)

        def add_input(e: ir.Expr) -> int:
            if isinstance(e, ir.ColumnRef) and e.index < base_n:
                return e.index        # bare column: pass-through slot
            for i, prev in enumerate(pre_exprs[base_n:]):
                if prev == e:         # structural dedup merges window groups
                    return base_n + i
            pre_exprs.append(e)
            pre_cols.append((f"$win{len(pre_cols)}", e.dtype))
            return len(pre_cols) - 1

        def const_int(ast: A.Node, what: str) -> int:
            e = lower(ast)
            if not isinstance(e, ir.Literal) or not isinstance(
                    e.value, (int, np.integer)):
                raise AnalysisError(f"{what} must be an integer literal")
            return int(e.value)

        groups: Dict[tuple, list] = {}
        records: Dict[A.WindowFunc, dict] = {}
        fields: Dict[A.WindowFunc, Optional[Field]] = {}
        for call in calls:
            part = tuple(add_input(lower(p)) for p in call.partition_by)
            okeys = []
            for o in call.order_by:
                idx = add_input(lower(o.expr))
                nf = o.nulls_first if o.nulls_first is not None \
                    else not o.ascending
                okeys.append(L.SortKey(idx, o.ascending, nf))
            rec = {"part": part, "order": tuple(okeys)}
            name, frame = call.name, self.frame_mode(call)
            if frame.startswith(("rows_bounded", "range_bounded")) and \
                    name not in ("sum", "count", "avg"):
                raise AnalysisError(
                    f"bounded ROWS/RANGE frames support sum/count/avg "
                    f"(not {name})")
            if frame.startswith("range_bounded"):
                # value-offset frames need ONE numeric sort key whose
                # comparisons the kernel's binary search can run on
                # int64 lanes (WindowOperator's RANGE frame contract);
                # DECIMAL keys scale the bound to unscaled units
                if len(okeys) != 1:
                    raise AnalysisError(
                        "RANGE frames with numeric bounds require "
                        "exactly one ORDER BY key")
                kdt = pre_cols[okeys[0].index][1]
                if kdt.kind is TypeKind.DECIMAL:
                    _, p_s, f_s = frame.split(":")
                    mul = 10 ** kdt.scale
                    cap = 1 << 62
                    frame = (f"range_bounded:"
                             f"{min(int(p_s) * mul, cap)}:"
                             f"{min(int(f_s) * mul, cap)}")
                elif kdt.kind not in (TypeKind.BIGINT, TypeKind.INTEGER,
                                      TypeKind.DATE):
                    raise AnalysisError(
                        "RANGE frame bounds require an integer-valued "
                        f"ORDER BY key (got {kdt.kind.name})")
            fields[call] = None
            if name in ("row_number", "rank", "dense_rank"):
                rec["specs"] = [L.WinSpecNode(name, None, frame, 1, None,
                                              name, BIGINT)]
            elif name == "ntile":
                if len(call.args) != 1:
                    raise AnalysisError("ntile takes one argument")
                k = const_int(call.args[0], "ntile bucket count")
                if k <= 0:
                    raise AnalysisError("ntile buckets must be positive")
                rec["specs"] = [L.WinSpecNode(name, None, frame, k, None,
                                              name, BIGINT)]
            elif name in ("lead", "lag"):
                if not 1 <= len(call.args) <= 3:
                    raise AnalysisError(f"{name} takes 1-3 arguments")
                arg = lower(call.args[0])
                off = const_int(call.args[1], f"{name} offset") \
                    if len(call.args) > 1 else 1
                if off < 0:
                    raise AnalysisError(f"{name} offset must be >= 0")
                default = None
                if len(call.args) > 2:
                    d = lower(call.args[2])
                    if not isinstance(d, ir.Literal):
                        raise AnalysisError(
                            f"{name} default must be a literal")
                    # rescale to the argument's representation (a DECIMAL
                    # default literal carries its own scale)
                    default = _convert_const(d.value, d.dtype, arg.dtype)
                slot = add_input(arg)
                fields[call] = self.field_for(arg, scope)
                if arg.dtype.kind is TypeKind.VARCHAR and \
                        default is not None:
                    raise AnalysisError(
                        f"{name} varchar default unsupported")
                rec["specs"] = [L.WinSpecNode(name, slot, frame, off,
                                              default, name, arg.dtype)]
            elif name in ("first_value", "last_value"):
                if len(call.args) != 1:
                    raise AnalysisError(f"{name} takes one argument")
                arg = lower(call.args[0])
                slot = add_input(arg)
                fields[call] = self.field_for(arg, scope)
                rec["specs"] = [L.WinSpecNode(name, slot, frame, 1, None,
                                              name, arg.dtype)]
            elif name == "count" and (call.is_star or not call.args):
                rec["specs"] = [L.WinSpecNode("count_star", None, frame, 1,
                                              None, "count", BIGINT)]
            else:                     # sum/count/min/max/avg aggregates
                if len(call.args) != 1:
                    raise AnalysisError(f"{name} takes one argument")
                arg = lower(call.args[0])
                t = arg.dtype
                if t.kind is TypeKind.VARCHAR and name in ("min", "max"):
                    raise AnalysisError(
                        f"window {name}() over varchar unsupported")
                slot = add_input(arg)
                if name == "avg":
                    rec["specs"] = [
                        L.WinSpecNode("sum", slot, frame, 1, None,
                                      "avg_sum", sum_type(t)),
                        L.WinSpecNode("count", slot, frame, 1, None,
                                      "avg_cnt", BIGINT)]
                    rec["avg_t"] = t
                elif name == "sum":
                    rec["specs"] = [L.WinSpecNode("sum", slot, frame, 1,
                                                  None, "sum", sum_type(t))]
                elif name == "count":
                    rec["specs"] = [L.WinSpecNode("count", slot, frame, 1,
                                                  None, "count", BIGINT)]
                else:
                    rec["specs"] = [L.WinSpecNode(name, slot, frame, 1,
                                                  None, name, t)]
            records[call] = rec
            groups.setdefault((part, rec["order"]), []).append(call)

        current: L.PlanNode = L.ProjectNode(node, tuple(pre_exprs),
                                            tuple(pre_cols))
        slots: Dict[A.WindowFunc, ir.Expr] = {}
        for (part, okeys), group_calls in groups.items():
            specs = []
            first_out = len(current.output)
            for call in group_calls:
                rec = records[call]
                out0 = first_out + len(specs)
                specs.extend(rec["specs"])
                if "avg_t" in rec:
                    t = rec["avg_t"]
                    sum_ref = ir.ColumnRef(out0, sum_type(t))
                    cnt_ref = ir.ColumnRef(out0 + 1, BIGINT)
                    if t.kind is TypeKind.DECIMAL:
                        slots[call] = ir.DecimalAvg(sum_ref, cnt_ref, t)
                    else:
                        slots[call] = ir.arith(
                            "/", ir.Cast(sum_ref, DOUBLE),
                            ir.Cast(cnt_ref, DOUBLE))
                else:
                    slots[call] = ir.ColumnRef(out0,
                                               rec["specs"][0].out_dtype)
            output = tuple(current.output) + tuple(
                (s.out_name, s.out_dtype) for s in specs)
            current = L.WindowNode(current, part, okeys, tuple(specs),
                                   output)
        return current, slots, fields

    def field_for(self, e: ir.Expr, scope: Scope):
        """Propagate dictionary fields through bare column projections,
        and through CASE when every branch shares one pool."""
        if isinstance(e, ir.DerivedDict):
            return Field("$derived", e.dtype, dictionary=e.pool)
        if isinstance(e, ir.ArrayConst):
            return Field("$array", e.dtype, dictionary=e.pool)
        if isinstance(e, ir.Literal) and e.dtype is not None and \
                e.dtype.kind is TypeKind.VARCHAR:
            return Field("$literal", e.dtype, dictionary=(e.value,))
        if isinstance(e, ir.ColumnRef) and \
                e.dtype.kind in (TypeKind.VARCHAR, TypeKind.ARRAY):
            for c in scope.columns:
                if c.index == e.index and c.dtype.kind is e.dtype.kind:
                    return c.field
        if isinstance(e, ir.Case) and e.dtype.kind is TypeKind.VARCHAR:
            branches = [v for _, v in e.whens]
            if e.default is not None:
                branches.append(e.default)
            fields = [self.field_for(b, scope) for b in branches]
            pools = {f.dictionary for f in fields if f is not None}
            if len(fields) == len(branches) and len(pools) == 1 and \
                    all(f is not None for f in fields):
                return fields[0]
        return None

    # ---- aggregation ------------------------------------------------------

    def plan_aggregation(self, q: A.Query, rel: PlannedRelation):
        scope = rel.scope
        lowerer = ExpressionLowerer(scope)

        group_asts = list(q.group_by)
        group_irs = [lowerer.lower(resolve_ordinal(g, q)) for g in group_asts]

        # collect distinct aggregate calls across select/having/order
        agg_calls: List[A.FunctionCall] = []

        def collect(node: A.Node):
            if isinstance(node, A.FunctionCall) and node.name in AGG_NAMES:
                if node not in agg_calls:
                    agg_calls.append(node)
                return
            for ch in ast_children(node):
                collect(ch)

        for item in q.select:
            if item.expr is not None:
                collect(item.expr)
        if q.having is not None:
            collect(q.having)
        for o in q.order_by:
            collect(o.expr)

        # pre-projection: group keys then agg args
        pre_exprs: List[ir.Expr] = list(group_irs)
        pre_cols: List[Tuple[str, DataType]] = [
            (f"gk{i}", e.dtype) for i, e in enumerate(group_irs)]
        agg_specs: List[L.AggSpecNode] = []
        # map from agg call -> (post-agg expression builder)
        call_slots: Dict[A.FunctionCall, Tuple[str, int, int]] = {}

        def add_arg(e: ir.Expr) -> int:
            # reuse identical pre-projection expressions: DISTINCT
            # aggregates over the same argument must share one sort
            # column (count(DISTINCT x) + approx_distinct(x))
            for i, prev in enumerate(pre_exprs):
                if prev == e:
                    return i
            pre_exprs.append(e)
            pre_cols.append((f"a{len(pre_exprs)}", e.dtype))
            return len(pre_exprs) - 1

        n_keys = len(group_irs)
        distinct_args: List[int] = []
        # approx_distinct -> HLL relational rewrite (below): each entry
        # is (call, bucket_slot, rho_slot). Grouping sets keep the exact
        # sort-distinct lowering (the rewrite would have to replicate
        # per grouping set).
        hll_calls: List[tuple] = []
        dsum_types: Dict[A.FunctionCall, DataType] = {}
        # a DISTINCT sum/count shares the sort kernel's dedup column; the
        # HLL rewrite can't carry it through the (keys, bucket) inner
        # grouping, so approx_distinct degrades to exact sort-distinct
        # whenever one is present
        any_exact_distinct = any(
            c.distinct and c.name in ("sum", "count") for c in agg_calls)
        for call in agg_calls:
            if call.distinct and call.name == "avg":
                raise AnalysisError("avg(DISTINCT) not yet supported")
            if call.is_star or (call.name == "count" and not call.args):
                agg_specs.append(L.AggSpecNode("count_star", None,
                                               "count", BIGINT))
                call_slots[call] = ("plain", len(agg_specs) - 1, -1)
                continue
            if len(call.args) != 1:
                raise AnalysisError(f"{call.name} takes one argument")
            arg = lowerer.lower(call.args[0])
            if call.name == "approx_distinct" and not q.grouping_sets \
                    and not any_exact_distinct:
                b_slot = add_arg(ir.ScalarFunc(
                    "$hll_bucket", (arg,), BIGINT, (HLL_P,)))
                r_slot = add_arg(ir.ScalarFunc(
                    "$hll_rho", (arg,), BIGINT, (HLL_P,)))
                hll_calls.append((call, b_slot, r_slot))
                continue
            slot = add_arg(arg)
            t = arg.dtype
            # min/max DISTINCT == plain min/max; sum/count DISTINCT need
            # the sort kernel's duplicate-elimination (one distinct column
            # per aggregation, enforced below)
            distinct = (call.distinct and call.name in ("sum", "count")) \
                or call.name == "approx_distinct"
            if distinct:
                distinct_args.append(slot)
                if len(set(distinct_args)) > 1:
                    raise AnalysisError(
                        "multiple DISTINCT aggregate arguments unsupported")
            if call.name in ("count", "approx_distinct"):
                agg_specs.append(L.AggSpecNode("count", ir.ColumnRef(
                    slot, t), "count", BIGINT, distinct))
                call_slots[call] = ("plain", len(agg_specs) - 1, -1)
            elif call.name in ("bool_and", "bool_or", "every"):
                if t.kind is not TypeKind.BOOLEAN:
                    raise AnalysisError(f"{call.name} requires a boolean")
                # AND == min over {0,1}; OR == max (BooleanAndAggregation)
                b_slot = add_arg(ir.Cast(arg, BIGINT))
                fn = "max" if call.name == "bool_or" else "min"
                agg_specs.append(L.AggSpecNode(
                    fn, ir.ColumnRef(b_slot, BIGINT), call.name, BIGINT))
                call_slots[call] = ("bool", len(agg_specs) - 1, -1)
            elif call.name in ("min", "max"):
                agg_specs.append(L.AggSpecNode(call.name, ir.ColumnRef(
                    slot, t), call.name, t))
                call_slots[call] = ("plain", len(agg_specs) - 1, -1)
            elif call.name == "sum":
                out_t = sum_type(t)
                if t.kind is TypeKind.DECIMAL and not distinct and \
                        not q.grouping_sets:
                    # two-limb accumulation (see ops/project.py
                    # $limb_hi): the states are plain int64 sums, so
                    # chunked/distributed merging needs no new machinery
                    hi_slot = add_arg(ir.ScalarFunc(
                        "$limb_hi", (arg,), BIGINT))
                    lo_slot = add_arg(ir.ScalarFunc(
                        "$limb_lo", (arg,), BIGINT))
                    agg_specs.append(L.AggSpecNode(
                        "sum", ir.ColumnRef(hi_slot, BIGINT), "$dshi",
                        BIGINT))
                    agg_specs.append(L.AggSpecNode(
                        "sum", ir.ColumnRef(lo_slot, BIGINT), "$dslo",
                        BIGINT))
                    call_slots[call] = ("dsum", len(agg_specs) - 2,
                                        len(agg_specs) - 1)
                    dsum_types[call] = out_t
                    continue
                agg_specs.append(L.AggSpecNode("sum", ir.ColumnRef(slot, t),
                                               "sum", out_t, distinct))
                call_slots[call] = ("plain", len(agg_specs) - 1, -1)
            elif call.name == "avg":
                out_t = t if t.kind is TypeKind.DECIMAL else DOUBLE
                agg_specs.append(L.AggSpecNode("sum", ir.ColumnRef(slot, t),
                                               "avg_sum", sum_type(t)))
                agg_specs.append(L.AggSpecNode("count", ir.ColumnRef(
                    slot, t), "avg_cnt", BIGINT))
                call_slots[call] = ("avg", len(agg_specs) - 2,
                                    len(agg_specs) - 1)
            elif call.name in VARIANCE_AGGS:
                # decompose to (sum x², sum x, count x) in DOUBLE; the
                # finalizer divides/sqrt's post-aggregation (Trino's
                # VarianceState accumulators)
                x = ir.Cast(arg, DOUBLE) \
                    if t.kind is not TypeKind.DOUBLE else arg
                x_slot = add_arg(x)
                sq_slot = add_arg(ir.arith("*", x, x))
                agg_specs.append(L.AggSpecNode(
                    "sum", ir.ColumnRef(sq_slot, DOUBLE), "var_sq",
                    DOUBLE))
                agg_specs.append(L.AggSpecNode(
                    "sum", ir.ColumnRef(x_slot, DOUBLE), "var_sum",
                    DOUBLE))
                agg_specs.append(L.AggSpecNode(
                    "count", ir.ColumnRef(x_slot, DOUBLE), "var_cnt",
                    BIGINT))
                call_slots[call] = ("var", len(agg_specs) - 3,
                                    len(agg_specs) - 2)

        pre_node = L.ProjectNode(rel.node, tuple(pre_exprs),
                                 tuple(pre_cols))

        # grouping() calls (sql/analyzer's GroupingOperationRewriter role):
        # each call's value is branch-static per grouping set, so the
        # grouping-sets planner appends one literal column per call
        grouping_calls: List[A.FunctionCall] = []
        for item in q.select:
            if item.expr is not None:
                collect_grouping_calls(item.expr, grouping_calls)
        if q.having is not None:
            collect_grouping_calls(q.having, grouping_calls)
        for ob in q.order_by:
            collect_grouping_calls(ob.expr, grouping_calls)
        grouping_specs = []
        for call in grouping_calls:
            idxs = []
            for a in call.args:
                for i, g_ast in enumerate(group_asts):
                    if ast_equal(a, g_ast, q):
                        idxs.append(i)
                        break
                else:
                    raise AnalysisError(
                        "grouping() arguments must be grouping keys")
            grouping_specs.append(tuple(idxs))

        agg_out = tuple(
            [(f"gk{i}", e.dtype) for i, e in enumerate(group_irs)] +
            [(s.out_name, s.out_dtype) for s in agg_specs] +
            ([(f"$grouping{i}", BIGINT)
              for i in range(len(grouping_specs))]
             if q.grouping_sets else []))
        if q.grouping_sets:
            agg_node = self.plan_grouping_sets(
                q.grouping_sets, pre_node, group_irs, agg_specs, scope,
                agg_out, bool(distinct_args),
                grouping_specs=tuple(grouping_specs))
        elif hll_calls:
            agg_node, agg_specs = self.plan_hll_aggregation(
                q, pre_node, group_irs, agg_specs, scope, hll_calls,
                call_slots, distinct_args)
            agg_out = tuple(
                [(f"gk{i}", e.dtype) for i, e in enumerate(group_irs)] +
                [(s.out_name, s.out_dtype) for s in agg_specs])
        else:
            strategy, domains, capacity = self.agg_strategy(
                group_irs, scope, pre_node,
                any_distinct=bool(distinct_args))
            agg_node = L.AggregateNode(
                pre_node, tuple(range(n_keys)), tuple(agg_specs),
                strategy, domains, capacity, agg_out)

        # post-projection scope: group keys (referencing original key ASTs)
        # then aggregate slots
        post_scope_cols = []
        for i, (g_ast, g_ir) in enumerate(zip(group_asts, group_irs)):
            fld = self.field_for(g_ir, scope)
            post_scope_cols.append(ScopeColumn(None, f"gk{i}", g_ir.dtype,
                                               i, fld))
        post_scope = Scope(post_scope_cols)

        window_slots: Dict[A.WindowFunc, ir.Expr] = {}
        planner_self = self

        class _PostAggLowerer(ExpressionLowerer):
            """Lowers select/having/order expressions over the aggregation
            output: group-key ASTs match syntactically (like Trino),
            aggregate calls resolve to their output slots, everything else
            (BETWEEN, IN, CASE, scalar functions, subqueries, ...) falls
            through to the full expression lowerer against the post-agg
            scope."""

            def lower(inner, node: A.Node) -> ir.Expr:
                for i, g_ast in enumerate(group_asts):
                    if ast_equal(node, g_ast, q):
                        c = post_scope.columns[i]
                        return ir.ColumnRef(c.index, c.dtype, c.name)
                if isinstance(node, A.FunctionCall) and \
                        node.name == "grouping":
                    if not q.grouping_sets:
                        return ir.Literal(0, BIGINT)
                    for gi, gcall in enumerate(grouping_calls):
                        if gcall is node or ast_equal(node, gcall, q):
                            return ir.ColumnRef(
                                n_keys + len(agg_specs) + gi, BIGINT)
                    raise AnalysisError("grouping() call not analyzed")
                if isinstance(node, A.FunctionCall) and \
                        node.name in AGG_NAMES:
                    kind, s1, s2 = call_slots[node]
                    if kind == "plain":
                        spec = agg_specs[s1]
                        return ir.ColumnRef(n_keys + s1, spec.out_dtype)
                    if kind == "hll":
                        # finisher over (V = occupied registers,
                        # S = sum 2^-rho) — see plan_hll_aggregation
                        from ..types import DOUBLE as _D
                        return ir.ScalarFunc(
                            "$hll_est",
                            (ir.ColumnRef(n_keys + s1, BIGINT),
                             ir.ColumnRef(n_keys + s2, _D)),
                            BIGINT, (1 << HLL_P,))
                    if kind == "dsum":
                        # two-limb decimal sum combine: hi*2^32 + lo on
                        # RAW unscaled ints (Arith's decimal coercions
                        # must not rescale limbs), exact while
                        # |total| < 2^63 (Int128State's role)
                        hi = ir.ColumnRef(n_keys + s1, BIGINT)
                        lo = ir.ColumnRef(n_keys + s2, BIGINT)
                        return ir.ScalarFunc(
                            "$limb_combine", (hi, lo), dsum_types[node])
                    if kind == "bool":
                        return ir.Compare(
                            "=", ir.ColumnRef(n_keys + s1, BIGINT),
                            ir.Literal(1, BIGINT))
                    if kind == "var":
                        # finalize variance family from (Σx², Σx, n):
                        # m2 = Σx² - (Σx)²/n; var_pop = m2/n,
                        # var_samp = m2/(n-1); n-1 = 0 divides to NULL
                        sq = ir.ColumnRef(n_keys + s1, DOUBLE)
                        sm = ir.ColumnRef(n_keys + s2, DOUBLE)
                        n_ref = ir.Cast(ir.ColumnRef(n_keys + s2 + 1,
                                                     BIGINT), DOUBLE)
                        m2_raw = ir.arith("-", sq, ir.arith(
                            "/", ir.arith("*", sm, sm), n_ref))
                        # clamp tiny negative fp residue so sqrt stays
                        # defined (Trino's accumulators never go negative)
                        zero = ir.Literal(0.0, DOUBLE)
                        m2 = ir.Case(
                            ((ir.Compare('<', m2_raw, zero), zero),),
                            m2_raw, DOUBLE)
                        name = node.name
                        if name in ("variance", "var_samp", "stddev",
                                    "stddev_samp"):
                            denom = ir.arith("-", n_ref,
                                             ir.Literal(1.0, DOUBLE))
                        else:
                            denom = n_ref
                        var = ir.arith("/", m2, denom)
                        if name.startswith("stddev"):
                            return ir.ScalarFunc("sqrt", (var,), DOUBLE)
                        return var
                    sum_ref = ir.ColumnRef(n_keys + s1,
                                           agg_specs[s1].out_dtype)
                    cnt_ref = ir.ColumnRef(n_keys + s2, BIGINT)
                    arg_t = agg_specs[s1].arg.dtype
                    if arg_t.kind is TypeKind.DECIMAL:
                        return ir.DecimalAvg(sum_ref, cnt_ref, arg_t)
                    return ir.arith("/", ir.Cast(sum_ref, DOUBLE),
                                    ir.Cast(cnt_ref, DOUBLE))
                if isinstance(node, A.Identifier):
                    col = post_scope.try_resolve(node.parts)
                    if col is None:
                        raise AnalysisError(
                            f"column {'.'.join(node.parts)} must appear "
                            f"in GROUP BY")
                return super().lower(node)

        rewrite = _PostAggLowerer(post_scope, planner=planner_self,
                                  window_slots=window_slots).lower

        items = []
        for item in q.select:
            if item.expr is None:
                raise AnalysisError("* not allowed with GROUP BY")
            name = (item.alias or default_name(item.expr)).lower()
            items.append((item.expr, name))

        current: L.PlanNode = agg_node
        if q.having is not None:
            pred = rewrite(q.having)
            current = L.FilterNode(current, pred, current.output)

        # windows over the aggregated output (sum(sum(x)) OVER (...) etc.);
        # ORDER BY windows must match a select item (there is no hidden-
        # sort-column path through aggregation), so only items are scanned
        wcalls: List[A.WindowFunc] = []
        for ast, _ in items:
            self.collect_windows(ast, wcalls)
        wfields: Dict[A.WindowFunc, Optional[Field]] = {}
        if wcalls:
            current, slots, wfields = self.plan_windows(
                current, wcalls, rewrite, post_scope)
            window_slots.update(slots)

        post_exprs = []
        names = []
        out_cols = []
        final_scope = []
        for i, (ast, name) in enumerate(items):
            e = materialize_string(rewrite(ast))
            post_exprs.append(e)
            names.append(name)
            out_cols.append((name, e.dtype))
            fld = None
            if isinstance(e, ir.ColumnRef) and e.index < n_keys:
                fld = post_scope.columns[e.index].field
            if fld is None and isinstance(ast, A.WindowFunc):
                fld = wfields.get(ast)
            if fld is None:
                # literal tags ('s' AS sale_type) and derived dictionary
                # expressions keep their pools through aggregation
                fld = self.field_for(e, post_scope)
            final_scope.append(ScopeColumn(None, name, e.dtype, i, fld))

        post_node = L.ProjectNode(current, tuple(post_exprs),
                                  tuple(out_cols))
        # ORDER BY may reference aggregation-scope expressions not in the
        # select list (e.g. CASE over grouping() keys); keep the rewrite
        # closure so the caller can lower them as hidden sort columns
        self._post_agg = (post_node, rewrite)
        return (PlannedRelation(post_node, Scope(final_scope)),
                post_exprs, names)

    def plan_grouping_sets(self, sets, pre_node, group_irs, agg_specs,
                           scope, agg_out, any_distinct,
                           grouping_specs=()) -> L.PlanNode:
        """ROLLUP/CUBE/GROUPING SETS: one aggregation per set over the
        shared pre-projection, aligned to the full key layout with NULL
        padding, concatenated with UNION ALL (the role of Trino's
        GroupIdOperator + single pass, expressed set-at-a-time — each
        branch still runs as one fused device program)."""
        n_keys = len(group_irs)
        branches = []
        for set_idxs in sets:
            set_idxs = tuple(set_idxs)
            sub_irs = [group_irs[i] for i in set_idxs]
            strategy, domains, capacity = self.agg_strategy(
                sub_irs, scope, pre_node, any_distinct=any_distinct)
            sub_out = tuple(
                [(f"gk{i}", group_irs[i].dtype) for i in set_idxs] +
                [(s.out_name, s.out_dtype) for s in agg_specs])
            node = L.AggregateNode(pre_node, set_idxs, tuple(agg_specs),
                                   strategy, domains, capacity, sub_out)
            # align to the full (gk0..gkN, aggs) layout with NULL keys
            pos = {k: j for j, k in enumerate(set_idxs)}
            exprs = []
            for i, g in enumerate(group_irs):
                if i in pos:
                    exprs.append(ir.ColumnRef(pos[i], g.dtype))
                else:
                    exprs.append(ir.Literal(None, g.dtype))
            for j, s in enumerate(agg_specs):
                exprs.append(ir.ColumnRef(len(set_idxs) + j, s.out_dtype))
            # grouping() literals: bit j set = the call's j-th argument is
            # aggregated away in this set (spi semantics of grouping())
            in_set = set(set_idxs)
            for arg_idxs in grouping_specs:
                v = 0
                for j, gi in enumerate(arg_idxs):
                    if gi not in in_set:
                        v |= 1 << (len(arg_idxs) - 1 - j)
                exprs.append(ir.Literal(v, BIGINT))
            branches.append(L.ProjectNode(node, tuple(exprs), agg_out))
        current = branches[0]
        none_maps = (None,) * len(agg_out)
        for b in branches[1:]:
            current = L.SetOpNode("union_all", current, b, none_maps,
                                  none_maps, agg_out)
        return current

    def plan_hll_aggregation(self, q, pre_node, group_irs, agg_specs,
                             scope, hll_calls, call_slots, distinct_args):
        """approx_distinct as a relational HLL rewrite (the TPU answer to
        ApproximateCountDistinctAggregation.java's per-group sketch
        objects):

            inner : GROUP BY keys + $hll_bucket(x) -> max($hll_rho(x)),
                    other aggregates as mergeable partials
            mid   : project 2^-max_rho
            outer : GROUP BY keys -> merge partials,
                    V = count(max_rho), S = sum(2^-max_rho)
            post  : $hll_est(V, S) finisher expression

        The inner aggregate is max/sum/count only, so the chunked driver
        and the distributed source stage merge its partial states with
        the ordinary machinery — bounded 2^p rows of state per group,
        where the exact sort-distinct path has unbounded state."""
        from ..types import DOUBLE as _D
        assert not distinct_args, \
            "caller routes DISTINCT mixes to the exact path"
        uniq = {}
        for call, b, r in hll_calls:
            uniq.setdefault((b, r), []).append(call)
        if len(uniq) > 1:
            raise AnalysisError(
                "multiple approx_distinct arguments unsupported")
        (b_slot, r_slot), calls = next(iter(uniq.items()))
        n_keys = len(group_irs)
        npart = len(agg_specs)

        # inner aggregate: keys + bucket, partial states + max(rho)
        inner_specs = list(agg_specs) + [L.AggSpecNode(
            "max", ir.ColumnRef(r_slot, BIGINT), "$mrho", BIGINT)]
        inner_out = tuple(
            [(f"gk{i}", e.dtype) for i, e in enumerate(group_irs)] +
            [("$hllb", BIGINT)] +
            [(s.out_name, s.out_dtype) for s in inner_specs])
        # capacity: per-group state saturates at 2^p registers, and the
        # total can never exceed the input row count
        base = self._sort_capacity(group_irs, scope, pre_node) \
            if group_irs else 1
        rows = max(1024, self.estimate_rows(pre_node))
        cap = min(max(base, 1) * (1 << HLL_P), rows)
        cap = 1 << (int(cap) - 1).bit_length()
        inner = L.AggregateNode(
            pre_node, tuple(range(n_keys)) + (b_slot,),
            tuple(inner_specs), "sort", (), cap, inner_out)

        # mid projection: pass keys + partials, add 2^-max_rho
        mrho = ir.ColumnRef(n_keys + 1 + npart, BIGINT)
        mid_exprs = tuple(
            [ir.ColumnRef(i, group_irs[i].dtype) for i in range(n_keys)] +
            [ir.ColumnRef(n_keys + 1 + j, s.out_dtype)
             for j, s in enumerate(agg_specs)] +
            [mrho, ir.ScalarFunc("$hll_pow", (mrho,), _D)])
        mid_out = tuple(
            [(f"gk{i}", e.dtype) for i, e in enumerate(group_irs)] +
            [(s.out_name, s.out_dtype) for s in agg_specs] +
            [("$mrho", BIGINT), ("$hpow", _D)])
        mid = L.ProjectNode(inner, mid_exprs, mid_out)

        # outer aggregate: merge partials, count/sum the register rows —
        # the same merge vocabulary the chunked driver uses, shared so
        # the two can't drift
        # port: the constant lives beside the aggregate kernels (the
        # chunked executor is not ported)
        from ..ops.aggregate import MERGE_FUNC as merge_of
        outer_specs = [
            L.AggSpecNode(merge_of[s.func],
                          ir.ColumnRef(n_keys + j, s.out_dtype),
                          s.out_name, s.out_dtype)
            for j, s in enumerate(agg_specs)]
        outer_specs.append(L.AggSpecNode(
            "count", ir.ColumnRef(n_keys + npart, BIGINT),
            "$hllv", BIGINT))
        outer_specs.append(L.AggSpecNode(
            "sum", ir.ColumnRef(n_keys + npart + 1, _D), "$hlls", _D))
        agg_out = tuple(
            [(f"gk{i}", e.dtype) for i, e in enumerate(group_irs)] +
            [(s.out_name, s.out_dtype) for s in outer_specs])
        strategy, domains, capacity = self.agg_strategy(
            group_irs, scope, pre_node)
        outer = L.AggregateNode(
            mid, tuple(range(n_keys)), tuple(outer_specs),
            strategy, domains, capacity, agg_out)
        for call in calls:
            call_slots[call] = ("hll", npart, npart + 1)
        return outer, list(outer_specs)

    def agg_strategy(self, group_irs, scope: Scope, pre_node,
                     any_distinct: bool = False):
        if not group_irs:
            # global DISTINCT aggregates run the sort kernel with zero
            # group keys (one segment); the executor falls back to
            # global_aggregate on empty input so the mandatory single
            # output row survives
            if any_distinct:
                return "sort", (), 1
            return "global", (), 0
        if any_distinct:
            return "sort", (), DEFAULT_SORT_GROUPS   # needs the sort kernel
        hmode = str(self.properties.get("hash_agg_mode", "auto")).lower()
        if hmode == "force":
            # ops/test knob: route every grouped aggregate through the
            # hash kernel (DISTINCT stays on sort — kernel contract)
            return "hash", (), self._sort_capacity(group_irs, scope,
                                                   pre_node)
        domains = []
        for e in group_irs:
            d = self.domain_of(e, scope)
            if d is None:
                domains = None
                break
            domains.append(d)
        if domains is not None:
            prod = math.prod(domains)
            # stats-driven cutoff (GroupByHash.java:82-93's role): the
            # direct strategy is a G-pass masked-reduction graph whose
            # compile time AND runtime scale with G, so it only pays
            # when groups are dense — many rows per group. The bound is
            # session-tunable; estimated rows-per-group below 64 fall to
            # the sort kernel (its cost is shape-, not G-, bound).
            limit = int(self.properties.get("direct_agg_max_groups",
                                            MAX_DIRECT_GROUPS))
            limit = min(limit, MAX_DIRECT_GROUPS)
            est = self._input_rows_estimate(pre_node)
            if prod <= limit and (est is None or est >= prod * 64):
                return "direct", tuple(domains), prod
        capacity = self._sort_capacity(group_irs, scope, pre_node)
        # hash vs sort: the rows-per-group gate ("Hash-Based vs.
        # Sort-Based Group-By-Aggregate" — hash wins at HIGH cardinality,
        # i.e. FEW rows per group, where the sort pays O(n log n) to
        # discover mostly-distinct keys while the VMEM hash table pays
        # one insert per row). The executor still falls back to sort at
        # runtime when the kernel is off or the keys cannot pack.
        if hmode not in ("off", "false", "0"):
            est_groups, rows = self._group_rows_estimate(
                group_irs, scope, pre_node)
            min_groups = int(self.properties.get(
                "hash_agg_min_groups", 8192))
            max_rpg = float(self.properties.get(
                "hash_agg_max_rows_per_group", 64))
            if est_groups is not None and rows is not None and \
                    est_groups >= min_groups and \
                    rows <= est_groups * max_rpg:
                return "hash", (), capacity
        return "sort", (), capacity

    def _input_rows_estimate(self, pre_node) -> Optional[int]:
        """Rough input-row bound for strategy choice: the largest scan
        under the aggregate's input chain (filters only shrink it)."""
        node = pre_node
        while isinstance(node, (L.FilterNode, L.ProjectNode)):
            node = node.child
        from .fragmenter import _subtree_nodes
        scans = [n for n in _subtree_nodes(node)
                 if isinstance(n, L.ScanNode)]
        if not scans:
            return None
        try:
            return max(self.catalog.get_table(
                s.catalog, s.schema_name, s.table).num_rows
                for s in scans)
        except Exception:      # noqa: BLE001 — stats are best-effort
            return None

    def _group_rows_estimate(self, group_irs, scope: Scope, pre_node):
        """(estimated group count, estimated input rows) from column
        NDV stats — the shared input of the sort-capacity sizing and
        the hash-vs-sort rows-per-group gate. (None, None) without
        stats."""
        cstats = self.chain_column_stats(pre_node.child) \
            if isinstance(pre_node, L.ProjectNode) else None
        if cstats is None:
            return None, None
        # group keys are the pre-projection's leading exprs
        prod = 1.0
        for e in group_irs:
            s = cstats.get(e.index) if isinstance(e, ir.ColumnRef) \
                else None
            if s is None:
                return None, None
            prod *= max(1.0, s.ndv)
        rows = self.estimate_rows(pre_node.child)
        return min(prod, rows), rows

    def _sort_capacity(self, group_irs, scope: Scope, pre_node) -> int:
        """Size the sort-aggregation output from stats (NDV product capped
        by input rows) instead of a fixed default: every capacity retry is
        a fresh XLA compile plus a full re-sort, so landing right the
        first time is the difference between one device pass and four
        (GroupByHash's expectedSize estimation)."""
        est, _rows = self._group_rows_estimate(group_irs, scope,
                                               pre_node)
        if est is None:
            return DEFAULT_SORT_GROUPS
        # 1.3x headroom, pow2 bucket (stable jit cache), floor at the
        # default so small queries share one trace
        cap = 1 << max(1, int(1.3 * est) - 1).bit_length()
        return int(min(max(cap, DEFAULT_SORT_GROUPS), 1 << 26))

    def domain_of(self, e: ir.Expr, scope: Scope) -> Optional[int]:
        if isinstance(e, ir.DerivedDict):
            return len(e.pool)
        if isinstance(e, ir.ColumnRef):
            if e.dtype.kind is TypeKind.VARCHAR:
                for c in scope.columns:
                    if c.index == e.index and c.field is not None and \
                            c.field.dictionary is not None:
                        return len(c.field.dictionary)
            if e.dtype.kind is TypeKind.BOOLEAN:
                return 2
        return None


    # ------------------------------------------------------------------
    # subquery predicates -> joins (decorrelation)
    # ------------------------------------------------------------------

    def plan_subquery_conjunct(self, rel: PlannedRelation,
                               c: A.Node) -> Optional[PlannedRelation]:
        """Try to absorb one unplaced conjunct that contains a subquery.
        Returns the rewritten relation, or None if this conjunct is not a
        supported subquery shape."""
        if isinstance(c, A.ExistsPredicate):
            return self.plan_exists(rel, c.query, c.negated)
        if isinstance(c, A.UnaryOp) and c.op == "not" and \
                isinstance(c.arg, A.ExistsPredicate):
            return self.plan_exists(rel, c.arg.query, not c.arg.negated)
        if isinstance(c, A.InSubquery):
            return self.plan_in_subquery(rel, c)
        if isinstance(c, A.BinaryOp) and c.op in ("=", "<>", "<", "<=",
                                                  ">", ">="):
            # the scalar subquery may sit anywhere in the comparison
            # (e.g. price > 1.2 * (SELECT avg ...)); decorrelate it and
            # re-lower the whole predicate with the subquery's value
            # column spliced in
            subs: List[A.ScalarSubquery] = []
            collect_scalar_subqueries(c, subs)
            if len(subs) == 1:
                return self.plan_correlated_scalar(rel, c, subs[0])
        if isinstance(c, A.BinaryOp) and c.op == "or":
            return self.plan_disjunctive_exists(rel, c)
        return None

    def plan_disjunctive_exists(self, rel: PlannedRelation,
                                c: A.Node) -> Optional[PlannedRelation]:
        """(EXISTS s1 OR EXISTS s2 OR plain-pred ...) -> mark joins.

        Each EXISTS term becomes a mark join appending a hidden boolean
        column (TransformExistsApplyToCorrelatedJoin's MARK variant,
        operator-level JoinNode.Type.MARK in the reference); the disjunct
        then filters on the marks. EXISTS truth is 2-valued, so NOT
        EXISTS inside OR is a plain negation of its mark."""
        terms: List[A.Node] = []

        def flatten(node):
            if isinstance(node, A.BinaryOp) and node.op == "or":
                flatten(node.left)
                flatten(node.right)
            else:
                terms.append(node)
        flatten(c)

        def as_exists(t):
            if isinstance(t, A.ExistsPredicate):
                return t.query, t.negated
            if isinstance(t, A.UnaryOp) and t.op == "not" and \
                    isinstance(t.arg, A.ExistsPredicate):
                return t.arg.query, not t.arg.negated
            return None

        def has_subquery(node) -> bool:
            if isinstance(node, (A.ExistsPredicate, A.InSubquery,
                                 A.ScalarSubquery)):
                return True
            return any(has_subquery(ch) for ch in ast_children(node))

        exists_terms = [as_exists(t) for t in terms]
        if not any(e is not None for e in exists_terms):
            return None
        if any(e is None and has_subquery(t)
               for t, e in zip(terms, exists_terms)):
            return None          # OR mixing other subquery shapes: punt

        current = rel
        parts: List[ir.Expr] = []
        for t, e in zip(terms, exists_terms):
            if e is None:
                lowerer = ExpressionLowerer(current.scope, planner=self)
                parts.append(lowerer.to_bool(lowerer.lower(t)))
                continue
            subq, negated = e
            inner, corr, residual_asts = self.plan_inner_with_correlation(
                current, subq)
            if not corr:
                return None
            residual = None
            if residual_asts:
                lw = ExpressionLowerer(self.pair_scope(current, inner),
                                       planner=self)
                preds = [lw.to_bool(lw.lower(x)) for x in residual_asts]
                residual = preds[0] if len(preds) == 1 else ir.Logical(
                    "and", tuple(preds))
            node = self.make_join(
                "mark", current.node, inner.node,
                tuple(o for o, _ in corr),
                tuple(cc.index for _, cc in corr), residual, False,
                probe_fields=[self._scope_field(current.scope, o)
                              for o, _ in corr],
                build_fields=[cc.field for _, cc in corr])
            mark = ir.ColumnRef(len(node.output) - 1, BOOLEAN)
            parts.append(ir.Not(mark, BOOLEAN) if negated else mark)
            current = PlannedRelation(node, current.scope)
        pred = parts[0] if len(parts) == 1 else ir.Logical(
            "or", tuple(parts))
        out = L.FilterNode(current.node, pred, current.node.output)
        return PlannedRelation(out, rel.scope)

    def plan_inner_with_correlation(self, outer: PlannedRelation,
                                    subq: A.Query):
        """Plan a subquery's FROM/WHERE, separating correlation.

        Returns (inner_rel, corr_pairs, residual_asts):
        - corr_pairs: [(outer_col_index, inner_col_index)] from equi
          conjuncts linking the scopes (the future join keys);
        - residual_asts: leftover conjuncts referencing both scopes
          (lowered later over the concatenated probe++build scope).
        Inner-only conjuncts are already pushed into inner_rel."""
        if subq.group_by or subq.having or subq.ctes:
            raise AnalysisError(
                "correlated subquery with GROUP BY/HAVING unsupported")
        inner_rels, on_conj = self.plan_relation_tree(subq.relation)
        conjuncts: List[A.Node] = list(on_conj)
        if subq.where is not None:
            split_conjuncts(subq.where, conjuncts)
        add_or_common_conjuncts(conjuncts)
        inner = self.combine_relations(inner_rels, conjuncts)
        inner = self.apply_local_filters(inner, conjuncts)
        corr: List[Tuple[int, ScopeColumn]] = []
        residual: List[A.Node] = []
        for c in list(conjuncts):
            eq = as_equi(c)
            if eq is not None:
                a, b = eq
                oa = outer.scope.try_resolve(a)
                ib = inner.scope.try_resolve(b)
                if oa is not None and ib is not None:
                    corr.append((oa.index, ib))
                    conjuncts.remove(c)
                    continue
                ob = outer.scope.try_resolve(b)
                ia = inner.scope.try_resolve(a)
                if ob is not None and ia is not None:
                    corr.append((ob.index, ia))
                    conjuncts.remove(c)
                    continue
            residual.append(c)
            conjuncts.remove(c)
        return inner, corr, residual

    def pair_scope(self, outer: PlannedRelation,
                   inner: PlannedRelation) -> Scope:
        """Concatenated probe++build scope for join residual lowering."""
        n = len(outer.node.output)
        cols = list(outer.scope.columns) + [
            ScopeColumn(c.qualifier, c.name, c.dtype, c.index + n, c.field)
            for c in inner.scope.columns]
        return Scope(cols)

    def plan_exists(self, outer: PlannedRelation, subq: A.Query,
                    negated: bool) -> PlannedRelation:
        """[NOT] EXISTS (correlated) -> semi/anti join
        (TransformCorrelatedExistsToJoin's role). Non-equi correlated
        conjuncts become the join residual (mark-join kernel)."""
        inner, corr, residual_asts = self.plan_inner_with_correlation(
            outer, subq)
        if not corr:
            raise AnalysisError("uncorrelated EXISTS not supported")
        residual = None
        if residual_asts:
            lowerer = ExpressionLowerer(self.pair_scope(outer, inner),
                                        planner=self)
            preds = [lowerer.to_bool(lowerer.lower(x))
                     for x in residual_asts]
            residual = preds[0] if len(preds) == 1 else ir.Logical(
                "and", tuple(preds))
        node = self.make_join(
            "anti" if negated else "semi", outer.node, inner.node,
            tuple(o for o, _ in corr), tuple(c.index for _, c in corr),
            residual, False,
            probe_fields=[self._scope_field(outer.scope, o)
                          for o, _ in corr],
            build_fields=[c.field for _, c in corr])
        return PlannedRelation(node, outer.scope)

    def plan_in_subquery(self, outer: PlannedRelation,
                         c: A.InSubquery) -> PlannedRelation:
        """x [NOT] IN (subquery) -> semi/anti join on x = subquery output.
        NOT IN is null-aware: NULL x never passes (pre-filter), and any
        NULL in the subquery output empties the result (executor check) —
        SQL three-valued NOT IN semantics."""
        sub = self.plan_query(c.query)
        if len(sub.scope.columns) != 1:
            raise AnalysisError("IN subquery must return one column")
        build_node = sub.node.child if isinstance(sub.node, L.OutputNode) \
            else sub.node

        lowerer = ExpressionLowerer(outer.scope, planner=self)
        key = lowerer.lower(c.arg)
        probe = outer
        # capture the key's dictionary BEFORE any probe extension: a
        # computed key's field is derivable only from the expression
        key_field = self.field_for(key, outer.scope)
        if not isinstance(key, ir.ColumnRef):
            # extend the probe with a computed key column (hidden)
            exprs = [ir.ColumnRef(i, t, n) for i, (n, t)
                     in enumerate(outer.node.output)] + [key]
            out = tuple(outer.node.output) + ((f"$inkey", key.dtype),)
            probe = PlannedRelation(
                L.ProjectNode(outer.node, tuple(exprs), out), outer.scope)
            key = ir.ColumnRef(len(out) - 1, key.dtype)
        if c.negated:
            # NULL probe keys can never satisfy NOT IN
            probe = PlannedRelation(
                L.FilterNode(probe.node, ir.IsNull(key, negated=True),
                             probe.node.output), probe.scope)
        node = self.make_join(
            "anti" if c.negated else "semi", probe.node, build_node,
            (key.index,), (0,), None, False,
            probe_fields=[key_field],
            build_fields=[sub.scope.columns[0].field],
            null_aware=c.negated)
        return PlannedRelation(node, outer.scope)

    def plan_correlated_scalar(self, outer: PlannedRelation,
                               conjunct: A.Node,
                               sub: A.ScalarSubquery) -> PlannedRelation:
        """Predicate containing (SELECT agg(...) FROM ... WHERE corr) ->
        group the subquery by its correlation keys, join, re-lower the
        whole predicate over outer ++ value column.
        (TransformCorrelatedScalarSubquery + aggregation decorrelation.)"""
        subq = sub.query
        if len(subq.select) != 1 or subq.select[0].expr is None:
            raise AnalysisError("scalar subquery must select one expression")
        if not contains_aggregate(subq.select[0].expr):
            raise AnalysisError(
                "correlated scalar subquery must be an aggregate")
        inner, corr, residual = self.plan_inner_with_correlation(outer, subq)
        if residual:
            raise AnalysisError(
                f"non-equi correlated scalar subquery: {residual}")
        if not corr:
            raise AnalysisError(
                "uncorrelated scalar subquery reached the correlated path")

        # synthesize: SELECT k1.., <agg expr> GROUP BY k1..
        group_asts = []
        for _, icol in corr:
            parts = (icol.qualifier, icol.name) if icol.qualifier \
                else (icol.name,)
            group_asts.append(A.Identifier(parts))
        select = tuple(A.SelectItem(g, f"$ck{i}")
                       for i, g in enumerate(group_asts)) + \
            (A.SelectItem(subq.select[0].expr, "$val"),)
        synth = A.Query(select=select, distinct=False, relation=None,
                        where=None, group_by=tuple(group_asts),
                        having=None, order_by=(), limit=None)
        agg_rel, _, _ = self.plan_aggregation(synth, inner)

        k = len(corr)
        # LEFT join: outer rows with an empty correlated group survive
        # with a NULL value column (SQL scalar-subquery-over-empty
        # semantics); see the marker handling below
        join = self.make_join(
            "left", outer.node, agg_rel.node,
            tuple(o for o, _ in corr), tuple(range(k)), None, True,
            probe_fields=[self._scope_field(outer.scope, o)
                          for o, _ in corr],
            build_fields=[agg_rel.scope.columns[i].field
                          for i in range(k)])
        out = join.output
        n_outer = len(outer.node.output)
        val_name, val_t = agg_rel.node.output[k]
        # splice the subquery's value column into the predicate: replace
        # the ScalarSubquery AST with a hidden identifier bound to it,
        # then lower the whole conjunct (arithmetic around the subquery
        # included) over outer ++ value.
        # Empty-group semantics: the LEFT join leaves the value NULL for
        # outer rows with no correlated group — correct for sum/avg/min/
        # max (NULL over empty) and for comparisons (unknown filters the
        # row); a BARE count is 0 over an empty group, so it coalesces.
        marker: A.Node = A.Identifier(("$corrval",))
        sel = subq.select[0].expr
        bare_count = isinstance(sel, A.FunctionCall) and \
            sel.name == "count"
        if not bare_count:
            for node_ in walk_ast(sel):
                if isinstance(node_, A.FunctionCall) and \
                        node_.name == "count":
                    raise AnalysisError(
                        "correlated scalar subquery mixing count() into "
                        "a larger expression is not supported (empty "
                        "groups would need per-expression evaluation)")
        if bare_count:
            marker = A.FunctionCall("coalesce",
                                    (marker, A.NumberLit("0")))
        pred_ast = ast_replace(conjunct, sub, marker)
        scope2 = Scope(list(outer.scope.columns) +
                       [ScopeColumn(None, "$corrval", val_t,
                                    n_outer + k, None)])
        low = ExpressionLowerer(scope2, planner=self)
        pred = low.to_bool(low.lower(pred_ast))
        node = L.FilterNode(join, pred, out)
        # visible scope stays the outer's; joined agg columns are hidden
        return PlannedRelation(node, outer.scope)

    def resolve_order_expr(self, ast: A.Node, q: A.Query,
                           rel: PlannedRelation, names: List[str]) -> int:
        # ordinal
        if isinstance(ast, A.NumberLit) and "." not in ast.text:
            i = int(ast.text) - 1
            if not (0 <= i < len(names)):
                raise AnalysisError(f"ORDER BY position {i+1} out of range")
            return i
        # alias or column name in output
        if isinstance(ast, A.Identifier) and len(ast.parts) == 1:
            nm = ast.parts[0].lower()
            if nm in names:
                return names.index(nm)
        # expression identical to some select item
        for i, item in enumerate(q.select):
            if item.expr is not None and ast_equal(ast, item.expr, q):
                return i
        raise AnalysisError(
            "ORDER BY expressions must reference select outputs for now")


# --------------------------------------------------------------------------
# small helpers
# --------------------------------------------------------------------------

def split_conjuncts(node: A.Node, out: List[A.Node]) -> None:
    if isinstance(node, A.BinaryOp) and node.op == "and":
        split_conjuncts(node.left, out)
        split_conjuncts(node.right, out)
    else:
        out.append(node)


def add_or_common_conjuncts(conjuncts: List[A.Node]) -> None:
    """For each OR conjunct, pull out predicates present in every branch
    (sound: the OR implies them). TPC-H q19's join key p_partkey=l_partkey
    lives inside each OR block; Trino's ExtractCommonPredicatesExpression-
    Rewrite (sql/ir/optimizer/) performs the same extraction. The original
    OR stays as a residual filter."""
    extracted: List[A.Node] = []
    for c in conjuncts:
        branches: List[A.Node] = []
        split_disjuncts(c, branches)
        if len(branches) < 2:
            continue
        branch_conjs = []
        for b in branches:
            bc: List[A.Node] = []
            split_conjuncts(b, bc)
            branch_conjs.append(bc)
        for cand in branch_conjs[0]:
            if all(cand in bc for bc in branch_conjs[1:]):
                if cand not in conjuncts and cand not in extracted:
                    extracted.append(cand)
    conjuncts.extend(extracted)


def split_disjuncts(node: A.Node, out: List[A.Node]) -> None:
    if isinstance(node, A.BinaryOp) and node.op == "or":
        split_disjuncts(node.left, out)
        split_disjuncts(node.right, out)
    else:
        out.append(node)


def as_equi(node: A.Node):
    if isinstance(node, A.BinaryOp) and node.op == "=" and \
            isinstance(node.left, A.Identifier) and \
            isinstance(node.right, A.Identifier):
        return node.left.parts, node.right.parts
    return None


def walk_ast(node: A.Node):
    from .analyzer import ast_children
    yield node
    for ch in ast_children(node):
        yield from walk_ast(ch)


def collect_scalar_subqueries(node: A.Node, out: list) -> None:
    """Find ScalarSubquery nodes in a predicate (not descending into
    nested queries — each subquery is handled at its own level)."""
    from .analyzer import ast_children
    if isinstance(node, A.ScalarSubquery):
        out.append(node)
        return
    if isinstance(node, (A.Query, A.SetOp)):
        return
    for ch in ast_children(node):
        collect_scalar_subqueries(ch, out)


def ast_replace(root: A.Node, target: A.Node, replacement: A.Node) -> A.Node:
    """Rebuild an AST with `target` (by identity) swapped for
    `replacement`; untouched subtrees keep their identity."""
    import dataclasses as _dc
    if root is target:
        return replacement
    if not _dc.is_dataclass(root):
        return root
    changes = {}
    for f in _dc.fields(root):
        v = getattr(root, f.name)
        if isinstance(v, A.Node):
            nv = ast_replace(v, target, replacement)
            if nv is not v:
                changes[f.name] = nv
        elif isinstance(v, tuple) and any(isinstance(x, A.Node)
                                          for x in v):
            nv = tuple(ast_replace(x, target, replacement)
                       if isinstance(x, A.Node) else x for x in v)
            if any(a is not b for a, b in zip(nv, v)):
                changes[f.name] = nv
    return _dc.replace(root, **changes) if changes else root


def collect_grouping_calls(node: A.Node, out: list) -> None:
    """Find grouping(...) calls (GroupingOperationRewriter's discovery
    step); window arguments are excluded like collect_windows' are."""
    from .analyzer import ast_children
    if isinstance(node, A.FunctionCall) and node.name == "grouping":
        if node not in out:
            out.append(node)
        return
    for ch in ast_children(node):
        collect_grouping_calls(ch, out)


def ast_equal(a: A.Node, b: A.Node, q: A.Query) -> bool:
    """Syntactic equality; also matches a bare identifier against a select
    alias (SQL: GROUP BY can reference aliases in some dialects — Trino
    allows ordinals and output names; we match structurally)."""
    return a == b


def resolve_ordinal(g: A.Node, q: A.Query) -> A.Node:
    if isinstance(g, A.NumberLit) and "." not in g.text:
        i = int(g.text) - 1
        if 0 <= i < len(q.select) and q.select[i].expr is not None:
            return q.select[i].expr
    return g


def default_name(expr: A.Node) -> str:
    if isinstance(expr, A.Identifier):
        return expr.parts[-1]
    if isinstance(expr, A.FunctionCall):
        return expr.name
    return "_col"


def sum_type(t: DataType) -> DataType:
    if t.kind is TypeKind.DECIMAL:
        from ..types import decimal as mk
        # the reference's sum(decimal(p,s)) -> decimal(38,s)
        # (DecimalAggregation); device accumulation is two int64 limbs
        return mk(38, t.scale)
    if t.kind is TypeKind.DOUBLE:
        return DOUBLE
    return BIGINT


def sub_fields(sub: "PlannedRelation"):
    """Fields (with dictionaries) for a subquery's output columns."""
    return [c.field for c in sub.scope.columns]


def _div_half_up(v: int, div: int) -> int:
    """Integer divide rounding HALF_UP away from zero — identical to the
    runtime ir.Cast rescale so plan-time folding can't diverge."""
    q, r = divmod(abs(v), div)
    if 2 * r >= div:
        q += 1
    return q if v >= 0 else -q


def _convert_const(value, src: Optional[DataType], dst: DataType):
    """Convert a plan-time constant between logical types (VALUES cell
    coercion; Trino's TypeCoercion applied to bound constants). Rounding
    is HALF_UP away from zero, matching the runtime Cast kernels."""
    import math
    if value is None or src is None:
        return None
    if src == dst:
        return value
    sk, dk = src.kind, dst.kind
    if dk is TypeKind.DECIMAL:
        if sk is TypeKind.DECIMAL:
            diff = dst.scale - src.scale
            return value * 10 ** diff if diff >= 0 \
                else _div_half_up(value, 10 ** -diff)
        if sk in (TypeKind.BIGINT, TypeKind.INTEGER):
            return value * 10 ** dst.scale
        if sk is TypeKind.DOUBLE:
            scaled = abs(value) * 10 ** dst.scale
            return int(math.floor(scaled + 0.5)) * (1 if value >= 0 else -1)
    if dk is TypeKind.DOUBLE:
        if sk is TypeKind.DECIMAL:
            return value / 10 ** src.scale
        return float(value)
    if dk in (TypeKind.BIGINT, TypeKind.INTEGER):
        if sk is TypeKind.DECIMAL:
            return _div_half_up(value, 10 ** src.scale)
        if sk is TypeKind.DOUBLE:
            return int(math.floor(abs(value) + 0.5)) * \
                (1 if value >= 0 else -1)
        return int(value)
    if dk is TypeKind.VARCHAR and sk is TypeKind.VARCHAR:
        return value
    if dk is TypeKind.DATE and sk is TypeKind.DATE:
        return value
    raise AnalysisError(f"cannot cast constant from {src} to {dst}")


def _cast_relation(rel: PlannedRelation, casts) -> PlannedRelation:
    """Wrap a set-op side in a cast projection where column types differ
    from the unified output type (AddExchanges inserts the same coercion
    projections under UnionNode in the reference)."""
    if all(c is None for c in casts):
        return rel
    exprs, output, cols = [], [], []
    for i, (c, sc) in enumerate(zip(casts, rel.scope.columns)):
        ref = ir.ColumnRef(i, sc.dtype, sc.name)
        if c is None:
            exprs.append(ref)
            output.append((sc.name, sc.dtype))
            cols.append(ScopeColumn(sc.qualifier, sc.name, sc.dtype, i,
                                    sc.field))
        else:
            exprs.append(ir.Cast(ref, c))
            output.append((sc.name, c))
            cols.append(ScopeColumn(sc.qualifier, sc.name, c, i, None))
    node = L.ProjectNode(rel.node, tuple(exprs), tuple(output))
    return PlannedRelation(node, Scope(cols))
