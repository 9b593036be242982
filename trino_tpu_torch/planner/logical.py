"""Port copy of ``trino_tpu/planner/logical.py`` (no edits beyond import
targets noted inline).

Logical plan nodes.

Reference: Trino's 66 PlanNode kinds (core/trino-main/.../sql/planner/plan/).
We model the executed subset; each node's `output` is an ordered list of
(name, DataType) pairs, and expressions reference child output columns by
position (like Trino's Symbol-resolved plans, but positional — a deliberate
simplification that suits array programs).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .. import ir
from ..batch import Schema
from ..types import DataType, TypeKind


@dataclass(frozen=True)
class PlanNode:
    pass


@dataclass(frozen=True)
class ScanNode(PlanNode):
    """TableScanNode (sql/planner/plan/TableScanNode.java) — reads a
    connector table; column pruning happens via `column_indices`."""
    catalog: str
    schema_name: str
    table: str
    table_schema: Schema              # full connector schema
    column_indices: Tuple[int, ...]   # which connector columns we read
    output: Tuple                     # ((name, DataType), ...)
    # conjunctive single-column predicate pushed down by the optimizer
    # (TupleDomain pushdown in the reference). Advisory only: execution
    # may use it to skip zones/splits that provably cannot match, but the
    # residual FilterNode above always re-applies the full predicate, so
    # dropping it is always safe. References are scan OUTPUT positions.
    predicate: Optional[ir.Expr] = None


@dataclass(frozen=True)
class FilterNode(PlanNode):
    child: PlanNode
    predicate: ir.Expr
    output: Tuple


@dataclass(frozen=True)
class ProjectNode(PlanNode):
    child: PlanNode
    exprs: Tuple                      # tuple[ir.Expr, ...]
    output: Tuple


@dataclass(frozen=True)
class AggSpecNode:
    func: str                         # sum|count|count_star|min|max|avg
    arg: Optional[ir.Expr]            # over child output
    out_name: str
    out_dtype: DataType
    distinct: bool = False


@dataclass(frozen=True)
class AggregateNode(PlanNode):
    """AggregationNode; group_keys are child output column indices.
    `strategy` chosen by the optimizer: 'direct' (dense dict-code domain),
    'sort' (general), or 'global' (no keys)."""
    child: PlanNode
    group_keys: Tuple[int, ...]
    aggs: Tuple                       # tuple[AggSpecNode, ...]
    strategy: str
    key_domains: Tuple[int, ...]      # for 'direct'
    out_capacity: int                 # for 'sort'
    output: Tuple


@dataclass(frozen=True)
class JoinNode(PlanNode):
    """JoinNode (sql/planner/plan/JoinNode.java). Equi-join; left side is
    the probe, right side the build (LookupJoinOperator convention:
    HashBuilderOperator consumes the build side)."""
    kind: str                         # inner|left|semi|anti|mark
    left: PlanNode                    # probe
    right: PlanNode                   # build
    left_keys: Tuple[int, ...]
    right_keys: Tuple[int, ...]
    residual: Optional[ir.Expr]       # over concatenated output
    build_unique: bool                # planner's guarantee/assumption
    output: Tuple
    null_aware: bool = False          # NOT IN semantics (anti only)
    # cost-chosen exchange strategy for the build side on a mesh
    # (DetermineJoinDistributionType.java:51): REPLICATED vs PARTITIONED
    distribution: str = "auto"        # auto|broadcast|partitioned
    # dense-LUT probe domain (exclusive key upper bound) when connector
    # stats prove the single build key lives in [0, domain) — the
    # BigintGroupByHash-style fast path; None = sorted+searchsorted
    build_key_domain: Optional[int] = None


@dataclass(frozen=True)
class MultiJoinNode(PlanNode):
    """Fused star join: one fact relation inner-joined to k snowflaked
    dimension builds on conjunctive single-column equi-keys, probed in
    ONE Pallas pass (ops/pallas_hash.multiway_probe). Emitted by the
    planner's star detector (fuse_star_joins) as the fusion of a
    pairwise JoinNode ladder; `multijoin_to_ladder` reconstructs that
    ladder exactly, so every degrade path is bit-exact by construction.

    The fact side is AUTHORITATIVE: unlike the pairwise path, the
    executor never re-derives probe/build orientation per hop, so a
    mis-sized dimension can't silently flip the fact table into a VMEM
    build — it degrades that one dimension to the pairwise ladder
    instead.  `output` is the ladder-top layout: fact columns, then
    each dimension's columns in join order (dims[0] = bottom hop)."""
    fact: PlanNode
    dims: Tuple[PlanNode, ...]
    fact_keys: Tuple[Tuple[int, ...], ...]   # per dim, fact-side keys
    dim_keys: Tuple[Tuple[int, ...], ...]    # per dim, build-side keys
    # per-dim dense-LUT domains, preserved so the reconstructed ladder
    # keeps the original JoinNodes' fast paths
    dim_domains: Tuple[Optional[int], ...]
    output: Tuple
    distribution: str = "broadcast"


@dataclass(frozen=True)
class WinSpecNode:
    """One window function (plan-level mirror of ops.window.WinSpec)."""
    func: str                         # row_number|rank|dense_rank|ntile|
                                      # lead|lag|first_value|last_value|
                                      # sum|count|count_star|min|max
    arg: Optional[int]                # child output column index
    frame: str                        # partition|range_running|rows_running
    offset: int                       # lead/lag offset, ntile buckets
    default: Optional[object]         # lead/lag default literal
    out_name: str
    out_dtype: DataType


@dataclass(frozen=True)
class WindowNode(PlanNode):
    """WindowNode (sql/planner/plan/WindowNode.java): appends one column
    per function; all functions share (partition_by, order_by)."""
    child: PlanNode
    partition_by: Tuple[int, ...]     # child output column indices
    order_by: Tuple                   # tuple[SortKey, ...]
    specs: Tuple                      # tuple[WinSpecNode, ...]
    output: Tuple


@dataclass(frozen=True)
class UnnestNode(PlanNode):
    """UNNEST lateral expansion (operator/unnest/UnnestOperator.java:42):
    each input row repeats once per element of its array; output = child
    columns ++ element column (++ ordinality). Arrays follow the pool-id
    discipline (types.py), so expansion runs at the host edge like the
    other pool transforms."""
    child: PlanNode
    array_col: int                    # child output column (pool ids)
    array_pool: Tuple                 # id -> tuple of elements
    element_name: str
    element_dtype: "DataType"
    element_pool: Optional[Tuple]     # varchar elements: their dict pool
    ordinality: bool
    output: Tuple


@dataclass(frozen=True)
class SortKey:
    index: int
    ascending: bool
    nulls_first: bool


@dataclass(frozen=True)
class SortNode(PlanNode):
    child: PlanNode
    keys: Tuple                       # tuple[SortKey, ...]
    limit: Optional[int]              # TopN fusion (TopNOperator)
    output: Tuple


@dataclass(frozen=True)
class LimitNode(PlanNode):
    child: PlanNode
    count: int
    output: Tuple


@dataclass(frozen=True, eq=False)
class ValuesNode(PlanNode):
    """Inline table of constants (sql/planner/plan/ValuesNode.java).
    Cell values are evaluated at plan time; arrays are host numpy columns
    (VARCHAR already dictionary-encoded, dictionaries in `fields`)."""
    arrays: Tuple                     # tuple[np.ndarray, ...]
    valids: Tuple                     # tuple[np.ndarray, ...]
    num_rows: int
    fields: Tuple                     # tuple[batch.Field, ...]
    output: Tuple


@dataclass(frozen=True)
class SetOpNode(PlanNode):
    """UNION/INTERSECT/EXCEPT (plan/UnionNode.java, IntersectNode.java,
    ExceptNode.java). Children are type-aligned by the planner; VARCHAR
    columns share a merged dictionary, with `right_remaps` holding the
    old-code -> merged-code LUT per column (None = identity).

    'union_all' concatenates on device; the DISTINCT/INTERSECT/EXCEPT
    variants run host-side (Trino lowers them to aggregation + join —
    these are cold paths by row volume)."""
    op: str                           # union|union_all|intersect|
                                      # intersect_all|except|except_all
    left: PlanNode
    right: PlanNode
    left_remaps: Tuple                # tuple[Optional[tuple[int,...]], ...]
    right_remaps: Tuple               # tuple[Optional[tuple[int,...]], ...]
    output: Tuple


@dataclass(frozen=True)
class RemoteSourceNode(PlanNode):
    """Consumes another fragment's output (sql/planner/plan/
    RemoteSourceNode.java): the cut point the fragmenter leaves behind.
    At schedule time the producing fragment's materialized output is
    substituted here (broadcast distribution ships it inside the consumer
    fragment; the executor never sees this node)."""
    fragment_id: int
    output: Tuple


@dataclass(frozen=True)
class OutputNode(PlanNode):
    """Root: names the result columns (sql/planner/plan/OutputNode.java)."""
    child: PlanNode
    names: Tuple[str, ...]
    output: Tuple


@dataclass(frozen=True)
class TableWriterNode(PlanNode):
    """Partitioned write stage root (sql/planner/plan/TableWriterNode.java):
    the subtree's rows are staged to a uniquely-named attempt file under
    the target table's `.staging/` directory — never published by the
    worker. `fields` carries the concrete output Fields (dictionaries
    included) so a write task can rebuild TableData from exchange pages;
    `attempt` makes every task attempt's staging file unique."""
    child: PlanNode
    catalog: str
    schema_name: str
    table: str
    table_dir: str
    fmt: str                          # "orc" | "parquet"
    query_id: str
    stage: int
    partition: int
    attempt: str
    fields: Tuple                     # Tuple[Field, ...]
    output: Tuple                     # (("rows", BIGINT),)


@dataclass(frozen=True)
class TableCommitNode(PlanNode):
    """Coordinator-side commit root (TableFinishNode.java's role): dedups
    staged-file manifests by (stage, partition) first-success-wins, writes
    the CRC-framed commit journal, publishes by atomic rename, bumps the
    catalog version. Executes on the coordinator only — the scheduler
    interprets it; the executor never sees it."""
    child: PlanNode
    catalog: str
    schema_name: str
    table: str
    query_id: str
    output: Tuple


def children(node: PlanNode):
    if isinstance(node, (FilterNode, ProjectNode, AggregateNode, SortNode,
                         LimitNode, OutputNode, WindowNode, UnnestNode,
                         TableWriterNode, TableCommitNode)):
        return (node.child,)
    if isinstance(node, (JoinNode, SetOpNode)):
        return (node.left, node.right)
    if isinstance(node, MultiJoinNode):
        return (node.fact,) + node.dims
    return ()


def replace_nodes(root: PlanNode, mapping) -> PlanNode:
    """Rebuild the (frozen) tree with `mapping[id(node)] -> new node`
    substitutions applied; untouched subtrees keep their identity."""
    import dataclasses as _dc
    hit = mapping.get(id(root))
    if hit is not None:
        return hit
    changes = {}
    for f in _dc.fields(root):
        v = getattr(root, f.name)
        if isinstance(v, PlanNode):
            nv = replace_nodes(v, mapping)
            if nv is not v:
                changes[f.name] = nv
        elif isinstance(v, tuple) and v and \
                all(isinstance(x, PlanNode) for x in v):
            nv = tuple(replace_nodes(x, mapping) for x in v)
            if any(a is not b for a, b in zip(nv, v)):
                changes[f.name] = nv
    return _dc.replace(root, **changes) if changes else root


# --------------------------------------------------------------------------
# star detection: fuse a pairwise JoinNode ladder into one MultiJoinNode
# --------------------------------------------------------------------------

# key kinds the fused kernel can probe: `_combined_key` packs these into
# one int64 losslessly (VARCHAR rides its dictionary codes — make_join's
# `$jk` pool alignment guarantees both sides share a pool).  DOUBLE and
# DECIMAL would truncate through the int64 pack.
_STAR_KEY_KINDS = (TypeKind.BIGINT, TypeKind.INTEGER, TypeKind.BOOLEAN,
                   TypeKind.DATE, TypeKind.TIMESTAMP, TypeKind.VARCHAR)


def _spine_has_join(node: PlanNode) -> bool:
    while isinstance(node, FilterNode):
        node = node.child
    return isinstance(node, JoinNode)


def _star_hop_ok(j: JoinNode, n_fact: int) -> Optional[str]:
    """None if the hop can join the fused star, else the decline reason
    (surfaced verbatim in EXPLAIN's star verdict)."""
    if j.kind != "inner":
        return "non-inner hop"
    if j.residual is not None:
        return "residual predicate on hop"
    if j.null_aware:
        return "null-aware hop"
    if not j.build_unique:
        return "build not provably unique"
    if len(j.left_keys) != 1:
        return "multi-column key"
    if j.left_keys[0] >= n_fact:
        # the probe key is a column PRODUCED by an earlier dimension:
        # it does not exist in the fact batch the single pass probes
        return "snowflake key (dim-derived)"
    if j.left.output[j.left_keys[0]][1].kind not in _STAR_KEY_KINDS or \
            j.right.output[j.right_keys[0]][1].kind not in _STAR_KEY_KINDS:
        return "non-integer key"
    return None


def collect_star(root: PlanNode, max_dims: int):
    """Walk the probe spine of a join ladder (JoinNodes, with conjunct
    FilterNodes interleaved) bottom-up, committing the longest fusable
    prefix of hops.  Returns None when the spine holds fewer than two
    joins, else (fact, hops, hoisted, upper, note):

    - `fact`    first non-spine node (the probe side of the bottom hop)
    - `hops`    committed JoinNodes, bottom-up (possibly < 2: declined)
    - `hoisted` FilterNodes that sat BETWEEN committed hops, bottom-up;
      their predicates reference prefix columns of the fused layout, so
      they re-apply above the MultiJoinNode without remapping
    - `upper`   spine nodes (top-down) left above the fusion point
    - `note`    why fusion stopped (None = every hop committed)
    """
    spine = []
    node = root
    while True:
        if isinstance(node, FilterNode) and _spine_has_join(node.child):
            spine.append(node)
            node = node.child
        elif isinstance(node, JoinNode):
            spine.append(node)
            node = node.left
        else:
            break
    fact = node
    if sum(1 for n in spine if isinstance(n, JoinNode)) < 2:
        return None
    n_fact = len(fact.output)
    hops, hoisted, pend_filters = [], [], []
    note = None
    cut = len(spine)
    for idx in range(len(spine) - 1, -1, -1):
        nd = spine[idx]
        if isinstance(nd, FilterNode):
            pend_filters.append(nd)
            continue
        why = _star_hop_ok(nd, n_fact)
        if why is None and len(hops) >= max_dims:
            why = f"dim cap ({max_dims})"
        if why is not None:
            note = why
            break
        hops.append(nd)
        hoisted.extend(pend_filters)
        pend_filters = []
        cut = idx
    return fact, hops, hoisted, spine[:cut], note


def fuse_star_joins(root: PlanNode, max_dims: int) -> PlanNode:
    """Rewrite the longest fusable star prefix of `root`'s join ladder
    into a MultiJoinNode (identity when nothing qualifies).  The fused
    node's output equals the topmost committed hop's, so everything
    above re-attaches unchanged."""
    import dataclasses as _dc
    got = collect_star(root, max_dims)
    if got is None:
        return root
    fact, hops, hoisted, upper, _note = got
    if len(hops) < 2:
        return root
    cur: PlanNode = MultiJoinNode(
        fact=fact,
        dims=tuple(h.right for h in hops),
        fact_keys=tuple(tuple(h.left_keys) for h in hops),
        dim_keys=tuple(tuple(h.right_keys) for h in hops),
        dim_domains=tuple(h.build_key_domain for h in hops),
        output=tuple(hops[-1].output))
    for f in hoisted:
        cur = FilterNode(cur, f.predicate, cur.output)
    for nd in reversed(upper):
        if isinstance(nd, FilterNode):
            cur = FilterNode(cur, nd.predicate, cur.output)
        else:
            cur = _dc.replace(nd, left=cur)
    return cur


def multijoin_to_ladder(node: MultiJoinNode) -> JoinNode:
    """Reconstruct the exact pairwise ladder a MultiJoinNode fused —
    the executor's full-degrade path and the bit-exactness oracle."""
    acc: PlanNode = node.fact
    out = tuple(node.fact.output)
    ladder = None
    for d, dim in enumerate(node.dims):
        out = out + tuple(dim.output)
        ladder = JoinNode(
            "inner", acc, dim, node.fact_keys[d], node.dim_keys[d],
            None, True, out, distribution=node.distribution,
            build_key_domain=node.dim_domains[d])
        acc = ladder
    return ladder


def star_verdict(root: PlanNode, max_dims: int = 5) -> Optional[str]:
    """EXPLAIN's star-detector verdict for a join-ladder spine: None
    when the spine holds fewer than two joins, else the fuse/decline
    outcome with the stopping reason."""
    got = collect_star(root, max_dims)
    if got is None:
        return None
    _fact, hops, _hoisted, _upper, note = got
    if len(hops) >= 2:
        v = f"fusable k={len(hops)}"
        if note:
            v += f"; stopped: {note}"
        return v
    return f"declined: {note}"


def explain_text(node: PlanNode, indent: int = 0, annotate=None) -> str:
    """EXPLAIN rendering (textual plan like Trino's PlanPrinter).
    `annotate(node) -> str` appends per-node runtime stats
    (EXPLAIN ANALYZE / ExplainAnalyzeOperator's role)."""
    pad = "  " * indent
    if isinstance(node, ScanNode):
        cols = ", ".join(n for n, _ in node.output)
        line = (f"{pad}TableScan[{node.catalog}.{node.schema_name}."
                f"{node.table}] -> [{cols}]")
        if node.predicate is not None:
            line += f", pushdown=[{node.predicate}]"
    elif isinstance(node, FilterNode):
        line = f"{pad}Filter[{node.predicate}]"
    elif isinstance(node, ProjectNode):
        line = f"{pad}Project[{', '.join(n for n, _ in node.output)}]"
    elif isinstance(node, AggregateNode):
        aggs = ", ".join(f"{a.func}({a.out_name})" for a in node.aggs)
        line = (f"{pad}Aggregate[{node.strategy}, keys="
                f"{list(node.group_keys)}, {aggs}]")
    elif isinstance(node, JoinNode):
        line = (f"{pad}Join[{node.kind}, probe={list(node.left_keys)}, "
                f"build={list(node.right_keys)}, "
                f"dist={node.distribution}]")
    elif isinstance(node, MultiJoinNode):
        hops = "; ".join(
            f"{list(fk)}={list(dk)}"
            for fk, dk in zip(node.fact_keys, node.dim_keys))
        line = (f"{pad}MultiJoin[star, k={len(node.dims)}, "
                f"keys=[{hops}], dist={node.distribution}]")
    elif isinstance(node, WindowNode):
        fns = ", ".join(s.func for s in node.specs)
        line = (f"{pad}Window[partition={list(node.partition_by)}, "
                f"order={len(node.order_by)} keys, {fns}]")
    elif isinstance(node, SortNode):
        line = f"{pad}{'TopN' if node.limit else 'Sort'}[{len(node.keys)} keys]"
    elif isinstance(node, LimitNode):
        line = f"{pad}Limit[{node.count}]"
    elif isinstance(node, ValuesNode):
        line = f"{pad}Values[{node.num_rows} rows]"
    elif isinstance(node, SetOpNode):
        line = f"{pad}SetOp[{node.op}]"
    elif isinstance(node, UnnestNode):
        line = (f"{pad}Unnest[col={node.array_col} -> "
                f"{node.element_name}"
                f"{', ordinality' if node.ordinality else ''}]")
    elif isinstance(node, RemoteSourceNode):
        line = f"{pad}RemoteSource[fragment {node.fragment_id}]"
    elif isinstance(node, OutputNode):
        line = f"{pad}Output[{', '.join(node.names)}]"
    elif isinstance(node, TableWriterNode):
        line = (f"{pad}TableWriter[{node.catalog}.{node.schema_name}."
                f"{node.table}, {node.fmt}, partition {node.partition}]")
    elif isinstance(node, TableCommitNode):
        line = (f"{pad}TableCommit[{node.catalog}.{node.schema_name}."
                f"{node.table}]")
    else:
        line = f"{pad}{type(node).__name__}"
    if annotate is not None:
        extra = annotate(node)
        if extra:
            line = f"{line}   {extra}"
    return "\n".join([line] + [explain_text(c, indent + 1, annotate)
                               for c in children(node)])
