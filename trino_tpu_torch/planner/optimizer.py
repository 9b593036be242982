"""Port copy of ``trino_tpu/planner/optimizer.py`` (no edits beyond import
targets noted inline).

Plan optimizer passes.

Reference: Trino runs 113 ordered optimizer passes (PlanOptimizers.java:274).
The load-bearing ones for this engine so far:

- predicate pushdown and join-key extraction happen during planning
  (planner.py, mirroring PredicatePushDown + equi-clause extraction)
- column pruning (this file) — PruneUnreferencedOutputs: restrict every
  scan to the columns the query actually touches and renumber references.
  On columnar TPU execution this directly cuts HBM traffic and
  host->device transfer, the analog of its I/O saving in the reference.
"""

from __future__ import annotations

from typing import Dict, Tuple

from .. import ir
from . import logical as L


def prune_plan(root: L.OutputNode) -> L.OutputNode:
    n = len(root.child.output)
    child, mapping = _prune(root.child, frozenset(range(n)))
    # root requires every column; restore identity order if pruning
    # renumbered anything
    if len(child.output) != n or \
            not all(mapping.get(i) == i for i in range(n)):
        child = L.ProjectNode(
            child,
            tuple(ir.ColumnRef(mapping[i], root.child.output[i][1])
                  for i in range(n)),
            tuple(root.child.output))
    child = push_scan_predicates(child)
    return L.OutputNode(child, root.names, tuple(root.child.output))


def pushable_conjuncts(predicate: ir.Expr):
    """Split a predicate into top-level AND conjuncts and keep the ones a
    zone map can evaluate: single-column range/equality/IN/IS [NOT] NULL
    with literal bounds (TupleDomain extraction,
    DomainTranslator.getExtractionResult in the reference). NOT / OR /
    casts / multi-column shapes are skipped — they stay residual-only."""
    out = []
    stack = [predicate]
    while stack:
        e = stack.pop()
        if isinstance(e, ir.Logical) and e.op == "and":
            stack.extend(e.args)
            continue
        if isinstance(e, ir.Compare):
            lc = isinstance(e.left, ir.ColumnRef) and \
                isinstance(e.right, ir.Literal)
            rc = isinstance(e.right, ir.ColumnRef) and \
                isinstance(e.left, ir.Literal)
            if lc:
                out.append(e)
            elif rc:
                flip = {"=": "=", "<>": "<>", "<": ">", "<=": ">=",
                        ">": "<", ">=": "<="}
                out.append(ir.Compare(flip[e.op], e.right, e.left))
        elif isinstance(e, ir.Between):
            if isinstance(e.arg, ir.ColumnRef) and \
                    isinstance(e.low, ir.Literal) and \
                    isinstance(e.high, ir.Literal):
                out.append(e)
        elif isinstance(e, ir.InList):
            if isinstance(e.arg, ir.ColumnRef) and \
                    all(isinstance(v, ir.Literal) for v in e.values):
                out.append(e)
        elif isinstance(e, ir.IsNull):
            if isinstance(e.arg, ir.ColumnRef):
                out.append(e)
        elif isinstance(e, ir.DictPredicate):
            # varchar =/range/LIKE/IN lower to a code->bool LUT; pools are
            # sorted, so zone [min_code, max_code] bounds evaluate it
            if isinstance(e.arg, ir.ColumnRef):
                out.append(e)
    return out


def push_scan_predicates(node: L.PlanNode) -> L.PlanNode:
    """Copy the zone-map-evaluable conjuncts of every Filter sitting
    directly above a ScanNode into the scan's advisory `predicate` slot.
    The Filter itself is untouched: it is the residual that guarantees
    bit-exact results whether or not execution skips anything."""
    import dataclasses as _dc
    if isinstance(node, L.FilterNode) and \
            isinstance(node.child, L.ScanNode) and \
            node.child.catalog not in ("system", "information_schema"):
        conj = pushable_conjuncts(node.predicate)
        if conj:
            pushed = conj[0] if len(conj) == 1 else \
                ir.Logical("and", tuple(conj))
            return _dc.replace(
                node, child=_dc.replace(node.child, predicate=pushed))
        return node
    changes = {}
    for f in _dc.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, L.PlanNode):
            nv = push_scan_predicates(v)
            if nv is not v:
                changes[f.name] = nv
        elif isinstance(v, tuple) and v and \
                all(isinstance(x, L.PlanNode) for x in v):
            nt = tuple(push_scan_predicates(x) for x in v)
            if any(a is not b for a, b in zip(nt, v)):
                changes[f.name] = nt
    return _dc.replace(node, **changes) if changes else node


def _identity(n: int) -> Dict[int, int]:
    return {i: i for i in range(n)}


def _narrow_to(node: L.PlanNode, mapping: Dict[int, int],
               needed) -> Tuple[L.PlanNode, Dict[int, int]]:
    """Project `node` down to exactly the columns `needed` (old indices)
    when it kept extras; mapping entries outside `needed` drop."""
    keep = sorted({mapping[i] for i in needed})
    if len(keep) >= len(node.output):
        return node, mapping
    remap = {old: new for new, old in enumerate(keep)}
    proj = L.ProjectNode(
        node,
        tuple(ir.ColumnRef(i, node.output[i][1]) for i in keep),
        tuple(node.output[i] for i in keep))
    return proj, {orig: remap[m] for orig, m in mapping.items()
                  if m in remap}


def _prune(node: L.PlanNode, needed: frozenset):
    """Returns (new_node, mapping old_index -> new_index). The new node's
    output covers at least `needed` (supersets allowed)."""

    if isinstance(node, L.ScanNode):
        keep = sorted(needed) if needed else [0]
        mapping = {old: new for new, old in enumerate(keep)}
        predicate = node.predicate
        if predicate is not None:
            refs = ir.referenced_columns(predicate)
            if refs <= set(keep):
                predicate = ir.remap_columns(predicate, mapping)
            else:
                # a referenced column was pruned away: dropping the
                # pushdown is always safe (it only enables skipping)
                predicate = None
        return L.ScanNode(
            node.catalog, node.schema_name, node.table, node.table_schema,
            tuple(node.column_indices[i] for i in keep),
            tuple(node.output[i] for i in keep),
            predicate=predicate), mapping

    if isinstance(node, L.FilterNode):
        child_needed = needed | ir.referenced_columns(node.predicate)
        child, m = _prune(node.child, frozenset(child_needed))
        return L.FilterNode(child, ir.remap_columns(node.predicate, m),
                            child.output), m

    if isinstance(node, L.ProjectNode):
        # empty keep is fine: a zero-column projection still carries the
        # live mask (count(*)-only aggregations need nothing else)
        keep = sorted(needed)
        child_needed = set()
        for i in keep:
            child_needed |= ir.referenced_columns(node.exprs[i])
        child, m = _prune(node.child, frozenset(child_needed))
        exprs = tuple(ir.remap_columns(node.exprs[i], m) for i in keep)
        output = tuple(node.output[i] for i in keep)
        mapping = {old: new for new, old in enumerate(keep)}
        return L.ProjectNode(child, exprs, output), mapping

    if isinstance(node, L.AggregateNode):
        child_needed = set(node.group_keys)
        for a in node.aggs:
            if a.arg is not None:
                child_needed |= ir.referenced_columns(a.arg)
        child, m = _prune(node.child, frozenset(child_needed))
        aggs = tuple(
            L.AggSpecNode(a.func,
                          None if a.arg is None
                          else ir.remap_columns(a.arg, m),
                          a.out_name, a.out_dtype, a.distinct)
            for a in node.aggs)
        return L.AggregateNode(
            child, tuple(m[k] for k in node.group_keys), aggs,
            node.strategy, node.key_domains, node.out_capacity,
            node.output), _identity(len(node.output))

    if isinstance(node, L.JoinNode):
        n_probe = len(node.left.output)
        # the residual addresses the probe++build pair layout, even for
        # semi/anti joins whose own output is probe-only
        res_refs = set() if node.residual is None else \
            ir.referenced_columns(node.residual)
        probe_needed = {i for i in needed if i < n_probe} | \
            set(node.left_keys) | {i for i in res_refs if i < n_probe}
        build_needed = {i - n_probe for i in needed if i >= n_probe} | \
            set(node.right_keys) | \
            {i - n_probe for i in res_refs if i >= n_probe}
        left, ml = _prune(node.left, frozenset(probe_needed))
        right, mr = _prune(node.right, frozenset(build_needed))
        # children may keep MORE than needed (supersets: their own
        # filter/key columns). Dead columns in a join's input are not
        # just metadata — the build batch carries them at runtime,
        # growing every payload gather and defeating value-packed LUTs
        # — so narrow each side with a projection when it over-kept.
        left, ml = _narrow_to(left, ml, probe_needed)
        right, mr = _narrow_to(right, mr, build_needed)
        n_new_probe = len(left.output)
        # pair mapping covers probe++build regardless of join kind (the
        # residual uses it); the returned mapping is restricted to the
        # node's own output layout (probe-only for semi/anti)
        pair_mapping = {}
        for old, new in ml.items():
            pair_mapping[old] = new
        for old, new in mr.items():
            pair_mapping[n_probe + old] = n_new_probe + new
        mapping = {old: new for old, new in pair_mapping.items()
                   if old < len(node.output)}
        residual = None if node.residual is None else \
            ir.remap_columns(node.residual, pair_mapping)
        if node.kind == "mark":
            # output = probe ++ $mark: the mark column rides along at the
            # end regardless of probe pruning
            output = tuple(left.output) + (node.output[n_probe],)
            mapping[n_probe] = n_new_probe
        elif node.kind in ("inner", "left"):
            output = tuple(left.output) + tuple(right.output)
        else:
            output = tuple(left.output)
        return L.JoinNode(
            node.kind, left, right,
            tuple(ml[k] for k in node.left_keys),
            tuple(mr[k] for k in node.right_keys),
            residual, node.build_unique, output,
            null_aware=node.null_aware,
            distribution=node.distribution,
            build_key_domain=node.build_key_domain), mapping

    if isinstance(node, L.WindowNode):
        c = len(node.child.output)
        child_needed = {i for i in needed if i < c} | \
            set(node.partition_by) | {k.index for k in node.order_by} | \
            {s.arg for s in node.specs if s.arg is not None}
        child, m = _prune(node.child, frozenset(child_needed))
        nc = len(child.output)
        specs = tuple(
            L.WinSpecNode(s.func, None if s.arg is None else m[s.arg],
                          s.frame, s.offset, s.default, s.out_name,
                          s.out_dtype)
            for s in node.specs)
        mapping = dict(m)
        for j in range(len(node.specs)):
            mapping[c + j] = nc + j
        return L.WindowNode(
            child, tuple(m[i] for i in node.partition_by),
            tuple(L.SortKey(m[k.index], k.ascending, k.nulls_first)
                  for k in node.order_by),
            specs,
            tuple(child.output) + tuple(node.output[c:])), mapping

    if isinstance(node, L.UnnestNode):
        c = len(node.child.output)
        child_needed = {i for i in needed if i < c} | {node.array_col}
        child, m = _prune(node.child, frozenset(child_needed))
        nc = len(child.output)
        mapping = dict(m)
        mapping[c] = nc                       # element column
        if node.ordinality:
            mapping[c + 1] = nc + 1
        return L.UnnestNode(
            child, m[node.array_col], node.array_pool,
            node.element_name, node.element_dtype, node.element_pool,
            node.ordinality,
            tuple(child.output) + tuple(node.output[c:])), mapping

    if isinstance(node, L.SortNode):
        child_needed = needed | {k.index for k in node.keys}
        child, m = _prune(node.child, frozenset(child_needed))
        keys = tuple(L.SortKey(m[k.index], k.ascending, k.nulls_first)
                     for k in node.keys)
        return L.SortNode(child, keys, node.limit, child.output), m

    if isinstance(node, L.LimitNode):
        child, m = _prune(node.child, needed)
        return L.LimitNode(child, node.count, child.output), m

    if isinstance(node, L.ValuesNode):
        keep = sorted(needed)
        mapping = {old: new for new, old in enumerate(keep)}
        return L.ValuesNode(
            tuple(node.arrays[i] for i in keep),
            tuple(node.valids[i] for i in keep),
            node.num_rows,
            tuple(node.fields[i] for i in keep),
            tuple(node.output[i] for i in keep)), mapping

    if isinstance(node, L.MultiJoinNode):
        # The fused star probe consumes every fact/dim column that the
        # ladder it replaces would have; keep children exact (scans
        # beneath them still prune via their own Project/Filter layers)
        fact = _prune_exact(node.fact,
                            frozenset(range(len(node.fact.output))))
        dims = tuple(_prune_exact(d, frozenset(range(len(d.output))))
                     for d in node.dims)
        return L.MultiJoinNode(
            fact, dims, node.fact_keys, node.dim_keys, node.dim_domains,
            node.output, node.distribution), _identity(len(node.output))

    if isinstance(node, L.SetOpNode):
        # distinct/intersect/except semantics are over the whole row:
        # children must keep every column, in order
        nall = frozenset(range(len(node.output)))
        left = _prune_exact(node.left, nall)
        right = _prune_exact(node.right, nall)
        return L.SetOpNode(node.op, left, right, node.left_remaps,
                           node.right_remaps,
                           node.output), _identity(len(node.output))

    raise NotImplementedError(type(node).__name__)


def _prune_exact(node: L.PlanNode, needed: frozenset) -> L.PlanNode:
    """Prune a subtree but guarantee the original column order/layout
    (re-projecting if the child renumbered anything)."""
    n = len(node.output)
    child, mapping = _prune(node, needed)
    if len(child.output) == n and all(mapping.get(i) == i
                                      for i in range(n)):
        return child
    return L.ProjectNode(
        child,
        tuple(ir.ColumnRef(mapping[i], node.output[i][1])
              for i in range(n)),
        tuple(node.output))
