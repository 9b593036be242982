"""Port copy of ``trino_tpu/planner/fragmenter.py`` (no edits beyond import
targets noted inline).

Plan fragmenter: cut a logical plan into a tree of stages.

Reference: PlanFragmenter (sql/planner/PlanFragmenter.java:126) cuts the
plan at exchange boundaries into PlanFragments; PhasedExecutionSchedule
(execution/scheduler/PhasedExecutionSchedule.java:81) orders them so join
build sides complete before their probes start.

TPU shape: the probe spine (driver fact-table scan up to the root) stays
one fragment — it is the chunk/split-streamed pipeline. Every *heavy* join
build side becomes its own fragment, cut at a RemoteSourceNode. Build
fragments schedule bottom-up (phased); each one's materialized output is
broadcast into its consumer (Trino's REPLICATED distribution — the right
default on a TPU mesh, where the build must be device-resident on every
chip anyway; per-chip-partitioned builds ride the in-jit all_to_all path in
parallel/stages.py instead of this runtime).

"Heavy" = the subtree does real work: contains a join/aggregate/window, or
scans >= min_build_rows rows. Light builds (nation, region) stay inline in
the consumer fragment — shipping 25 rows is cheaper than a stage round
trip, the same reasoning as Trino's broadcast-small-table rule
(DetermineJoinDistributionType.java:51).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from . import logical as L


@dataclass
class Fragment:
    """One schedulable unit (PlanFragment's role)."""
    id: int
    root: L.PlanNode               # contains RemoteSourceNodes for deps
    depends_on: Tuple[int, ...]    # producer fragment ids
    partitioning: str              # 'broadcast' (build) | 'source' (probe
    #                                spine + root: split-streamed)
    est_rows: int = 0              # largest scan in the fragment


def _subtree_nodes(node: L.PlanNode):
    yield node
    for c in L.children(node):
        yield from _subtree_nodes(c)


def _scan_rows(catalog, s: L.ScanNode) -> int:
    try:
        return catalog.get_table(s.catalog, s.schema_name, s.table).num_rows
    except Exception:            # noqa: BLE001 — stats probe only
        return 0


def _is_heavy(node: L.PlanNode, catalog, min_build_rows: int) -> bool:
    for n in _subtree_nodes(node):
        if isinstance(n, (L.JoinNode, L.AggregateNode, L.WindowNode)):
            return True
        if isinstance(n, L.ScanNode) and \
                _scan_rows(catalog, n) >= min_build_rows:
            return True
    return False


def fragment_plan(root: L.OutputNode, catalog,
                  min_build_rows: int = 100_000) -> List[Fragment]:
    """Cut heavy join build sides into fragments. Returns fragments in
    dependency (phased) order; the last entry is the root fragment whose
    tree contains RemoteSourceNodes for every other fragment."""
    import dataclasses as _dc

    frags: List[Fragment] = []
    counter = [0]

    def rewrite(node: L.PlanNode) -> Tuple[L.PlanNode, Tuple[int, ...]]:
        """Top-down rebuild; returns (rewritten node, direct fragment
        deps). A heavy join build side is cut here and NOT re-traversed
        by its consumer — its own heavy builds were cut in the recursion,
        so deep join trees produce deep stage trees."""
        if isinstance(node, L.JoinNode) and \
                _is_heavy(node.right, catalog, min_build_rows):
            left, dl = rewrite(node.left)
            sub_root, sub_deps = rewrite(node.right)
            counter[0] += 1
            fid = counter[0]
            est = max((_scan_rows(catalog, s)
                       for s in _subtree_nodes(sub_root)
                       if isinstance(s, L.ScanNode)), default=0)
            frags.append(Fragment(fid, sub_root, sub_deps, "broadcast",
                                  est))
            right = L.RemoteSourceNode(fid, node.right.output)
            return _dc.replace(node, left=left, right=right), dl + (fid,)
        deps: Tuple[int, ...] = ()
        changes = {}
        for f in _dc.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, L.PlanNode):
                nv, d = rewrite(v)
                deps += d
                if nv is not v:
                    changes[f.name] = nv
        return (_dc.replace(node, **changes) if changes else node), deps

    new_root, deps = rewrite(root)
    counter[0] += 1
    est = max((_scan_rows(catalog, s) for s in _subtree_nodes(new_root)
               if isinstance(s, L.ScanNode)), default=0)
    frags.append(Fragment(counter[0], new_root, deps, "source", est))
    return frags


def explain_fragments(frags: List[Fragment]) -> str:
    """Distributed-plan rendering (PlanPrinter.textDistributedPlan)."""
    out = []
    for f in frags:
        deps = f" <- fragments {list(f.depends_on)}" if f.depends_on else ""
        out.append(f"Fragment {f.id} [{f.partitioning}]{deps}")
        out.append(L.explain_text(f.root, indent=1))
    return "\n".join(out)
