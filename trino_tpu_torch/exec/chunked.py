"""Bounded-memory plan execution: the big table streams in chunks.

Counterpart of ``trino_tpu/exec/chunked.py`` (Trino's spill tier —
SpillableHashAggregationBuilder merging partial states, the spilling
join's partition-at-a-time consumption, triggered by memory watermarks).
The plan's largest table (the fact table) never materializes on the
device whole; it streams through the per-chunk path in fixed-size chunks:

    for chunk in fact_table:            # sliced from the fact cache on
        partial = run(plan_path(chunk)) # the card, or decoded from host
    merged = re_aggregate(partials)     # MERGE step
    result = run(rest_of_plan, merged)

Join build sides (dimension tables) run once and stay pinned for the whole
loop. Shapes handled: Filter/Project/Join(probe side)/MultiJoin(fact side)
paths above the driver scan, up to the first aggregate (partial states
merge by re-aggregation) or the plan root (outputs concatenate on host).

Where the reference traces the per-chunk path into ONE jitted program,
the port composes it as a Python closure of torch operations per plan
structure (``compile_fused_chunk``, held in ``Executor._fused_cache``):
eager torch needs no trace, and the closure issues no host sync, so the
chunk loop only enqueues work on the card. The one fetch of the loop is
``_verify_record_adaptation``'s, after the last chunk.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import ir
from ..batch import (Batch, Column, batch_from_numpy, batch_to_numpy,
                     bucket_capacity, torch_dtype)
from ..planner import logical as L
from ..planner.fragmenter import _subtree_nodes
from .device_cache import prof as _prof
from .device_cache import profile_enabled as _profile_enabled

_INT_LANES = (torch.int8, torch.uint8, torch.int16, torch.int32,
              torch.int64)


def _is_int_lane(dtype: torch.dtype) -> bool:
    """Integer lane (bool is not one, as in jnp.issubdtype)."""
    return dtype in _INT_LANES


def _slice_widen(cap: int, wide_names: tuple, datas, valids, start: int,
                 end: int, num_rows: int) -> Batch:
    """Slice one chunk straight from device-resident narrowed columns
    (exec/device_cache.py) and widen it to the engine's lane dtypes. The
    slice offset clamps so the last (short) chunk re-reads the tail of the
    previous one, with the live mask excluding the overlap: every chunk
    has the same capacity and never touches the host."""
    s0 = min(max(start, 0), max(num_rows - cap, 0))
    dev = datas[0].device
    cols = []
    for a, v, wn in zip(datas, valids, wide_names):
        sl = a[s0:s0 + cap]
        wide = torch_dtype(wn)
        data = sl if sl.dtype == wide else sl.to(wide)
        valid = torch.ones(cap, dtype=torch.bool, device=dev) if v is None \
            else v[s0:s0 + cap]
        cols.append(Column(data, valid))
    idx = torch.arange(s0, s0 + cap, dtype=torch.int64, device=dev)
    live = (idx >= start) & (idx < end)
    return Batch(tuple(cols), live)


# partial-state merge functions (HashAggregationOperator's intermediate-
# state combine): min/max idempotent, sums/counts add
MERGE_FUNC = {"sum": "sum", "count": "sum", "count_star": "sum",
              "min": "min", "max": "max"}


def _fused_join_ok(node: L.JoinNode) -> bool:
    return (node.kind in ("inner", "left", "semi", "anti") and
            node.build_key_domain is not None and node.build_unique and
            node.residual is None and not node.null_aware and
            len(node.left_keys) == 1)


def _spine_joins(target: L.PlanNode, driver: L.ScanNode) \
        -> Optional[List[L.JoinNode]]:
    """JoinNodes on the driver's probe spine, bottom-up (the order
    compile_fused_chunk's emit() appends them). None when any spine join
    cannot run in the fused program."""
    joins: List[L.JoinNode] = []

    def walk(node) -> bool:
        if node is driver:
            return True
        if isinstance(node, (L.FilterNode, L.ProjectNode,
                             L.AggregateNode)):
            return walk(node.child)
        if isinstance(node, L.JoinNode):
            if _fused_join_ok(node) and walk(node.left):
                joins.append(node)
                return True
            return False
        return False

    return joins if walk(target) else None


# value-packing caps: at most this many payload columns, and the packed
# word must fit int64 with the sign bit untouched
_PACK_MAX_COLS = 4
_PACK_MAX_BITS = 62


def _plan_packing(build: Batch, node: L.JoinNode, mins, maxs):
    """Static packing meta for a build whose payload values fit one word:
    ((col_idx, lo, width, val_off, valid_off), ...), word dtype name. None
    when not packable (the caller keeps the row-id LUT)."""
    bkey = node.right_keys[0] if len(node.right_keys) == 1 else None
    payload = [i for i in range(len(build.columns)) if i != bkey]
    if len(payload) > _PACK_MAX_COLS:
        return None
    meta = []
    off = 1                                   # bit 0 = presence
    for j, i in enumerate(payload):
        if not _is_int_lane(build.columns[i].data.dtype):
            return None
        lo, hi = int(mins[j]), int(maxs[j])
        if hi < lo:
            lo, hi = 0, 0
        width = max(1, int(hi - lo + 1).bit_length())
        meta.append((i, lo, width, off, off + width))
        off += width + 1
    if off > _PACK_MAX_BITS:
        return None
    word_dtype = "int8" if off <= 7 else "int16" if off <= 15 else \
        "int32" if off <= 31 else "int64"
    return tuple(meta), word_dtype


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def compile_fused_chunk(executor, target: L.PlanNode, driver: L.ScanNode,
                        lut_specs=None, adapt=None,
                        gather_mode: str = "off"):
    """Compose the whole per-chunk path (joins with prebuilt LUTs, filters,
    projections, the partial aggregate) into one function of torch
    operations, so every chunk runs with no host sync. Supported shape:
    Filter/Project chains, single-key unique-build dense joins (driver on
    the probe side), and a direct/global partial aggregate on top.

    `lut_specs` maps id(join node) -> spec from _fused_luts: ("rows",)
    joins gather per payload column off a row-id LUT; ("packed", meta,
    word_dtype, bkey, out_dtypes) joins decode everything from one
    value-packed gather.

    `adapt` applies a previous run's measurements (AdaptivePlanner's role,
    replayed through the decision cache): {"windows": {join_idx: W}}
    probes a packed join through a W-entry window (near-sorted keys);
    {"compact": (join_idx, cap)} compacts live rows to `cap` after that
    join. Both are guesses new data may break, so the program reports per
    join (escaped, span, live) and the compaction overflow in a stats
    vector the driver verifies (nonzero escaped/overflow => rerun plain).

    `gather_mode` routes windowed packed probes through K2
    (ops/gather.gather_word_windowed): the driver prepares each LUT's
    planes once and passes them as the fourth argument; K2's escapes fold
    into the same escaped count.

    Returns (fn, join_nodes) where fn(chunk, builds, luts, gplanes) ->
    (partial Batch, stats int64[2 + 3*n_joins]); stats layout:
    [escaped_total, compact_overflow, span_0, live_0, 0, span_1, ...].
    None when the shape does not apply (the caller runs the per-node
    loop)."""
    from ..ops.aggregate import (AggSpec, direct_group_aggregate,
                                 global_aggregate)
    from ..ops.join import (compact_live, dense_join_packed,
                            dense_join_packed_windowed, dense_join_with_lut)
    from ..ops.project import apply_filter, project

    joins: List[L.JoinNode] = []
    windows = (adapt or {}).get("windows", {})
    compact_at = (adapt or {}).get("compact")

    def zero(chunk):
        return torch.zeros((), dtype=torch.int64, device=chunk.device)

    def emit(node):
        """Returns f(chunk, builds, luts, gplanes) -> (Batch, stats dict)
        or None. stats: {"escaped": scalar, "overflow": scalar, "joins":
        [(span, live), ...]}."""
        if node is driver:
            return lambda chunk, builds, luts, gp: (chunk, {
                "escaped": zero(chunk), "overflow": zero(chunk),
                "joins": []})
        if isinstance(node, (L.FilterNode, L.ProjectNode)):
            base, preds, exprs = _compose_segment(executor, node, driver)
            child = emit(base)
            if child is None:
                return None

            def run_segment(chunk, b, lt, g, _child=child, _preds=preds,
                            _exprs=exprs):
                bt, st = _child(chunk, b, lt, g)
                for pred in _preds:
                    bt = apply_filter(bt, pred)
                if _exprs is not None:
                    bt = project(bt, _exprs)
                return bt, st
            return run_segment
        if isinstance(node, L.JoinNode):
            if not _fused_join_ok(node):
                return None
            child = emit(node.left)
            if child is None:
                return None
            idx = len(joins)
            joins.append(node)
            lk, rk, kind = node.left_keys, node.right_keys, node.kind
            spec = lut_specs.get(id(node)) if lut_specs else None
            window = windows.get(idx)
            cap = compact_at[1] if compact_at is not None and \
                compact_at[0] == idx else None

            def run_join(chunk, b, lt, g, _child=child, _idx=idx, _lk=lk,
                         _rk=rk, _kind=kind, _spec=spec, _win=window,
                         _cap=cap):
                bt, st = _child(chunk, b, lt, g)
                esc = zero(chunk)
                if _spec is not None and _spec[0] == "packed":
                    _, meta, wd, bkey, out_dtypes = _spec
                    if _win is not None:
                        gp = g[_idx] if _idx < len(g) else None
                        out, esc, span = dense_join_packed_windowed(
                            bt, lt[_idx], _lk, meta, bkey, out_dtypes,
                            _kind, _win, word_dtype=wd,
                            gather_mode=gather_mode, lut_planes=gp)
                    else:
                        out = dense_join_packed(
                            bt, lt[_idx], _lk, meta, bkey, out_dtypes,
                            _kind, gather_mode)
                        span = _key_span(bt, _lk)
                else:
                    out = dense_join_with_lut(bt, b[_idx], lt[_idx], _lk,
                                              _rk, _kind, gather_mode)
                    span = _key_span(bt, _lk)
                live = out.live.sum(dtype=torch.int64)
                if _cap is not None:
                    out, over = compact_live(out, _cap)
                    st = dict(st, overflow=st["overflow"] + over)
                return out, dict(st, escaped=st["escaped"] + esc,
                                 joins=st["joins"] + [(span, live)])
            return run_join
        if isinstance(node, L.AggregateNode):
            child = emit(node.child)
            if child is None:
                return None
            if any(a.distinct for a in node.aggs):
                return None
            aggs = tuple(AggSpec(a.func, a.arg.index
                                 if a.arg is not None else None)
                         for a in node.aggs)
            if node.strategy == "global":
                def run_gagg(chunk, b, lt, g, _child=child, _aggs=aggs):
                    bt, st = _child(chunk, b, lt, g)
                    return global_aggregate(bt, _aggs), st
                return run_gagg
            if node.strategy == "direct":
                keys, domains = node.group_keys, node.key_domains

                def run_dagg(chunk, b, lt, g, _child=child, _aggs=aggs,
                             _keys=keys, _domains=domains):
                    bt, st = _child(chunk, b, lt, g)
                    return direct_group_aggregate(
                        bt, _keys, _domains, _aggs), st
                return run_dagg
            return None
        return None

    inner = emit(target)
    if inner is None:
        return None

    def fn(chunk, builds, luts, gplanes=()):
        out, st = inner(chunk, builds, luts, gplanes)
        parts = [st["escaped"], st["overflow"]]
        for span, live in st["joins"]:
            parts.extend((span, live, zero(chunk)))
        return out, torch.stack(parts)
    return fn, joins


def _compose_segment(executor, node: L.PlanNode, driver: L.ScanNode):
    """A chain of Filter and Project nodes as (base, predicates, exprs):
    the predicates, then the projection (None: none), over the base's
    columns. The reference compiles the whole per-chunk path as one
    program, so XLA sees a DOUBLE chain that spans two projections whole
    and folds its factors as one (ops/project.py `_fold_factor`); the
    port inlines each projection into the nodes above it to do the
    same."""
    segment = []
    while isinstance(node, (L.FilterNode, L.ProjectNode)) and \
            node is not driver:
        segment.append(node)
        node = node.child
    preds, exprs = [], None

    def inline(e):
        if exprs is None:
            return e
        return ir.transform(e, lambda x: exprs[x.index]
                            if isinstance(x, ir.ColumnRef) else None)
    for n in reversed(segment):
        if isinstance(n, L.FilterNode):
            preds.append(inline(executor.fold_scalars(n.predicate)))
        else:
            exprs = tuple(inline(e) for e in
                          executor.fold_scalars_tuple(n.exprs))
    return node, preds, exprs


def _key_span(batch: Batch, keys: tuple):
    """Probe-key extent of live rows (the windowing measurement), over the
    combined key — the key the windowed probe slices by."""
    from ..ops.join import _combined_key
    key, valid = _combined_key(batch, keys)
    ok = batch.live & valid
    big = 1 << 62
    lo = torch.where(ok, key, big).min()
    hi = torch.where(ok, key, -big).max()
    return (hi - lo + 1).clamp(min=0)


def _fused_luts(executor, joins) -> Optional[tuple]:
    """Build and validate the dense LUT of every fused join, value-packed
    whenever the payload fits one word (probe = one gather), a row-id LUT
    otherwise. LUT+spec pairs of deterministic builds reuse the cross-run
    cache; their stats and dup/oob validations ride the decision cache
    (sync-free on replay). Uncacheable builds fuse all stats into one
    fetch and all validations into a second. Any violation aborts the
    fused path (the per-node loop has the graceful fallbacks)."""
    from ..ops.join import dense_build_lut, dense_build_packed_lut
    n = len(joins)
    builds = [executor.run(j.right) for j in joins]
    luts: List[object] = [None] * n
    specs: List[object] = [None] * n
    fresh: List[int] = []
    keys: List[object] = [None] * n
    for k, node in enumerate(joins):
        keys[k] = executor.build_structure_key(node.right)
        hit = executor._lut_cache.get((keys[k], node.build_key_domain)) \
            if keys[k] is not None else None
        if hit is not None:
            luts[k], specs[k] = hit
        else:
            fresh.append(k)
    if fresh:
        big = 1 << 62

        def minmax_parts(k):
            b, j = builds[k], joins[k]
            bkey = j.right_keys[0]
            parts = []
            for i in range(len(b.columns)):
                if i == bkey:
                    continue
                col = b.columns[i]
                if _is_int_lane(col.data.dtype):
                    m = b.live & col.valid
                    d = col.data.to(torch.int64)
                    parts.append(torch.where(m, d, big).min())
                    parts.append(torch.where(m, d, -big).max())
                else:
                    parts.append(torch.full((), big, dtype=torch.int64,
                                            device=b.device))
                    parts.append(torch.full((), -big, dtype=torch.int64,
                                            device=b.device))
            return parts

        def build_one(k, mins, maxs):
            """Build LUT k; returns (dup_signal, oob) device scalars."""
            b, j = builds[k], joins[k]
            if j.kind in ("semi", "anti"):
                pk = ((), "int8")         # presence bit only
            else:
                pk = _plan_packing(b, j, mins, maxs)
            if pk is not None:
                meta, wd = pk
                lut, exp, oob, occ = dense_build_packed_lut(
                    b, j.right_keys, j.build_key_domain, meta, wd)
                specs[k] = ("packed", meta, wd, j.right_keys[0],
                            tuple(_dtype_name(c.data.dtype)
                                  for c in b.columns))
                dup_sig = exp - occ           # > 0 = duplicate keys
            else:
                lut, dup, oob = dense_build_lut(b, j.right_keys,
                                                j.build_key_domain)
                specs[k] = ("rows",)
                dup_sig = dup.to(torch.int64)
            luts[k] = lut
            return dup_sig, oob

        def join_tag(base, j):
            return (f"{base}:{tuple(j.right_keys)}:{j.kind}:"
                    f"{j.build_key_domain}")

        cacheable = [k for k in fresh if keys[k] is not None]
        fused_rest = [k for k in fresh if keys[k] is None]
        for k in cacheable:
            j = joins[k]
            parts = minmax_parts(k)
            vals = np.asarray(executor.fetch_ints(
                j.right, join_tag("fusedminmax", j), *parts),
                dtype=np.int64) if parts else np.zeros(0, np.int64)
            dup_sig, oob = build_one(k, vals[0::2], vals[1::2])
            check = executor.fetch_ints(
                j.right, join_tag("fusedlutcheck", j), dup_sig, oob)
            if check[0] != 0 or check[1] != 0:
                return None
        if fused_rest:
            all_parts = [minmax_parts(k) for k in fused_rest]
            flat = [p for ps in all_parts for p in ps]
            vals = np.asarray(torch.stack(flat).tolist(), dtype=np.int64) \
                if flat else np.zeros(0, np.int64)
            pos, checks = 0, []
            for k, ps in zip(fused_rest, all_parts):
                vk = vals[pos:pos + len(ps)]
                pos += len(ps)
                checks.extend(build_one(k, vk[0::2], vk[1::2]))
            if int(torch.stack(checks).sum()) != 0:
                return None
        for k in fresh:
            if keys[k] is not None:
                if len(executor._lut_cache) >= 4:
                    executor._lut_cache.pop(
                        next(iter(executor._lut_cache)))
                executor._lut_cache[(keys[k], joins[k].build_key_domain)] \
                    = (luts[k], specs[k])
    return tuple(builds), tuple(luts), tuple(specs)


def _windowed_planes(gmode: str, adapt, specs, luts, k):
    """K2's prepared planes for join k's LUT, or None when K2 will not run
    for it (mode off, not adapted to a window, not value-packed, or a
    domain too wide for 32-bit kernel indices)."""
    from ..ops import gather
    windows = (adapt or {}).get("windows", {})
    if gmode == "off" or k not in windows or specs[k] is None or \
            specs[k][0] != "packed" or \
            luts[k].shape[0] > gather.MAX_WINDOWED_ELEMS:
        return None
    return gather.prepare_word_planes(luts[k])


# adaptive re-optimization safety margin: windows and capacities pad the
# measured maxima so ordinary chunk-to-chunk variance does not trip the
# rerun path; real data changes still do (and then re-measure)
_ADAPT_MARGIN = 1.25


def _fused_adaptation(executor, skey, spine, specs, chunk_cap):
    """The `adapt` argument for compile_fused_chunk from a previous run's
    recorded measurements (decision cache): window sizes for packed joins
    with near-sorted probe keys, and one compaction point where the
    measured selectivity is low. None on the first run (the plain program
    measures)."""
    if skey is None:
        return None
    rec = executor.decision(("fusedadapt", skey, executor._decision_salt()))
    if rec is None or len(rec) != 2 * len(spine):
        return None
    allow_compact = executor.enable_adapt_compact
    windows = {}
    compact = None
    for i, j in enumerate(spine):
        span, live = rec[2 * i], rec[2 * i + 1]
        domain = j.build_key_domain
        if specs[i] is not None and specs[i][0] == "packed" and \
                span > 0 and domain:
            w = bucket_capacity(int(span * _ADAPT_MARGIN))
            if w * 2 <= domain:      # the window must actually shrink reads
                windows[i] = w
        if allow_compact and compact is None and live >= 0:
            # off by default, as in the reference (its in-program
            # compaction lost on the TPU unless later stages were wide)
            c = max(1024, bucket_capacity(int(live * _ADAPT_MARGIN)))
            if c * 4 <= chunk_cap:   # pay the compaction only when later
                compact = (i, c)     # operators shrink >= 4x
    if not windows and compact is None:
        return None
    return {"windows": windows, "compact": compact}


def _verify_record_adaptation(executor, skey, adapt, chunk_stats) -> bool:
    """ONE fetch over the run's stacked per-chunk stats: correctness flags
    (escaped window rows, compaction overflow) plus span/live maxima.
    Plain runs record measurements for the next run's adaptation; adapted
    runs verify their guesses — False means the results are unusable and
    the caller must rerun plain (the stale record is removed so the rerun
    re-measures)."""
    key = ("fusedadapt", skey, executor._decision_salt()) \
        if skey is not None else None
    if adapt is None and (key is None or
                          executor.decision(key) is not None):
        return True      # nothing to verify or record: skip the sync
    stk = torch.stack(chunk_stats)
    esc = stk[:, 0].sum()
    over = stk[:, 1].sum()
    spans = stk[:, 2::3].amax(dim=0)
    lives = stk[:, 3::3].amax(dim=0)
    vals = torch.cat([torch.stack([esc, over]), spans, lives]).tolist()
    n_joins = spans.shape[0]
    esc_h, over_h = int(vals[0]), int(vals[1])
    measured = []
    for i in range(n_joins):
        measured.extend((int(vals[2 + i]), int(vals[2 + n_joins + i])))
    if esc_h > 0 or over_h > 0:
        if over_h > 0:
            executor.stats.compaction_overflows += 1
        # stale guesses: drop the record so the rerun runs plain and
        # re-measures (an adapted rerun from these numbers could loop —
        # escaped rows depress the live measurement)
        if key is not None:
            executor.drop_decision(key)
        return False
    if adapt is None and key is not None:
        executor.record_decision(key, tuple(measured))
    return True


class ChunkAnalysis:
    """Where to cut the plan for chunked execution."""

    def __init__(self, driver: L.ScanNode,
                 merge_agg: Optional[L.AggregateNode],
                 build_roots: List[L.PlanNode], driver_rows: int,
                 merge_sort: Optional["L.SortNode"] = None):
        self.driver = driver
        self.merge_agg = merge_agg          # None = concat at root
        self.build_roots = build_roots      # pinned once, reused per chunk
        self.driver_rows = driver_rows
        # distributed ORDER BY: the fragment's top Sort; per-split
        # outputs are sorted RUNS the consumer merges order-preservingly
        # (MergeOperator.java's role); only the scheduler opts in
        self.merge_sort = merge_sort


def _scan_rows(catalog, node: L.ScanNode) -> int:
    return catalog.get_table(node.catalog, node.schema_name,
                             node.table).num_rows


def analyze(root: L.OutputNode, catalog, chunk_rows: int,
            allow_sort_merge: bool = False) -> Optional[ChunkAnalysis]:
    """Pick the driver scan and validate the path up to the merge point.
    With allow_sort_merge, a Sort directly below the output becomes the
    fragment top: per-split outputs are sorted runs for an
    order-preserving merge (the distributed scheduler's MergeOperator
    path; the local chunked driver keeps its re-sort semantics)."""
    parents: Dict[int, L.PlanNode] = {}

    def walk(node):
        for c in L.children(node):
            parents[id(c)] = node
            walk(c)
    walk(root)

    scans = [n for n in _subtree_nodes(root) if isinstance(n, L.ScanNode)]
    if not scans:
        return None
    driver = max(scans, key=lambda s: _scan_rows(catalog, s))
    driver_rows = _scan_rows(catalog, driver)
    if driver_rows <= chunk_rows:
        return None

    build_roots: List[L.PlanNode] = []
    merge_agg: Optional[L.AggregateNode] = None
    merge_sort: Optional[L.SortNode] = None
    node: L.PlanNode = driver
    while True:
        parent = parents.get(id(node))
        if parent is None:
            break
        if isinstance(parent, (L.FilterNode, L.ProjectNode)):
            pass
        elif isinstance(parent, L.JoinNode):
            if parent.left is not node:
                return None       # driver on the build side: can't stream
            build_roots.append(parent.right)
        elif isinstance(parent, L.MultiJoinNode):
            # fused star: the driver must BE the fact side; every dimension
            # pins like a pairwise build side, so the dimension tables
            # build once and each chunk probes them sync-free
            if parent.fact is not node:
                return None
            build_roots.extend(parent.dims)
        elif isinstance(parent, L.AggregateNode):
            if any(a.distinct for a in parent.aggs):
                return None       # distinct needs global dedup
            if any(a.func not in MERGE_FUNC for a in parent.aggs):
                return None
            merge_agg = parent
            break
        elif isinstance(parent, L.OutputNode):
            break                 # concat mode
        elif allow_sort_merge and isinstance(parent, L.SortNode) and \
                isinstance(parents.get(id(parent)), L.OutputNode):
            merge_sort = parent
            break
        else:
            return None           # Sort/Window/SetOp/Limit below merge point
        node = parent
    return ChunkAnalysis(driver, merge_agg, build_roots, driver_rows,
                         merge_sort=merge_sort)


class _PrefetchPipeline:
    """Bounded double-buffered decode->stage pipeline for the chunked
    driver: a worker thread decodes chunk k+1 from host columns and copies
    it to the device while the device computes chunk k.

    Every staged chunk holds a REVOCABLE reservation in the memory pool,
    so pressure can reclaim the prefetch buffer: a revoked chunk is simply
    re-decoded inline by the consumer — correctness never depends on
    staging. A fault injected at the SCAN_PREFETCH point raises out of
    next() on the consumer thread. `depth` bounds how many chunks may sit
    decoded but unconsumed.

    On a CUDA device the worker copies on its own stream and records an
    event after each chunk's copy; the consumer makes its stream wait on
    that event (and records the chunk's tensors on its stream for the
    caching allocator) before using the chunk."""

    def __init__(self, executor, starts, decode, depth: int):
        self.executor = executor
        self.pool = executor.pool
        self.decode = decode
        self.decode_s = 0.0
        self.served = 0                     # chunks consumed from staging
        self._staged: Dict[int, tuple] = {}
        self._lock = threading.Lock()
        self._slots = threading.Semaphore(depth)
        self._queue: "queue.Queue[tuple]" = queue.Queue()
        self._stop = False
        dev = torch.device(executor.device)
        self._stream = torch.cuda.Stream(dev) if dev.type == "cuda" \
            else None
        self._revocation = self.pool.register_revocation(
            self._revoke, tag="scan-prefetch")
        self._thread = threading.Thread(
            target=self._run, args=(list(starts),),
            name="scan-prefetch", daemon=True)
        self._thread.start()

    def _revoke(self, target_bytes: int) -> int:
        """Memory-pool revocation callback: drop staged chunks (the
        consumer re-decodes any missing chunk inline)."""
        freed = 0
        with self._lock:
            for s in list(self._staged):
                if freed >= target_bytes:
                    break
                _, b, _ev = self._staged.pop(s)
                self.pool.free_revocable(b, tag="scan-prefetch")
                freed += b
        return freed

    def _decode_staged(self, start: int):
        if self._stream is None:
            return self.decode(start), None
        with torch.cuda.stream(self._stream):
            batch = self.decode(start)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        return batch, ev

    def _run(self, starts) -> None:
        from .memory import batch_bytes
        try:
            for s in starts:
                self._slots.acquire()
                if self._stop:
                    return
                inj = self.executor.failure_injector
                if inj is not None:
                    inj.maybe_fail("SCAN_PREFETCH", f"chunk@{s}")
                t0 = time.monotonic()
                batch, ev = self._decode_staged(s)
                self.decode_s += time.monotonic() - t0
                b = batch_bytes(batch)
                self.pool.reserve_revocable(b, tag="scan-prefetch")
                with self._lock:
                    self._staged[s] = (batch, b, ev)
                _prof(f"prefetch: chunk@{s} staged")
                self._queue.put(("chunk", s))
            self._queue.put(("done", None))
        except BaseException as e:          # surfaces in next()
            self._queue.put(("error", e))

    def next(self, expected_start: int) -> Batch:
        t0 = time.monotonic()
        while True:
            # bounded waits so a stuck worker cannot pin a canceled query:
            # the cooperative check raises and close() reaps the thread
            try:
                kind, val = self._queue.get(timeout=0.25)
                break
            except queue.Empty:
                self.executor.check_cancel()
        if time.monotonic() - t0 > 1e-4:
            self.executor.stats.scan_prefetch_stalls += 1
        if kind == "error":
            raise val
        if kind != "chunk" or val != expected_start:
            raise RuntimeError(f"prefetch out of order: {kind} {val} != "
                               f"{expected_start}")
        with self._lock:
            hit = self._staged.pop(expected_start, None)
        self._slots.release()
        if hit is None:                     # revoked under pressure
            t0 = time.monotonic()
            batch = self.decode(expected_start)
            self.decode_s += time.monotonic() - t0
            return batch
        batch, b, ev = hit
        if ev is not None:
            cur = torch.cuda.current_stream(torch.device(
                self.executor.device))
            cur.wait_event(ev)
            for c in batch.columns:
                c.data.record_stream(cur)
                c.valid.record_stream(cur)
            batch.live.record_stream(cur)
        self.pool.free_revocable(b, tag="scan-prefetch")
        self.executor.stats.scan_prefetched_chunks += 1
        self.served += 1
        return batch

    def close(self) -> None:
        self._stop = True
        self._slots.release()               # unblock a waiting worker
        self._thread.join(timeout=10)
        with self._lock:
            for s in list(self._staged):
                _, b, _ev = self._staged.pop(s)
                self.pool.free_revocable(b, tag="scan-prefetch")
        self.pool.unregister_revocation(self._revocation)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def execute_chunked(executor, root: L.OutputNode) -> Optional[Batch]:
    """Run `root` with the driver scan streamed in chunks. Returns None if
    the plan shape does not support chunking (the caller runs it whole)."""
    chunk_rows = executor.spill_chunk_rows
    plan = analyze(root, executor.catalog, chunk_rows)
    if plan is None:
        return None
    dev = executor.device

    # pin join build sides once (HashBuilderOperator builds once, probes
    # stream). Builds of deterministic sources also persist across runs
    # in a structural-hash cache.
    _prof("pin builds: start")
    for b in plan.build_roots:
        if id(b) not in executor._subst:
            executor._subst[id(b)] = executor.run_cached_build(b)
    _prof("pin builds: done")

    data = executor.catalog.get_table(plan.driver.catalog,
                                      plan.driver.schema_name,
                                      plan.driver.table)
    per_chunk_target = plan.merge_agg if plan.merge_agg is not None \
        else root.child

    # spillable partial-aggregation state: device partials hold revocable
    # reservations; under pressure they move to host pages and the merge
    # re-aggregates partition-wise (exec/spill.PartialState)
    from .spill import PartialState
    partial_state = PartialState(executor) \
        if plan.merge_agg is not None else None
    concat_arrays: List[list] = []
    concat_valids: List[list] = []
    # one shared padded capacity for every chunk
    cap = bucket_capacity(min(chunk_rows, plan.driver_rows))

    # device-resident narrowed fact columns: when the driver scan fits the
    # budget in its narrowest dtypes, chunks slice straight from device
    # memory and the steady state never copies from the host
    fact = None
    if executor.enable_fact_cache and cap <= plan.driver_rows:
        key = (plan.driver.catalog, plan.driver.schema_name,
               plan.driver.table, tuple(plan.driver.column_indices))
        if executor.fact_cache.estimate_bytes(
                data, plan.driver.column_indices) <= \
                executor.fact_cache.max_bytes:
            if executor.fact_cache.get(key) is None:
                # about to claim device memory: raw cached scans are dead
                # weight now (the pinned builds consumed them)
                executor._scan_cache.clear()
                executor._scan_cache_bytes.clear()
            fact = executor.fact_cache.load(
                key, data, plan.driver.column_indices, dev,
                persist_ok=plan.driver.catalog in ("tpch", "tpcds",
                                                   "bench"))
    if fact is not None:
        fact_datas = tuple(c.data for c in fact)
        fact_valids = tuple(c.valid for c in fact)
        fact_wide = tuple(str(np.dtype(c.wide_dtype)) for c in fact)

    # fused pipeline: the whole per-chunk path as one sync-free function
    # (LUTs prebuilt and validated once)
    fused = None
    if plan.merge_agg is not None and not executor.profile and \
            plan.merge_agg.strategy in ("global", "direct") and \
            not any(a.distinct for a in plan.merge_agg.aggs):
        # the strategy gate mirrors compile_fused_chunk's support, so LUTs
        # are never built (device work + a validation fetch) for a plan
        # the fused compiler would then reject
        spine = _spine_joins(per_chunk_target, plan.driver)
        bl = _fused_luts(executor, spine) if spine is not None else None
        if bl is not None:
            builds, luts, specs = bl
            gmode = executor.gather_mode()
            skey = executor.build_structure_key(per_chunk_target)
            adapt = _fused_adaptation(executor, skey, spine, specs, cap)
            # K2's planes are prepared once per pinned LUT
            gplanes = tuple(
                _windowed_planes(gmode, adapt, specs, luts, k)
                for k in range(len(spine)))
            # one program per (plan structure, packing layout, adaptation,
            # gather mode), reused across runs (a replan makes new node
            # objects with identical static values)
            ckey = (skey, specs, repr(adapt), gmode) \
                if skey is not None else None
            program = executor._fused_cache.get(ckey) \
                if ckey is not None else None
            if program is None:
                mine = compile_fused_chunk(
                    executor, per_chunk_target, plan.driver,
                    {id(j): s for j, s in zip(spine, specs)}, adapt,
                    gather_mode=gmode)
                if mine is not None:
                    program = mine[0]
                    if ckey is not None:
                        if len(executor._fused_cache) >= 8:
                            executor._fused_cache.pop(
                                next(iter(executor._fused_cache)))
                        executor._fused_cache[ckey] = program
            if program is not None:
                fused = (program, builds, luts, skey, adapt, gplanes)
                executor.stats.fused_chunk_pipelines += 1
                if gmode != "off":
                    executor.stats.pallas_gather_calls += 1
    _prof(f"luts+fused ready (fused={fused is not None}, "
          f"adapt={fused[4] if fused else None}, fact={fact is not None})")

    # ---- chunk schedule: zone-map pruning skips whole chunks ------------
    # per_chunk_target holds the residual Filter above the driver scan, so
    # a skipped chunk (provably zero matching rows) contributes nothing in
    # both merge-agg and concat modes — bit-exact with skipping off
    starts_all = list(range(0, plan.driver_rows, chunk_rows))
    starts_list = starts_all
    if plan.driver.predicate is not None and \
            executor.enable_zone_map_pruning:
        from . import zonemap
        zm = zonemap.zone_map_for(data, executor.zone_map_rows)
        starts_list = [
            s for s in starts_all
            if zonemap.range_may_match(
                zm, plan.driver.predicate, plan.driver.column_indices,
                s, min(chunk_rows, plan.driver_rows - s))]
        if not starts_list:
            # keep one chunk so downstream shapes and merges stay on the
            # ordinary path; its rows die at the residual filter
            starts_list = starts_all[:1]
        skipped = len(starts_all) - len(starts_list)
        if skipped:
            executor.stats.scan_chunks_skipped += skipped
            executor.strategy_decisions[
                f"TableScan[{plan.driver.table}]"] = \
                f"chunks-skipped:{skipped}/{len(starts_all)}"
            _prof(f"zone maps: {skipped}/{len(starts_all)} chunks skipped")

    def _decode_chunk(start: int) -> Batch:
        arrays = [np.asarray(data.columns[i])[start:start + chunk_rows]
                  for i in plan.driver.column_indices]
        valids = None
        if data.valids is not None:
            valids = [None if data.valids[i] is None else
                      np.asarray(data.valids[i])[start:start + chunk_rows]
                      for i in plan.driver.column_indices]
        return batch_from_numpy(arrays, valids=valids, capacity=cap,
                                device=dev)

    # ---- prefetch pipeline: overlap host decode + copy with compute -----
    # depth 0 (or a device-resident fact table, which decodes nothing)
    # keeps the serial loop exactly
    depth = executor.prefetch_depth
    pipeline = None
    if fact is None and depth > 0 and len(starts_list) > 1:
        pipeline = _PrefetchPipeline(executor, starts_list, _decode_chunk,
                                     depth)

    # ---- warm: a zero-row chunk through the fused program on a thread
    # while chunk 0 decodes, so the program's first call (kernel library
    # loads, allocator growth) overlaps the decode; output discarded
    if fused is not None and pipeline is not None and \
            executor.prewarm_chunks:
        def _warm_fused():
            try:
                dummy = batch_from_numpy(
                    [np.asarray(data.columns[i])[:0]
                     for i in plan.driver.column_indices],
                    capacity=cap, device=dev)
                fused[0](dummy, fused[1], fused[2], fused[5])
            except Exception:   # noqa: BLE001 — best-effort; the loop
                pass            # runs the same calls anyway

        threading.Thread(target=_warm_fused, name="chunk-warm",
                         daemon=True).start()

    chunk_stats: List[object] = []
    decode_s = 0.0
    compute_s = 0.0
    t_loop = time.monotonic()
    executor.enter_chunk_mode()
    try:
        for start in starts_list:
            # chunk-boundary cooperative cancel
            executor.check_cancel()
            if fact is not None:
                chunk = _slice_widen(
                    cap, fact_wide, fact_datas, fact_valids, start,
                    min(start + chunk_rows, plan.driver_rows),
                    plan.driver_rows)
            elif pipeline is not None:
                chunk = pipeline.next(start)
            else:
                t0 = time.monotonic()
                chunk = _decode_chunk(start)
                decode_s += time.monotonic() - t0
            t0 = time.monotonic()
            if fused is not None:
                out, stats_vec = fused[0](chunk, fused[1], fused[2],
                                          fused[5])
                chunk_stats.append(stats_vec)
                if _profile_enabled():
                    _sync(dev)
                    _prof(f"chunk@{start} done")
            else:
                executor._subst[id(plan.driver)] = chunk
                executor._subst_opaque.add(id(plan.driver))
                try:
                    out = executor.run(per_chunk_target)
                finally:
                    executor._subst.pop(id(plan.driver), None)
                    executor._subst_opaque.discard(id(plan.driver))
                    # the per-chunk path recomputes these nodes next
                    # iteration; release their reservations now so the
                    # pool reflects only pinned builds + partials
                    executor.release_path_reservations(
                        per_chunk_target, keep=executor._subst)
            executor.stats.agg_spill_chunks += 1
            if fact is not None:
                executor.stats.fact_cache_chunks += 1
            if partial_state is not None:
                partial_state.add(out)
            else:
                arrs, vals = batch_to_numpy(out)
                concat_arrays.append(arrs)
                concat_valids.append(vals)
            compute_s += time.monotonic() - t0
    except BaseException:
        if partial_state is not None:
            partial_state.close()       # drop revocable reservations
        raise
    finally:
        if pipeline is not None:
            decode_s += pipeline.decode_s
            pipeline.close()
        executor.exit_chunk_mode()
        # per-run span attribution (host clock; compute is the enqueue
        # time of the device work, not its duration)
        executor.chunk_spans = {
            "chunks": len(starts_list),
            "decode_s": decode_s,
            "compute_s": compute_s,
            "wall_s": time.monotonic() - t_loop,
            "prefetched": pipeline.served if pipeline is not None else 0,
        }

    if plan.merge_agg is None:
        ncols = len(concat_arrays[0])
        arrs = [np.concatenate([c[j] for c in concat_arrays])
                for j in range(ncols)]
        vals = [np.concatenate([c[j] for c in concat_valids])
                for j in range(ncols)]
        merged = batch_from_numpy(arrs, valids=vals, device=dev)
        # structure-faithful: the concat of all chunks IS root.child's
        # value, so decisions above it stay cacheable
        executor._subst[id(root.child)] = merged
        try:
            return executor.run(root.child)
        finally:
            executor._subst.clear()
            executor._subst_opaque.clear()

    if fused is not None and chunk_stats:
        ok = _verify_record_adaptation(executor, fused[3], fused[4],
                                       chunk_stats)
        if not ok:
            # the adaptation's window/capacity guesses were violated by
            # this run's data: rerun with the plain program (the stale
            # measurement was just dropped, so the retry does not adapt)
            executor.stats.escaped_window_reruns += 1
            partial_state.close()
            _prof("adaptation violated; plain rerun")
            return execute_chunked(executor, root)
    _prof("chunk loop dispatched; merging")
    merged = partial_state.merge(plan.merge_agg)
    # structure-faithful (see concat mode above): decisions above the
    # merge point replay from the decision cache
    executor._subst[id(plan.merge_agg)] = merged
    try:
        return executor.run(root.child)
    finally:
        executor._subst.clear()
        executor._subst_opaque.clear()


# --------------------------------------------------------------------------
# streaming-build join: build sides bigger than device memory
# --------------------------------------------------------------------------

def streaming_build_join(executor, node: L.JoinNode,
                         probe: Batch) -> Optional[Batch]:
    """Inner/semi/anti unique-build join whose BUILD side streams from host
    in chunks (PartitionedConsumption's partition-at-a-time idea, reshaped
    for the dense LUT): the LUT is domain-sized however many build rows
    exist, so the build occupies one chunk of device memory at a time —
    each chunk scatters its global row ids into a persistent LUT. Probe
    lookups yield global row ids; matched rows compact, and the build
    payload columns are gathered on the HOST (numpy fancy indexing over
    the table's columns) at the compacted size, so the full build never
    materializes on the device. Requires a single integer key with a known
    domain, a Scan or Filter(Scan) build, and a planner uniqueness proof.
    Returns None when the shape does not apply (the caller runs the
    resident build)."""
    if node.kind not in ("inner", "semi", "anti") or \
            node.build_key_domain is None or not node.build_unique or \
            len(node.right_keys) != 1 or node.residual is not None or \
            node.null_aware:
        return None
    build_root = node.right
    pred = None
    if isinstance(build_root, L.FilterNode):
        pred = executor.fold_scalars(build_root.predicate)
        scan = build_root.child
    else:
        scan = build_root
    if not isinstance(scan, L.ScanNode):
        return None

    dev = executor.device
    data = executor.catalog.get_table(scan.catalog, scan.schema_name,
                                      scan.table)
    chunk_rows = executor.spill_chunk_rows or data.num_rows
    domain = node.build_key_domain
    key_in_scan = node.right_keys[0]

    from ..ops.join import build_lut_chunk
    from ..ops.project import apply_filter
    lut = torch.full((domain + 1,), -1, dtype=torch.int32, device=dev)
    cap = bucket_capacity(min(chunk_rows, data.num_rows))
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    expected = zero          # in-domain valid build rows
    oob = zero               # valid keys outside the domain
    for start in range(0, data.num_rows, chunk_rows):
        arrays = [np.asarray(data.columns[i])[start:start + chunk_rows]
                  for i in scan.column_indices]
        valids = None
        if data.valids is not None:
            valids = [None if data.valids[i] is None else
                      np.asarray(data.valids[i])[start:start + chunk_rows]
                      for i in scan.column_indices]
        chunk = batch_from_numpy(arrays, valids=valids, capacity=cap,
                                 device=dev)
        if pred is not None:
            chunk = apply_filter(chunk, pred)
        lut, n_in, n_oob = build_lut_chunk(lut, chunk, key_in_scan, domain,
                                           start)
        expected = expected + n_in
        oob = oob + n_oob
        executor.stats.agg_spill_chunks += 1
    executor.stats.streamed_build_joins += 1

    # runtime validation of the planner's uniqueness proof: a duplicate
    # build key would keep only the max row id and an out-of-domain key
    # would be clipped into a real slot — both wrong, so fall back to the
    # resident build instead (dup rows exist iff scattered rows exceed
    # occupied slots)
    occupied = (lut[:domain] >= 0).sum(dtype=torch.int64)
    expected_h, oob_h, occupied_h = (
        int(x) for x in torch.stack((expected, oob, occupied)).tolist())
    if oob_h > 0 or occupied_h != expected_h:
        return None

    # probe: global row ids out of the LUT
    pk = probe.columns[node.left_keys[0]]
    pkd = pk.data.to(torch.int64)
    p_idx = torch.where(pk.valid, pkd.clamp(0, domain - 1), domain)
    src = lut[p_idx]
    matched = (src >= 0) & pk.valid & probe.live & \
        (pkd >= 0) & (pkd < domain)
    if node.kind == "semi":
        return probe.with_live(probe.live & matched)
    if node.kind == "anti":
        return probe.with_live(probe.live & ~matched)

    live = int(matched.sum())
    new_cap = bucket_capacity(live)
    from .executor import compact_batch
    probe_plus = Batch(probe.columns + (Column(src, matched),),
                       probe.live & matched)
    compacted = compact_batch(probe_plus, new_cap)
    src_host = compacted.columns[-1].data.cpu().numpy()
    src_ok = (compacted.columns[-1].valid & compacted.live).cpu().numpy()
    src_host = np.where(src_ok, src_host, 0)

    # host-side payload gather from the table's columns
    out_cols = list(compacted.columns[:-1])
    for ti in scan.column_indices:
        col_np = np.asarray(data.columns[ti])[src_host]
        valid_np = src_ok.copy()
        if data.valids is not None and data.valids[ti] is not None:
            valid_np &= np.asarray(data.valids[ti])[src_host]
        out_cols.append(Column(torch.from_numpy(col_np).to(dev),
                               torch.from_numpy(valid_np).to(dev)))
    return Batch(tuple(out_cols), compacted.live)


def merge_partials(executor, node: L.AggregateNode,
                   partials: List[Batch]) -> Batch:
    """FINAL step: concat partial states and re-aggregate them with the
    merge functions over the partial layout (keys at 0..n_keys-1, states
    after). Hash-strategy operators merge through the hash-partial path
    (executor.merge_group_aggregate), the rest through the sort merge."""
    from ..ops.aggregate import AggSpec, global_aggregate
    # one device concatenation per column (capacity is the sum, so no row
    # can drop)
    merged = Batch(
        tuple(Column(torch.cat([p.columns[j].data for p in partials]),
                     torch.cat([p.columns[j].valid for p in partials]))
              for j in range(len(partials[0].columns))),
        torch.cat([p.live for p in partials]))
    n_keys = len(node.group_keys)
    merge_aggs = tuple(AggSpec(MERGE_FUNC[a.func], n_keys + j)
                       for j, a in enumerate(node.aggs))
    if node.strategy == "global":
        return global_aggregate(merged, merge_aggs)
    capacity = max(node.out_capacity,
                   bucket_capacity(int(merged.live.sum())))
    return executor.merge_group_aggregate(node, merged, merge_aggs,
                                          capacity)
