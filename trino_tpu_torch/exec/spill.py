"""Host-side radix partitioning, partition-local equi-join, and the
chunked driver's spillable partial-aggregate state.

Port copy of what the port needs from ``trino_tpu/exec/spill.py``:
the numpy helpers of the hash paths (``_partition_ids``,
``_host_equi_join`` and what they call, with ``partition_assignment`` from
``trino_tpu/server/tasks.py``), unchanged, and ``PartialState`` with
``merge_partial_pages`` (device partials held as revocable reservations,
moved to host pages when the pool asks, merged partition-wise when the
concatenation would not fit). The rest of the spill tier (host/disk
spilling of joins, aggregations and sorts under memory pressure) is not
ported (ROADMAP).
"""

from __future__ import annotations

import threading
from typing import List

import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """uint64 -> uint64 mix (same finalizer family as the reference's
    XxHash64-based partitioning — any good avalanche works, it only has
    to be consistent across workers)."""
    z = x + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def partition_assignment(arrays, valids, key_idxs, count: int):
    """Per-row partition ids from the key columns. Integer-typed keys
    only (dictionary varchar codes are per-table and would partition
    inconsistently across tables); NULLs hash to a fixed marker so every
    worker routes them identically."""
    n = len(arrays[0]) if arrays else 0
    h = np.zeros(n, np.uint64)
    with np.errstate(over="ignore"):
        for j, i in enumerate(key_idxs):
            a = arrays[i]
            if not np.issubdtype(a.dtype, np.integer) and \
                    a.dtype != np.bool_:
                raise ValueError(
                    f"partitioned exchange requires integer keys, "
                    f"got {a.dtype}")
            k = a.astype(np.int64).view(np.uint64)
            k = np.where(valids[i], k, np.uint64(0xA5A5A5A5A5A5A5A5))
            h ^= _splitmix64(k + np.uint64(j))
    return (h % np.uint64(count)).astype(np.int64)


_NULL_MARK = 0xA5A5A5A5A5A5A5A5 - (1 << 64)      # as a signed int64


def partition_ids(batch, key_idxs, count: int):
    """``partition_assignment`` on the device, bit for bit: per-row
    partition ids [capacity] int64 of `batch` from its key columns (dead
    rows get ids too; callers mask them). Integer and bool keys only."""
    import torch
    from ..ops.hashtable import _splitmix64
    h = None
    for j, i in enumerate(key_idxs):
        col = batch.columns[i]
        if col.data.dtype.is_floating_point or col.data.dtype.is_complex:
            raise ValueError(
                f"partitioned exchange requires integer keys, got "
                f"{col.data.dtype}")
        k = torch.where(col.valid, col.data.to(torch.int64), _NULL_MARK)
        m = _splitmix64(k + j)
        h = m if h is None else h ^ m
    if h is None:
        return torch.zeros(batch.capacity, dtype=torch.int64,
                           device=batch.device)
    if count & (count - 1) == 0:
        return h & (count - 1)
    # unsigned 64-bit remainder of the int64 bit pattern
    r = torch.remainder(h, count)
    return torch.where(h < 0, (r + (1 << 64) % count) % count, r)


def _partition_ids(arrays, valids, key_idxs, count: int) -> np.ndarray:
    return partition_assignment(arrays, valids, key_idxs, count)


def _packed_key(parrs, pvalids, barrs, bvalids, pkeys, bkeys):
    """One int64 key per row for each side (range-compressed multi-key
    packing, shared mins so equality is preserved), plus validity masks.
    Returns (pk, pok, bk, bok) or None when the packed key would overflow
    62 bits (caller takes the dict fallback)."""
    def cols(arrs, vals, idxs):
        n = len(arrs[0]) if arrs else 0
        ok = np.ones(n, np.bool_)
        cs = []
        for i in idxs:
            cs.append(np.asarray(arrs[i]).astype(np.int64))
            ok &= np.asarray(vals[i], np.bool_)
        return cs, ok

    pc, pok = cols(parrs, pvalids, pkeys)
    bc, bok = cols(barrs, bvalids, bkeys)
    if len(pc) == 1:
        return pc[0], pok, bc[0], bok
    lims = []
    for j in range(len(pc)):
        vals = []
        for c, ok in ((pc[j], pok), (bc[j], bok)):
            if ok.any():
                vals.append((int(c[ok].min()), int(c[ok].max())))
        lo = min((v[0] for v in vals), default=0)
        hi = max((v[1] for v in vals), default=0)
        lims.append((lo, max(1, int(hi - lo + 1).bit_length())))
    if sum(b for _, b in lims) > 62:
        return None
    def pack(cs):
        out = np.zeros(len(cs[0]) if cs else 0, np.int64)
        for c, (lo, bits) in zip(cs, lims):
            out = (out << bits) | (c - lo)
        return out
    return pack(pc), pok, pack(bc), bok


def _dict_join_counts(pk_rows, bk_rows):
    """Python-dict fallback for unpackable multi-column keys: returns
    (counts, lo, bidx_sorted-equivalent) compatible with the vectorized
    expansion below by synthesizing a sorted build order."""
    order = sorted(range(len(bk_rows)), key=lambda i: bk_rows[i])
    bsorted = [bk_rows[i] for i in order]
    import bisect
    lo = np.fromiter((bisect.bisect_left(bsorted, k) for k in pk_rows),
                     np.int64, len(pk_rows))
    hi = np.fromiter((bisect.bisect_right(bsorted, k) for k in pk_rows),
                     np.int64, len(pk_rows))
    return lo, hi, np.asarray(order, np.int64)


def _host_equi_join(parrs, pvalids, barrs, bvalids, pkeys, bkeys,
                    kind: str):
    """Partition-local join: sort the build keys once, range-probe with
    searchsorted, expand with repeats (the numpy rendition of the sorted
    probe the device kernels run). Handles duplicate build keys; NULL
    keys never match. Returns (arrays, valids) in probe+build column
    order (inner/left), probe order (semi/anti), or probe+mark (mark)."""
    n = len(parrs[0]) if parrs else 0
    packed = _packed_key(parrs, pvalids, barrs, bvalids, pkeys, bkeys)
    if packed is not None:
        pk, pok, bk, bok = packed
        bidx = np.nonzero(bok)[0]
        order = np.argsort(bk[bidx], kind="stable")
        bidx = bidx[order]
        bsorted = bk[bidx]
        lo = np.searchsorted(bsorted, pk, side="left")
        hi = np.searchsorted(bsorted, pk, side="right")
    else:
        pok = np.ones(n, np.bool_)
        bokn = len(barrs[0]) if barrs else 0
        bok = np.ones(bokn, np.bool_)
        for i in pkeys:
            pok &= np.asarray(pvalids[i], np.bool_)
        for i in bkeys:
            bok &= np.asarray(bvalids[i], np.bool_)
        pk_rows = [tuple(int(parrs[i][r]) for i in pkeys) if pok[r]
                   else None for r in range(n)]
        valid_b = np.nonzero(bok)[0]
        bk_rows = [tuple(int(barrs[i][r]) for i in bkeys)
                   for r in valid_b]
        pk_safe = [k if k is not None else ((1 << 62),) for k in pk_rows]
        lo, hi, order = _dict_join_counts(pk_safe, bk_rows)
        bidx = valid_b[order]
    counts = np.where(pok, hi - lo, 0)

    if kind in ("semi", "anti", "mark"):
        matched = counts > 0
        if kind == "mark":
            return (list(parrs) + [matched],
                    list(pvalids) + [np.ones(n, np.bool_)])
        keep = matched if kind == "semi" else ~matched
        return ([a[keep] for a in parrs], [v[keep] for v in pvalids])

    out_counts = counts if kind == "inner" else np.maximum(counts, 1)
    prow = np.repeat(np.arange(n), out_counts)
    within = np.arange(len(prow)) - np.repeat(
        np.cumsum(out_counts) - out_counts, out_counts)
    has_match = counts[prow] > 0
    bpos = lo[prow] + within
    if len(bidx):
        brow = bidx[np.clip(bpos, 0, len(bidx) - 1)]
    else:
        brow = np.zeros(len(prow), np.int64)
    arrays = [a[prow] for a in parrs]
    valids = [v[prow] for v in pvalids]
    for a, v in zip(barrs, bvalids):
        data = a[brow] if len(a) else np.zeros(len(prow), a.dtype)
        arrays.append(np.where(has_match, data,
                               np.zeros(1, a.dtype)[0]))
        vv = v[brow] if len(v) else np.zeros(len(prow), np.bool_)
        valids.append(np.asarray(vv & has_match, np.bool_))
    return arrays, valids


def _host_bytes(arrays, valids) -> int:
    return int(sum(a.nbytes for a in arrays) +
               sum(v.nbytes for v in valids))


def _pick_partitions(executor, total_bytes: int) -> int:
    """Enough partitions that one partition's working set fits a third of
    the pool's headroom, clamped to [2, 64] with the configured default as
    the floor."""
    base = max(2, executor.spill_partitions)
    avail = max(1 << 20, executor.pool.available())
    need = -(-total_bytes // max(1, avail // 3))      # ceil div
    p = base
    while p < need and p < 64:
        p *= 2
    return p


# --------------------------------------------------------------------------
# spillable partial-aggregation state (exec/chunked.py's accumulator)
# --------------------------------------------------------------------------

class PartialState:
    """The chunked driver's partial-aggregate accumulator, made spillable
    (SpillableHashAggregationBuilder's role): device partials are
    revocable reservations; when the pool asks they move to host pages,
    and the merge re-aggregates either resident or partition-wise."""

    def __init__(self, executor, tag: str = "agg-partials"):
        self.executor = executor
        self.tag = tag
        self.device: List[object] = []
        self._device_bytes: List[int] = []
        self.host: List[tuple] = []          # (arrays, valids)
        # revocation may fire from another thread while the chunk loop
        # appends — the lists move together
        self._lock = threading.Lock()
        self._handle = executor.pool.register_revocation(
            self._revoke, tag=tag)

    def add(self, batch) -> None:
        from .memory import batch_bytes
        b = batch_bytes(batch)
        self.executor.pool.reserve_revocable(b, tag=self.tag)
        with self._lock:
            self.device.append(batch)
            self._device_bytes.append(b)

    def _revoke(self, target_bytes: int) -> int:
        """Revocation callback: move device partials to host until the
        target is met (oldest first — they are coldest)."""
        from ..batch import batch_to_numpy
        freed = 0
        while freed < target_bytes:
            with self._lock:
                if not self.device:
                    break
                batch = self.device.pop(0)
                b = self._device_bytes.pop(0)
            self.host.append(batch_to_numpy(batch))
            self.executor.pool.free_revocable(b, tag=self.tag)
            freed += b
        if freed:
            self.executor.stats.spilled_aggregations += 1
        return freed

    def spill_all(self) -> int:
        return self._revoke(1 << 62)

    def close(self) -> None:
        # free whatever is still resident; drop the callback
        while True:
            with self._lock:
                if not self.device:
                    break
                self.device.pop()
                b = self._device_bytes.pop()
            self.executor.pool.free_revocable(b, tag=self.tag)
        self.executor.pool.unregister_revocation(self._handle)

    def merge(self, node):
        """FINAL step over mixed device/host partials: all-resident
        partials merge on the device in one concat; once anything
        spilled, everything merges through host pages."""
        from ..batch import batch_to_numpy
        from .chunked import merge_partials
        # drop the callback first so revocation cannot race the merge
        self.executor.pool.unregister_revocation(self._handle)
        with self._lock:
            device = list(self.device)
            host = list(self.host)
        try:
            if not host:
                return merge_partials(self.executor, node, device)
            pages = host + [batch_to_numpy(b) for b in device]
            return merge_partial_pages(self.executor, node, pages)
        finally:
            self.close()


def merge_partial_pages(executor, node, pages: List[tuple]):
    """Merge host partial-state pages. Fits the pool: one device merge.
    Otherwise radix-partition the concatenated states by group key and
    merge each partition alone (a group's states share a partition, so
    the merge is exact)."""
    from ..batch import batch_from_numpy, batch_to_numpy, bucket_capacity
    from ..ops.aggregate import AggSpec, global_aggregate
    from .chunked import MERGE_FUNC
    from .memory import batch_bytes
    dev = executor.device
    nonempty = [p for p in pages if p[0] and len(p[0][0])]
    if not pages:
        from .chunked import merge_partials
        return merge_partials(executor, node, [])   # raises like before
    # all-empty partials still carry dtypes: merge one zero-row page so a
    # global aggregate emits its identity row as the resident merge does
    pages = nonempty if nonempty else pages[:1]
    ncols = len(pages[0][0])
    arrs = [np.concatenate([p[0][j] for p in pages]) for j in range(ncols)]
    vals = [np.concatenate([p[1][j] for p in pages]) for j in range(ncols)]
    n_keys = len(node.group_keys)
    merge_aggs = tuple(AggSpec(MERGE_FUNC[a.func], n_keys + j)
                       for j, a in enumerate(node.aggs))
    if node.strategy == "global" or not n_keys:
        merged = batch_from_numpy(arrs, valids=vals, device=dev)
        return global_aggregate(merged, merge_aggs)
    total = _host_bytes(arrs, vals)
    # 3x: input + sort scratch + output headroom for the device merge
    if executor.pool.available() >= 3 * total:
        merged = batch_from_numpy(arrs, valids=vals, device=dev)
        capacity = max(node.out_capacity, bucket_capacity(len(arrs[0])))
        return executor.merge_group_aggregate(node, merged, merge_aggs,
                                              capacity)
    count = _pick_partitions(executor, total)
    part = _partition_ids(arrs, vals, tuple(range(n_keys)), count)
    outs, outs_v = [], []
    for p in range(count):
        m = part == p
        if not m.any():
            continue
        pb = batch_from_numpy([a[m] for a in arrs],
                              valids=[v[m] for v in vals], device=dev)
        executor.pool.reserve(batch_bytes(pb))
        try:
            out = executor.merge_group_aggregate(
                node, pb, merge_aggs, bucket_capacity(int(m.sum())))
            oa, ov = batch_to_numpy(out)
        finally:
            executor.pool.free(batch_bytes(pb))
        if oa and len(oa[0]):
            outs.append(oa)
            outs_v.append(ov)
    executor.stats.spilled_aggregations += 1
    ncols2 = len(outs[0])
    return batch_from_numpy(
        [np.concatenate([p[j] for p in outs]) for j in range(ncols2)],
        valids=[np.concatenate([p[j] for p in outs_v])
                for j in range(ncols2)], device=dev)
