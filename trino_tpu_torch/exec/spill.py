"""Host-spill execution: joins, aggregations and sorts that exceed the
pool, and the chunked driver's spillable partial-aggregate state.

Port copy of ``trino_tpu/exec/spill.py`` (with ``partition_assignment``
from ``trino_tpu/server/tasks.py``). Edits: ``partition_ids`` is the
partitioner on the device, for the hash aggregate's escape path; a
partition's or chunk's batch is built on ``executor.device``, so its
aggregate runs where the query runs (K3 for a hash aggregate, K5 where
`mxu_agg` takes it, on the card); and the reference's ``_spill_site``
wrapper is left out: it attributes XLA compiles to a compile recorder,
and the port compiles nothing per shape.

Reference: the spilling operators — HashBuilderOperator's spill-to-disk
partitions (operator/join/PartitionedConsumption.java), the spillable
aggregation builder (operator/aggregation/builder/
SpillableHashAggregationBuilder.java), and GenericPartitioningSpiller's
radix partitioning by hash (spiller/GenericPartitioningSpiller.java:66).
"Design Trade-offs for a Robust Dynamic Hybrid Hash Join"
(arXiv:2112.02480) is the blueprint: graceful partition-and-spill, not a
bigger budget, is what keeps joins correct under constrained memory.

Device memory is the scarce tier, host RAM and local disk are the spill
tiers. When an operator's reservation cannot fit the pool even after
revocation, the executor retries it here:

- both sides move to host and radix-partition by the SAME splitmix64 key
  hash the partitioned exchange uses (partition_assignment), so
  co-partitioned rows always land together;
- partitions persist through HostSpiller — host RAM for small partitions,
  disk containers with the exchange-spool framing + per-page CRC32C for
  large ones (a corrupt or failed write degrades to the RAM copy, never
  to wrong answers);
- each partition then joins/aggregates alone, bounded by partition size,
  and the outputs concatenate. Equality classes never straddle a hash
  partition, and stable partitioning preserves within-group row order,
  so results are bit-exact vs the resident kernels (modulo row order,
  which no operator here guarantees anyway).
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..batch import batch_from_numpy, batch_to_numpy, bucket_capacity
from ..planner import logical as L


class SpillReadError(RuntimeError):
    """A spilled partition could not be read back (both the disk
    container and the RAM fallback are gone) — retryable at query level."""


class HostSpiller:
    """Two-tier partition store: host RAM first, disk (exchange-spool
    framing, CRC32C-verified) for partitions past `disk_min_bytes`.

    Disk writes are verified by immediate read-back: a failed or corrupt
    write (chaos SPOOL_WRITE faults, disk full) keeps the RAM copy and
    counts trino_tpu_spill_retries_total — the spill tier can lose
    durability, never correctness."""

    def __init__(self, root: Optional[str] = None, injector=None,
                 disk_min_bytes: int = 4 << 20, force_disk: bool = False):
        from ..server.exchange_spool import ExchangeSpool
        self.root = root or os.environ.get("TRINO_TPU_SPILL_DIR") or \
            tempfile.mkdtemp(prefix="trino_tpu_spill_")
        self.spool = ExchangeSpool(root=self.root, injector=injector)
        self.disk_min_bytes = disk_min_bytes
        self.force_disk = force_disk
        self._ram: Dict[str, bytes] = {}
        self.bytes_spilled = 0
        self.disk_writes = 0
        self.write_recoveries = 0
        self._seq = 0

    @property
    def injector(self):
        return self.spool.injector

    @injector.setter
    def injector(self, inj) -> None:
        self.spool.injector = inj

    def next_key(self, hint: str) -> str:
        self._seq += 1
        return f"spill-{hint}-{self._seq}"

    def put(self, key: str, arrays: List[np.ndarray],
            valids: List[np.ndarray]) -> None:
        from ..metrics import SPILL_BYTES, SPILL_PARTITIONS, SPILL_RETRIES
        from ..server.pageserde import encode_page
        page = encode_page(arrays, valids)
        self.bytes_spilled += len(page)
        SPILL_BYTES.inc(len(page))
        SPILL_PARTITIONS.inc()
        if not self.force_disk and len(page) < self.disk_min_bytes:
            self._ram[key] = page
            return
        self.spool.put(key, [page])
        self.disk_writes += 1
        back = self.spool.get(key)        # read-back verify (CRC32C)
        if back is None or back != [page]:
            # write failed or the container came back corrupt: the RAM
            # copy stays authoritative — retryable, no wrong answer
            self.write_recoveries += 1
            SPILL_RETRIES.inc()
            self.spool.delete(key)
            self._ram[key] = page

    def get(self, key: str) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """Read one partition back, verified; the entry is consumed."""
        from ..server.pageserde import decode_page
        page = self._ram.pop(key, None)
        if page is None:
            pages = self.spool.get(key)
            self.spool.delete(key)
            if not pages:
                raise SpillReadError(f"spilled partition {key} lost")
            page = pages[0]
        return decode_page(page)

    def discard(self, keys) -> None:
        for k in keys:
            self._ram.pop(k, None)
            self.spool.delete(k)

    def clear(self) -> None:
        self._ram.clear()
        self.spool.clear()


def get_spiller(executor) -> HostSpiller:
    if executor.spiller is None:
        executor.spiller = HostSpiller(force_disk=executor.spill_force_disk)
    return executor.spiller


# --------------------------------------------------------------------------
# host-side helpers
# --------------------------------------------------------------------------

def _side_to_host(executor, child: L.PlanNode) -> tuple:
    """Run a child subtree and move its LIVE rows to host, releasing the
    device reservations. The transient device batch runs under the
    pool's grace window (its bytes are revocable in spirit: the next
    statement revokes them to host)."""
    with executor.pool.grace():
        batch = executor.run(child)
        arrs, vals = batch_to_numpy(batch)
    executor.release_path_reservations(child, keep=executor._subst)
    return arrs, vals


def _integer_keys(output, idxs) -> bool:
    for k in idxs:
        dt = np.dtype(output[k][1].np_dtype)
        if not (np.issubdtype(dt, np.integer) or dt == np.bool_):
            return False
    return True


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


def _equality_keys(probe, prow, build, brow, pkeys, bkeys):
    """(pk, pok, bk, bok): one int64 per selected row of each side whose
    equality is the key tuple's equality where both rows' keys are valid
    (`_packed_key`'s contract; no overflow case: a multi-column key is
    the dense ranks of its columns over both sides, combined pairwise)."""
    import torch

    def cols(batch, rows, idxs):
        ok = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
        cs = []
        for i in idxs:
            cs.append(batch.columns[i].data[rows].to(torch.int64))
            ok = ok & batch.columns[i].valid[rows]
        return cs, ok

    pc, pok = cols(probe, prow, pkeys)
    bc, bok = cols(build, brow, bkeys)
    if len(pc) == 1:
        return pc[0], pok, bc[0], bok
    key = None
    for p, b in zip(pc, bc):
        rank = torch.unique(torch.cat([p, b]), return_inverse=True)[1]
        key = rank if key is None else torch.unique(
            key * (1 << 32) + rank, return_inverse=True)[1]
    n = prow.shape[0]
    return key[:n], pok, key[n:], bok


# output rows a slice of the escape join's expansion writes
EXPAND_ROWS = 1 << 25


def _output_batch(columns, n: int, device):
    """A zeroed Batch with `columns`' dtypes and `n` live rows, laid out
    as ``batch_from_numpy`` lays out `n` host rows (capacity
    ``pad_capacity(n)``, zeros and invalid past `n`); the caller writes
    rows [0, n)."""
    import torch
    from ..batch import Batch, Column, pad_capacity
    cap = pad_capacity(n)
    cols = tuple(Column(torch.zeros(cap, dtype=c.data.dtype, device=device),
                        torch.zeros(cap, dtype=torch.bool, device=device))
                 for c in columns)
    return Batch(cols, torch.arange(cap, device=device) < n)


def partitioned_equi_join(probe, build, pkeys, bkeys, kind: str,
                          count: int):
    """The hybrid hash join's escape path, on the batches' device: both
    sides' live rows radix-partition by ``partition_ids`` and each
    partition joins as ``_host_equi_join`` joins it, the partitions'
    outputs concatenated in partition order. Since equal keys share a
    partition, that is one join of the probe's live rows stably sorted
    by partition against all build rows: a probe row's matches are the
    build rows with its key, in their order. The result is the batch the
    host path builds from the same rows (`_output_batch`), bit for bit.
    kind: 'inner' | 'left' | 'semi' | 'anti'."""
    import torch
    dev = probe.device
    prow = torch.nonzero(probe.live).flatten()
    part = partition_ids(probe, pkeys, count)[prow]
    prow = prow[torch.sort(part, stable=True).indices]
    brow = torch.nonzero(build.live).flatten()
    pk, pok, bk, bok = _equality_keys(probe, prow, build, brow, pkeys,
                                      bkeys)
    sorted_keys, order = torch.sort(bk[bok], stable=True)
    border = brow[bok][order]
    lo = torch.searchsorted(sorted_keys, pk)
    counts = torch.where(
        pok, torch.searchsorted(sorted_keys, pk, right=True) - lo, 0)
    if kind in ("semi", "anti"):
        keep = prow[(counts > 0) if kind == "semi" else (counts == 0)]
        out = _output_batch(probe.columns, keep.shape[0], dev)
        for c, o in zip(probe.columns, out.columns):
            o.data[:keep.shape[0]] = c.data[keep]
            o.valid[:keep.shape[0]] = c.valid[keep]
        return out
    out_counts = counts if kind == "inner" else counts.clamp(min=1)
    ends = torch.cumsum(out_counts, 0)
    total = int(ends[-1]) if ends.shape[0] else 0
    out = _output_batch(probe.columns + build.columns, total, dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    # the expansion a slice of output rows at a time: its index vectors
    # stay small however far the join fans out (all at once ran TPC-DS
    # q72 out of the card's memory)
    for s in range(0, total, EXPAND_ROWS):
        pos = torch.arange(s, min(total, s + EXPAND_ROWS), device=dev)
        at = torch.searchsorted(ends, pos, right=True)
        has_match = counts[at] > 0
        bpos = lo[at] + pos - (ends[at] - out_counts[at])
        bsrc = border[bpos.clamp(0, border.shape[0] - 1)] \
            if border.shape[0] else zero.expand(pos.shape[0])
        psrc = prow[at]
        rows = slice(s, s + pos.shape[0])
        for c, o in zip(probe.columns, out.columns):
            o.data[rows] = c.data[psrc]
            o.valid[rows] = c.valid[psrc]
        for c, o in zip(build.columns, out.columns[len(probe.columns):]):
            o.data[rows] = torch.where(has_match, c.data[bsrc],
                                       torch.zeros((), dtype=c.data.dtype,
                                                   device=dev))
            o.valid[rows] = c.valid[bsrc] & has_match
    return out


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


def _spill_partitions(executor, hint: str, arrays, valids, key_idxs,
                      count: int) -> List[str]:
    """Radix-partition a host column set and spill each partition; the
    source arrays can be dropped by the caller afterwards. np boolean
    take keeps within-partition row order (stable), which is what makes
    per-group float sums bit-exact on read-back."""
    spiller = get_spiller(executor)
    part = _partition_ids(arrays, valids, key_idxs, count)
    keys = []
    for p in range(count):
        m = part == p
        keys.append(spiller.next_key(f"{hint}-p{p}"))
        spiller.put(keys[-1], [a[m] for a in arrays],
                    [v[m] for v in valids])
    return keys


def _concat_pages(outs, outs_v, device):
    ncols = len(outs[0])
    return batch_from_numpy(
        [np.concatenate([p[j] for p in outs]) for j in range(ncols)],
        valids=[np.concatenate([p[j] for p in outs_v])
                for j in range(ncols)], device=device)


# --------------------------------------------------------------------------
# operator-level spill entry points (called from Executor.run's
# ExceededMemoryLimitError fallback)
# --------------------------------------------------------------------------

def spill_join(executor, node: L.JoinNode):
    """Radix-partitioned host join for a JoinNode whose working set blew
    the pool. None = shape unsupported (caller re-raises the original
    memory error — a clean QUERY_EXCEEDED_MEMORY, never a crash)."""
    if node.kind not in ("inner", "left", "semi", "anti", "mark") or \
            node.null_aware or node.residual is not None:
        return None
    if not _integer_keys(node.left.output, node.left_keys) or \
            not _integer_keys(node.right.output, node.right_keys):
        return None
    parrs, pvalids = _side_to_host(executor, node.left)
    barrs, bvalids = _side_to_host(executor, node.right)
    total = _host_bytes(parrs, pvalids) + _host_bytes(barrs, bvalids)
    count = _pick_partitions(executor, total)
    pkeys_files = _spill_partitions(executor, "join-probe", parrs,
                                    pvalids, node.left_keys, count)
    bkeys_files = _spill_partitions(executor, "join-build", barrs,
                                    bvalids, node.right_keys, count)
    del parrs, pvalids, barrs, bvalids
    spiller = get_spiller(executor)
    out_arrays: List[list] = []
    out_valids: List[list] = []
    for pf, bf in zip(pkeys_files, bkeys_files):
        # partition-boundary cooperative cancel (terminate()/deadline)
        executor.check_cancel()
        pa, pv = spiller.get(pf)
        ba, bv = spiller.get(bf)
        arrs, vals = _host_equi_join(pa, pv, ba, bv, node.left_keys,
                                     node.right_keys, node.kind)
        if arrs and len(arrs[0]):
            out_arrays.append(arrs)
            out_valids.append(vals)
    executor.stats.spilled_joins += 1
    if not out_arrays:
        return _empty_output(executor, node)
    return _concat_pages(out_arrays, out_valids, executor.device)


def _empty_output(executor, node: L.PlanNode):
    arrs = [np.zeros(0, dtype=np.dtype(dt.np_dtype))
            for _, dt in node.output]
    return batch_from_numpy(arrs,
                            valids=[np.zeros(0, np.bool_) for _ in arrs],
                            device=executor.device)


def spill_aggregate(executor, node: L.AggregateNode):
    """Spillable aggregation, two strategies (the hash-vs-sort group-by
    study's trade-off, arXiv:2411.13245):

    - radix partitioning by group-key hash when the largest partition
      fits the pool: every group is wholly inside one partition and
      stable partitioning preserves row order within a group, so the
      result matches the resident kernel bit for bit;
    - chunk-and-merge partial states when the keys are too low-
      cardinality to partition (a 4-group GROUP BY hashes everything
      into 4 partitions): fixed-size row chunks aggregate to partial
      states that merge with sum/min/max — exact for integer/decimal
      accumulators, same ULP caveat as the chunked driver for floats.

    Each partition's and chunk's batch is built on the executor's device,
    so its aggregate runs there (K3, K5 on the card). None = shape
    unsupported (caller fails cleanly)."""
    if not node.group_keys or \
            not _integer_keys(node.child.output, node.group_keys):
        return None
    from ..ops.aggregate import AggSpec
    from .chunked import MERGE_FUNC
    from .memory import batch_bytes
    aggs = tuple(AggSpec(a.func,
                         a.arg.index if a.arg is not None else None,
                         a.distinct)
                 for a in node.aggs)
    mergeable = not any(a.distinct for a in node.aggs) and \
        all(a.func in MERGE_FUNC for a in node.aggs)
    arrs, vals = _side_to_host(executor, node.child)
    total = _host_bytes(arrs, vals)
    count = _pick_partitions(executor, total)
    n = len(arrs[0]) if arrs else 0
    row_bytes = max(1, total // max(1, n))
    part = _partition_ids(arrs, vals, node.group_keys, count)
    biggest = int(np.bincount(part, minlength=count).max()) if n else 0
    if biggest * row_bytes * 2 > executor.pool.limit:
        # skewed/low-cardinality keys: partitioning cannot shrink the
        # working set — chunk-and-merge instead (or give up cleanly)
        if not mergeable:
            return None
        return _chunked_partial_aggregate(executor, node, arrs, vals)
    files = _spill_partitions(executor, "agg", arrs, vals,
                              node.group_keys, count)
    del arrs, vals
    spiller = get_spiller(executor)
    outs: List[list] = []
    outs_v: List[list] = []
    with executor.no_decisions():
        for f in files:
            # partition-boundary cooperative cancel
            executor.check_cancel()
            pa, pv = spiller.get(f)
            pb = batch_from_numpy(pa, valids=pv, device=executor.device)
            executor.pool.reserve(batch_bytes(pb))
            try:
                out = executor.aggregate_batch(node, pb, aggs)
                oa, ov = batch_to_numpy(out)
            finally:
                executor.pool.free(batch_bytes(pb))
            if oa and len(oa[0]):
                outs.append(oa)
                outs_v.append(ov)
    executor.stats.spilled_aggregations += 1
    if not outs:
        return _empty_output(executor, node)
    return _concat_pages(outs, outs_v, executor.device)


def spill_sort(executor, node: L.SortNode):
    """Host-side ORDER BY fallback: when the device sort's batch cannot
    fit the pool, sort the live rows on host with the same key
    semantics as the scheduler's n-way run merge (rank codes below a
    null-rank level, np.lexsort's stability preserving input order on
    ties) and apply the TopN limit before anything rematerializes."""
    arrs, vals = _side_to_host(executor, node.child)
    n = len(arrs[0]) if arrs else 0
    levels = []
    for k in reversed(node.keys):
        ok = np.asarray(vals[k.index], np.bool_)
        codes = np.unique(arrs[k.index],
                          return_inverse=True)[1].astype(np.int64)
        if not k.ascending:
            codes = -codes
        codes = np.where(ok, codes, 0)
        nr = np.where(ok, 1 if k.nulls_first else 0,
                      0 if k.nulls_first else 1).astype(np.int8)
        levels.append(codes)
        levels.append(nr)
    order = np.lexsort(levels) if levels else np.arange(n)
    if node.limit is not None:
        order = order[:node.limit]
    executor.stats.spilled_sorts += 1
    return batch_from_numpy([a[order] for a in arrs],
                            valids=[v[order] for v in vals],
                            device=executor.device)


def _chunked_partial_aggregate(executor, node: L.AggregateNode,
                               arrs, vals):
    """Bounded aggregation over host rows in fixed chunks: each chunk
    runs the node's own aggregation on the executor's device (its output
    IS the partial-state layout: keys, then mergeable states), chunk
    outputs spill through the host spiller, and merge_partial_pages
    re-aggregates them."""
    from ..ops.aggregate import AggSpec
    from .memory import batch_bytes
    aggs = tuple(AggSpec(a.func,
                         a.arg.index if a.arg is not None else None)
                 for a in node.aggs)
    n = len(arrs[0]) if arrs else 0
    total = _host_bytes(arrs, vals)
    row_bytes = max(1, total // max(1, n))
    # a third of the pool per chunk (input + kernel scratch + partial
    # output share it); the floor only guards against degenerate limits
    budget = max(64 << 10, executor.pool.limit // 3)
    chunk_rows = max(1024, budget // row_bytes)
    spiller = get_spiller(executor)
    keys = []
    with executor.no_decisions():
        for start in range(0, max(n, 1), chunk_rows):
            chunk = batch_from_numpy(
                [a[start:start + chunk_rows] for a in arrs],
                valids=[v[start:start + chunk_rows] for v in vals],
                device=executor.device)
            executor.pool.reserve(batch_bytes(chunk))
            try:
                out = executor.aggregate_batch(node, chunk, aggs)
                oa, ov = batch_to_numpy(out)
            finally:
                executor.pool.free(batch_bytes(chunk))
            key = spiller.next_key("aggchunk")
            spiller.put(key, oa, ov)
            keys.append(key)
    pages = [spiller.get(k) for k in keys]
    executor.stats.spilled_aggregations += 1
    return merge_partial_pages(executor, node, pages)


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
        self.spilled_rounds = 0
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
            self.spilled_rounds += 1
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
