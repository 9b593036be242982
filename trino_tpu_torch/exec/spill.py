"""Host-side radix partitioning and partition-local equi-join.

Port copy of the numpy helpers the hash paths need from
``trino_tpu/exec/spill.py`` (``_partition_ids``, ``_host_equi_join`` and
what they call) and ``trino_tpu/server/tasks.py``
(``partition_assignment``), unchanged. The spill tier itself (host/disk
spilling under memory pressure) is not ported (ROADMAP).
"""

from __future__ import annotations

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
