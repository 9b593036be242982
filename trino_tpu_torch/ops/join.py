"""Join kernels on torch tensors.

Counterpart of ``trino_tpu/ops/join.py`` (Trino's lookup join:
HashBuilderOperator + LookupJoinOperator, PageJoiner.java:138). The same
build structures, chosen by the same executor rules:

- **dense-domain LUT** (single integer key, bounded domain from connector
  stats): build rows scatter into a ``domain``-sized row table and each
  probe is one gather. The LUT probe and every payload gather go through
  K1 (``ops/gather.py``) when the gather mode is on.
- **sort-merge** and **sorted-array + binary search** (general unique-build
  fallbacks).
- **hybrid hash** (sparse domains): ``ops/hashtable.py``.
- **expansion** for duplicate build keys (two-pass, grow-and-retry).

Multi-key sorts (``lax.sort`` over several operands in the reference) are
stable ``torch.sort`` passes from the least significant key.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..batch import Batch, Column
from . import gather as k1

_SENTINEL = (1 << 63) - 1


def _lut_probe(lut: torch.Tensor, p_idx: torch.Tensor,
               gather_mode: str) -> torch.Tensor:
    """One LUT word per probe index — K1 when the mode is on (bit-exact
    either way)."""
    if gather_mode != "off" and k1.supports_tables([lut]):
        return k1.gather_columns([lut], p_idx)[0]
    return lut[p_idx]


def _combined_key(batch: Batch, key_indices: tuple) -> Tuple[torch.Tensor,
                                                             torch.Tensor]:
    """(key, key_valid) as int64. Multi-column keys pack 32 bits per
    trailing column (the executor validates ranges before this path)."""
    col = batch.columns[key_indices[0]]
    key = col.data.to(torch.int64)
    valid = col.valid
    for ki in key_indices[1:]:
        c = batch.columns[ki]
        key = key * (1 << 32) + c.data.to(torch.int64)
        valid = valid & c.valid
    return key, valid


def lex_sort_perm(keys) -> torch.Tensor:
    """Stable lexicographic sort permutation over key tensors (most
    significant first): stable sorts from the least significant key.
    bool keys sort as uint8 (CUDA cannot sort bool)."""
    n = keys[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=keys[0].device)
    for k in reversed(keys):
        if k.dtype == torch.bool:
            k = k.to(torch.uint8)
        order = torch.sort(k[perm], stable=True).indices
        perm = perm[order]
    return perm


def _flood_first(vals: torch.Tensor, boundary: torch.Tensor) -> torch.Tensor:
    """Each position takes its segment's FIRST value (boundary[0] must
    hold, as at every call site)."""
    pos = torch.arange(vals.shape[0], device=vals.device)
    first = torch.cummax(torch.where(boundary, pos, 0), 0).values
    return vals[first]


def _roll1(x: torch.Tensor) -> torch.Tensor:
    return torch.roll(x, 1, 0)


def _dense_row_lut(key: torch.Tensor, ok: torch.Tensor, domain: int):
    """Scatter build-row indices into a dense key->row table.

    Returns (lut[domain+1] int32, dup_count). Slot `domain` is the
    dead/invalid sink; -1 = no build row. Duplicates read back a different
    row index (the largest row wins, as with the reference's .max)."""
    n = key.shape[0]
    rows = torch.arange(n, dtype=torch.int32, device=key.device)
    idx = torch.where(ok, key.clamp(0, domain - 1), domain)
    lut = torch.full((domain + 1,), -1, dtype=torch.int32,
                     device=key.device)
    lut.scatter_reduce_(0, idx, rows, "amax")
    readback = lut[idx]
    dup = (ok & (readback != rows)).sum(dtype=torch.int64)
    return lut, dup


def join_unique_build_dense(probe: Batch, build: Batch, probe_keys: tuple,
                            build_keys: tuple, kind: str, domain: int,
                            gather_mode: str = "off"):
    """Unique-build equi-join via dense LUT: one scatter to build, one
    gather per probe. Returns (out_batch, dup_count, oob_count); oob > 0
    means a build key fell outside [0, domain) (stale stats)."""
    pk, pk_valid = _combined_key(probe, probe_keys)
    bk, bk_valid = _combined_key(build, build_keys)
    b_ok = build.live & bk_valid
    oob = (b_ok & ((bk < 0) | (bk >= domain))).sum(dtype=torch.int64)
    lut, dup = _dense_row_lut(bk, b_ok, domain)

    p_idx = torch.where(pk_valid, pk.clamp(0, domain - 1), domain)
    src = _lut_probe(lut, p_idx, gather_mode)
    matched = (src >= 0) & pk_valid & probe.live & \
        (pk >= 0) & (pk < domain)
    src_c = src.clamp(0, build.capacity - 1)

    if kind == "semi":
        return probe.with_live(probe.live & matched), dup, oob
    if kind == "anti":
        return probe.with_live(probe.live & ~matched), dup, oob
    return (_gather_build_payload(probe, build, src_c, matched, pk,
                                  build_keys, kind, gather_mode),
            dup, oob)


def _validity_word(build: Batch, bkey) -> torch.Tensor:
    """bit i = build column i valid (the key column's validity IS
    `matched`, so it is skipped)."""
    vword = torch.zeros(build.capacity, dtype=torch.int64,
                        device=build.device)
    for i, col in enumerate(build.columns):
        if i == bkey:
            continue
        vword = vword | (col.valid.to(torch.int64) << i)
    return vword


def _gather_build_payload(probe: Batch, build: Batch, src_c, matched, pk,
                          build_keys: tuple, kind: str,
                          gather_mode: str = "off") -> Batch:
    """Per-column build gathers of a probe result; `src_c` is already
    clamped to [0, build.capacity). With the gather mode on, the validity
    word and every payload column ride ONE K1 launch."""
    bkey = build_keys[0] if len(build_keys) == 1 else None
    pack_valids = len(build.columns) <= 63
    payload = [i for i in range(len(build.columns)) if i != bkey]
    vbits = None
    vword = _validity_word(build, bkey) if pack_valids else None

    gathered = None
    tables = ([vword] if pack_valids else []) + \
        [build.columns[i].data for i in payload]
    if gather_mode != "off" and pack_valids and k1.supports_tables(tables):
        outs = k1.gather_columns(tables, src_c)
        vbits = outs[0]
        gathered = dict(zip(payload, outs[1:]))
    elif pack_valids:
        vbits = vword[src_c]

    build_cols = []
    for i, col in enumerate(build.columns):
        if i == bkey:
            # matched rows' build key == probe key; no gather needed
            build_cols.append(Column(
                data=torch.where(matched, pk, 0).to(col.data.dtype),
                valid=matched))
            continue
        valid = ((vbits >> i) & 1).to(torch.bool) if pack_valids \
            else col.valid[src_c]
        data = gathered[i] if gathered is not None else col.data[src_c]
        build_cols.append(Column(data=data, valid=valid & matched))
    live = probe.live & matched if kind == "inner" else probe.live
    return Batch(columns=probe.columns + tuple(build_cols), live=live)


def dense_probe(probe: Batch, build: Batch, probe_keys: tuple,
                build_keys: tuple, domain: int, gather_mode: str = "off"):
    """Phase 1 of the two-phase dense join: LUT build + probe lookup
    only. Returns (src row indices, matched mask, dup, oob, match count).
    The LUT lookup rides K1 when the gather mode is on (the reference
    used a plain gather here: its kernel's scan gate refused tables this
    large)."""
    pk, pk_valid = _combined_key(probe, probe_keys)
    bk, bk_valid = _combined_key(build, build_keys)
    b_ok = build.live & bk_valid
    oob = (b_ok & ((bk < 0) | (bk >= domain))).sum(dtype=torch.int64)
    lut, dup = _dense_row_lut(bk, b_ok, domain)
    p_idx = torch.where(pk_valid, pk.clamp(0, domain - 1), domain)
    src = _lut_probe(lut, p_idx, gather_mode)
    matched = (src >= 0) & pk_valid & probe.live & \
        (pk >= 0) & (pk < domain)
    return src, matched, dup, oob, matched.sum(dtype=torch.int64)


def dense_join_compacted(probe: Batch, src: torch.Tensor,
                         matched: torch.Tensor, build: Batch,
                         probe_keys: tuple, build_keys: tuple,
                         new_capacity: int,
                         gather_mode: str = "off") -> Batch:
    """Phase 2 (selective inner join): compact matched probe rows first,
    then gather probe and build payload columns at the compacted capacity
    only. `matched` MUST be phase 1's mask."""
    order = torch.sort((~matched).to(torch.uint8),
                       stable=True).indices[:new_capacity]
    live = matched[order]
    src_c = src[order].clamp(0, build.capacity - 1)

    cols = []
    for c in probe.columns:
        cols.append(Column(data=c.data[order], valid=c.valid[order]))
    bkey = build_keys[0] if len(build_keys) == 1 else None
    pack_valids = len(build.columns) <= 63
    payload = [i for i in range(len(build.columns)) if i != bkey]
    vbits = None
    gathered = None
    if pack_valids:
        vword = _validity_word(build, bkey)
        tables = [vword] + [build.columns[i].data for i in payload]
        if gather_mode != "off" and k1.supports_tables(tables):
            outs = k1.gather_columns(tables, src_c)
            vbits = outs[0]
            gathered = dict(zip(payload, outs[1:]))
        else:
            vbits = vword[src_c]
    for i, col in enumerate(build.columns):
        if i == bkey:
            # matched rows' build key == probe key (single-key joins)
            pk = probe.columns[probe_keys[0]]
            cols.append(Column(
                data=torch.where(live, pk.data[order], 0).to(
                    col.data.dtype),
                valid=live))
            continue
        valid = ((vbits >> i) & 1).to(torch.bool) if pack_valids \
            else col.valid[src_c]
        data = gathered[i] if gathered is not None else col.data[src_c]
        cols.append(Column(data=data, valid=valid & live))
    return Batch(columns=tuple(cols), live=live)


def join_unique_build_merge(probe: Batch, build: Batch,
                            probe_keys: tuple, build_keys: tuple,
                            kind: str):
    """Unique-build equi-join as a sort-merge: concat both sides, sort by
    (key, side), then flood each run's build row across the run.
    kind: 'inner' | 'left'. Returns (out_batch, dup_count)."""
    dev = probe.device
    pk, pk_valid = _combined_key(probe, probe_keys)
    bk, bk_valid = _combined_key(build, build_keys)
    m, n = build.capacity, probe.capacity
    b_ok = build.live & bk_valid
    p_ok = probe.live & pk_valid
    key = torch.cat([torch.where(b_ok, bk, _SENTINEL),
                     torch.where(p_ok, pk, _SENTINEL)])
    side = torch.cat([torch.zeros(m, dtype=torch.int8, device=dev),
                      torch.ones(n, dtype=torch.int8, device=dev)])
    perm = lex_sort_perm([key, side])

    bkey = build_keys[0] if len(build_keys) == 1 else None
    skey, sside = key[perm], side[perm]
    plive = torch.cat([torch.zeros(m, dtype=torch.bool, device=dev),
                       probe.live])[perm]
    N = m + n
    pos = torch.arange(N, device=dev)
    boundary = (pos == 0) | (skey != _roll1(skey))
    is_build = (sside == 0) & (skey != _SENTINEL)
    dup = (is_build & ~boundary).sum(dtype=torch.int64)
    has_build = _flood_first(is_build & boundary, boundary)
    is_probe = sside == 1
    matched = is_probe & has_build & (skey != _SENTINEL)

    pvw = torch.zeros(n, dtype=torch.int64, device=dev)
    for i, col in enumerate(probe.columns):
        pvw = pvw | (col.valid.to(torch.int64) << i)
    spvw = torch.cat([torch.zeros(m, dtype=torch.int64, device=dev),
                      pvw])[perm]
    bvw = torch.zeros(m, dtype=torch.int64, device=dev)
    for i, col in enumerate(build.columns):
        bvw = bvw | (col.valid.to(torch.int64) << i)
    sbvw = _flood_first(torch.cat(
        [bvw, torch.zeros(n, dtype=torch.int64, device=dev)])[perm],
        boundary)
    cols = []
    for i, col in enumerate(probe.columns):
        data = torch.cat([torch.zeros(m, dtype=col.data.dtype, device=dev),
                          col.data])[perm]
        cols.append(Column(
            data=data,
            valid=((spvw >> i) & 1).to(torch.bool) & is_probe))
    for i, col in enumerate(build.columns):
        if i == bkey:
            cols.append(Column(
                data=torch.where(matched, skey, 0).to(col.data.dtype),
                valid=matched))
            continue
        data = torch.cat([col.data, torch.zeros(n, dtype=col.data.dtype,
                                                device=dev)])[perm]
        cols.append(Column(
            data=_flood_first(data, boundary),
            valid=((sbvw >> i) & 1).to(torch.bool) & matched))
    live = plive & (matched if kind == "inner" else is_probe)
    return Batch(columns=tuple(cols), live=live), dup


def _sorted_build(build: Batch, build_keys: tuple):
    bk, bk_valid = _combined_key(build, build_keys)
    bk_eff = torch.where(build.live & bk_valid, bk, _SENTINEL)
    sorted_keys, order = torch.sort(bk_eff, stable=True)
    return sorted_keys, order


def join_unique_build(probe: Batch, build: Batch, probe_keys: tuple,
                      build_keys: tuple, kind: str):
    """Equi-join where the build side is unique on its key (sorted build
    + binary search). kind: 'inner' | 'left' | 'semi' | 'anti'.
    Returns (out_batch, dup_count)."""
    pk, pk_valid = _combined_key(probe, probe_keys)
    n_build = build.capacity
    sorted_keys, order = _sorted_build(build, build_keys)
    dup = ((sorted_keys[1:] == sorted_keys[:-1]) &
           (sorted_keys[1:] != _SENTINEL)).sum(dtype=torch.int64)
    pos = torch.searchsorted(sorted_keys, pk)
    pos_c = pos.clamp(0, n_build - 1)
    matched = (sorted_keys[pos_c] == pk) & pk_valid & (pk != _SENTINEL)
    src = order[pos_c]

    if kind == "semi":
        return probe.with_live(probe.live & matched), dup
    if kind == "anti":
        return probe.with_live(probe.live & ~matched), dup
    build_cols = []
    for col in build.columns:
        build_cols.append(Column(data=col.data[src],
                                 valid=col.valid[src] & matched))
    live = probe.live & matched if kind == "inner" else probe.live
    return Batch(columns=probe.columns + tuple(build_cols), live=live), dup


def _expand_map(out_counts: torch.Tensor, out_capacity: int):
    """Output row j -> (probe_row, within-run offset): scatter each probe
    row's index at its output start, then a cummax floods it."""
    n = out_counts.shape[0]
    dev = out_counts.device
    cum = torch.cumsum(out_counts, 0)
    total = cum[n - 1] if n else torch.zeros((), dtype=torch.int64,
                                              device=dev)
    starts = cum - out_counts
    has = out_counts > 0
    idx = torch.where(has & (starts < out_capacity), starts, out_capacity)
    seed = torch.zeros(out_capacity + 1, dtype=torch.int64, device=dev)
    seed.scatter_reduce_(0, idx, torch.arange(n, dtype=torch.int64,
                                              device=dev) + 1, "amax")
    probe_row = torch.cummax(seed[:out_capacity], 0).values - 1
    probe_row_c = probe_row.clamp(0, max(n - 1, 0))
    j = torch.arange(out_capacity, dtype=torch.int64, device=dev)
    out_live = (j < total) & (probe_row >= 0)
    within = j - starts[probe_row_c]
    return probe_row_c, within, out_live, total


def _dense_run_luts(sorted_keys: torch.Tensor, domain: int):
    """(lo, count) per key from a sorted build; absent keys read 0."""
    n = sorted_keys.shape[0]
    dev = sorted_keys.device
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    validk = sorted_keys != _SENTINEL
    in_dom = validk & (sorted_keys >= 0) & (sorted_keys < domain)
    boundary = in_dom & ((pos == 0) | (sorted_keys != _roll1(sorted_keys)))
    run_end = in_dom & ((pos == n - 1) |
                        (torch.roll(sorted_keys, -1, 0) != sorted_keys))
    key_c = sorted_keys.clamp(0, domain - 1)
    lo_lut = torch.zeros(domain + 1, dtype=torch.int32, device=dev)
    lo_lut.scatter_reduce_(0, torch.where(boundary, key_c, domain), pos,
                           "amax")
    lo_of_row = lo_lut[key_c]
    cnt_lut = torch.zeros(domain + 1, dtype=torch.int32, device=dev)
    cnt_lut.scatter_reduce_(0, torch.where(run_end, key_c, domain),
                            pos - lo_of_row + 1, "amax")
    oob = (validk & ~in_dom).sum(dtype=torch.int64)
    return lo_lut, cnt_lut, oob


def _probe_runs(probe: Batch, build: Batch, probe_keys: tuple,
                build_keys: tuple, domain):
    """Per-probe-row (lo, count) of the matching build run, plus the build
    sort order. domain None = sorted + searchsorted."""
    pk, pk_valid = _combined_key(probe, probe_keys)
    sorted_keys, order = _sorted_build(build, build_keys)
    pk_ok = probe.live & pk_valid & (pk != _SENTINEL)
    if domain is None:
        lo = torch.searchsorted(sorted_keys, pk, side="left")
        hi = torch.searchsorted(sorted_keys, pk, side="right")
        counts = torch.where(pk_ok, hi - lo, 0)
        oob = torch.zeros((), dtype=torch.int64, device=probe.device)
    else:
        lo_lut, cnt_lut, oob = _dense_run_luts(sorted_keys, domain)
        ok = pk_ok & (pk >= 0) & (pk < domain)
        p_idx = torch.where(ok, pk, domain)
        lo = torch.where(ok, lo_lut[p_idx], 0).to(torch.int64)
        counts = torch.where(ok, cnt_lut[p_idx], 0).to(torch.int64)
    return lo, counts, order, pk_ok, oob


def join_expand(probe: Batch, build: Batch, probe_keys: tuple,
                build_keys: tuple, kind: str, out_capacity: int,
                domain=None):
    """Equi-join with arbitrary build multiplicity (1:N fan-out).
    Returns (out_batch, total_rows, oob); total_rows > out_capacity means
    grow and retry; oob > 0 means re-run with domain=None.
    kind: 'inner' | 'left'."""
    n_build = build.capacity
    lo, counts, order, pk_ok, oob = _probe_runs(
        probe, build, probe_keys, build_keys, domain)
    if kind == "left":
        out_counts = torch.maximum(counts, probe.live.to(counts.dtype))
    else:
        out_counts = counts
    probe_row_c, within, out_live, total = _expand_map(out_counts,
                                                       out_capacity)
    matched = out_live & (within < counts[probe_row_c])
    build_row = order[(lo[probe_row_c] + within).clamp(0, n_build - 1)]

    out_cols = []
    for col in probe.columns:
        out_cols.append(Column(data=col.data[probe_row_c],
                               valid=col.valid[probe_row_c] & out_live))
    for col in build.columns:
        out_cols.append(Column(data=col.data[build_row],
                               valid=col.valid[build_row] & matched))
    return Batch(columns=tuple(out_cols), live=out_live), total, oob


def compact_live(batch: Batch, cap: int):
    """Compaction to a fixed capacity. Returns (batch, overflow) where
    overflow counts live rows beyond `cap`."""
    n = batch.capacity
    idx = torch.nonzero(batch.live).flatten()[:cap]
    pad = torch.full((cap - idx.shape[0],), n, dtype=torch.int64,
                     device=batch.device)
    idx = torch.cat([idx, pad])
    ok = idx < n
    idxc = idx.clamp(0, n - 1)
    cols = tuple(Column(c.data[idxc], c.valid[idxc] & ok)
                 for c in batch.columns)
    overflow = batch.live.sum(dtype=torch.int64) - ok.sum(dtype=torch.int64)
    return Batch(cols, ok), overflow
