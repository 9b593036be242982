"""K3: open-addressing hash table — hash aggregation and hash-join build.

Counterpart of ``trino_tpu/ops/pallas_hash.py`` (TPU kernel
``_insert_kernel`` launched by ``_hash_insert``; public
``hash_group_aggregate``, ``build_join_table``, ``hash_join_probe``).

One insert-or-accumulate pass over the input: home slot
``splitmix64(key + SEED) % T`` (bit for bit the reference's), linear
probing over at most MAX_PROBES slots, occupancy capped at LOAD_NUM/LOAD_DEN
of T. A row that exhausts its probes or meets an empty slot at the cap is
an escape; the caller discards the run and radix-partitions
(``exec/executor.Executor._partitioned_hash_agg``). Per aggregate the table
keeps a count and a wrapping int64 sum, min or max.

The table sizes, caps and seed are the TPU's (``MAX_TABLE_SLOTS`` and the
VMEM-derived ``max_table_slots``), so the executor picks the same table
sizes and partition counts as the reference. Lifting those VMEM-born caps
is later performance work (ROADMAP).

The kernel (``csrc/hash_insert.cu``, entry ``hash_insert_multi``) fills
G independent tables in one launch (a star's dimension builds, or every
partition of a partitioned hash aggregate), each row carrying its table
id; it computes the home slot itself and keeps per-table counters. It runs
one thread per row with 64-bit atomics; which rows escape may differ from
the TPU's sequential order, but per table ``esc > 0`` iff some live row
of it was not accumulated, and with ``esc == 0`` the occupancy is exact
and every group's states equal the sequential kernel's (a table with
escapes is discarded by the caller). The plain torch version beside it is
vectorised (up to MAX_PROBES rounds over all unresolved rows, per table)
and gives the same guarantees.

The wrapper decides by the tensors' device: CPU -> plain version, CUDA ->
kernel or raise.

Hash joins: the build side is a hash aggregation of row ids by key
(min(row_id) plus a count); duplicates show as inserted > occupied. The
probe walks each chain with MAX_PROBES rounds of K1 gathers.

K4, the fused multiway star probe (the reference's ``_multiprobe_kernel``
launched by ``multiway_probe``), probes up to MAX_MULTI_DIMS such tables,
all built at one shared slot count, in one pass over the fact rows: it
reads each dimension's key column as it lies and derives the slots
itself (``csrc/multiprobe.cu``; plain version: the reference wrapper's
encoding in torch, ``encode_probe_keys``, then ``multiway_probe_plain``).
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from ..batch import Batch, Column
from .cuda_build import check, launch_on, library

MAX_PROBES = 16              # linear-probe bound (breach = escape)
LOAD_NUM, LOAD_DEN = 5, 8    # occupancy cap 0.625 * T keeps probes short
MIN_TABLE_SLOTS = 1 << 10
MAX_TABLE_SLOTS = 1 << 17
# the reference's per-call VMEM budget; kept so table sizes match it
VMEM_TABLE_BYTES = 8 << 20
MAX_HASH_AGGS = 8

EMPTY_KEY = -(1 << 63)
_I64_MAX = (1 << 63) - 1

# slot-hash seed (the reference's _SLOT_SEED), as a signed int64
_SLOT_SEED = 0xD1B54A32D192ED03 - (1 << 64)

# aggregate kinds in the kernel's layout (csrc/hash_insert.cu)
_K_COUNT, _K_SUM, _K_MIN, _K_MAX = 0, 1, 2, 3
_KIND = {"count": _K_COUNT, "count_star": _K_COUNT, "sum": _K_SUM,
         "min": _K_MIN, "max": _K_MAX}


def resolve_mode(setting) -> str:
    """Session-property value -> 'on' | 'off' (`auto` = on, as on the
    TPU; the wrapper picks kernel or plain by device)."""
    return "on" if str(setting).lower() in ("true", "1", "auto") else "off"


def resolve_multiway_mode(setting) -> str:
    """`enable_multiway_join` -> 'on' | 'off' for the fused star probe
    (K4): the same contract as resolve_mode (`auto` = on, as on the
    TPU)."""
    return resolve_mode(setting)


def _signed(c: int) -> int:
    return c - (1 << 64) if c >= (1 << 63) else c


_SM1 = _signed(0x9E3779B97F4A7C15)
_SM2 = _signed(0xBF58476D1CE4E5B9)
_SM3 = _signed(0x94D049BB133111EB)


def _shr_logical(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (torch has no uint64
    `>>` on every device): arithmetic shift, then mask the sign copies."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on int64 bit patterns (wrapping arithmetic);
    bit-identical to the reference's uint64 form."""
    z = x + _SM1
    z = (z ^ _shr_logical(z, 30)) * _SM2
    z = (z ^ _shr_logical(z, 27)) * _SM3
    return z ^ _shr_logical(z, 31)


def hash_slot(key: torch.Tensor, table_slots: int) -> torch.Tensor:
    """Home slot per int64 key; `% T` is `& (T - 1)` on the bit pattern
    (T is a power of two)."""
    h = _splitmix64(key.to(torch.int64) + _SLOT_SEED)
    return h & (table_slots - 1)


def agg_layout(aggs: tuple):
    """Kernel layout: per aggregate (kind, value state, count state,
    value plane) — -1 where unused — plus (states, value planes)."""
    layout = []
    ns = nv = 0
    for spec in aggs:
        kind = _KIND[spec.func]
        if kind == _K_COUNT:
            layout.append((kind, -1, ns, -1))
            ns += 1
        else:
            layout.append((kind, ns, ns + 1, nv))
            ns += 2
            nv += 1
    return tuple(layout), ns, max(nv, 1)


def _tpu_state_planes(aggs: tuple) -> int:
    """int32 state planes the reference's layout uses (1 per count, 3 per
    value aggregate) — sizes its VMEM cap, which this port keeps."""
    return sum(1 if _KIND[a.func] == _K_COUNT else 3 for a in aggs)


def max_table_slots(aggs: tuple) -> int:
    """Largest power-of-two table the reference's VMEM budget allows for
    this aggregate layout (2 key planes + state planes, 4 B each)."""
    cap = VMEM_TABLE_BYTES // (4 * (2 + _tpu_state_planes(aggs)))
    t = MIN_TABLE_SLOTS
    while t * 2 <= min(cap, MAX_TABLE_SLOTS):
        t *= 2
    return t


def pick_table_slots(est_groups: int, aggs: tuple) -> Tuple[int, bool]:
    """(table_slots, fits): the smallest table whose load cap covers
    `est_groups`; fits=False means even the largest cannot."""
    cap = max_table_slots(aggs)
    t = MIN_TABLE_SLOTS
    while t * LOAD_NUM // LOAD_DEN < est_groups and t < cap:
        t *= 2
    return t, t * LOAD_NUM // LOAD_DEN >= est_groups


def join_table_slots(build_rows: int) -> Tuple[int, bool]:
    """(table_slots, fits) for a join build of `build_rows` keys."""
    cap = MIN_TABLE_SLOTS
    limit = min(MAX_TABLE_SLOTS, VMEM_TABLE_BYTES // (4 * 5))
    while cap * LOAD_NUM // LOAD_DEN < build_rows and cap < limit:
        cap *= 2
    return cap, cap * LOAD_NUM // LOAD_DEN >= build_rows


# --------------------------------------------------------------------------
# the insert-or-accumulate pass: kernel wrapper + plain version
# --------------------------------------------------------------------------

def hash_insert_plain(slot, key, vbits, vals, layout: tuple, nstates: int,
                      table_slots: int):
    """Vectorised plain version: up to MAX_PROBES rounds; in each, every
    unresolved row looks at its current slot — a matching key resolves
    it, an empty slot is claimed by the lowest row index among the rows
    there (claims in row order, within the load cap; the rest escape),
    any other key steps the row to the next slot. Resolved rows then
    accumulate with index_add_ / scatter_reduce_."""
    T = table_slots
    dev = key.device
    n = key.shape[0]
    cap = T * LOAD_NUM // LOAD_DEN
    tkey = torch.full((T,), EMPTY_KEY, dtype=torch.int64, device=dev)
    pos = torch.where(slot >= 0, slot, 0)
    active = slot >= 0
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    escaped = torch.zeros(n, dtype=torch.bool, device=dev)
    occ = 0
    for _ in range(MAX_PROBES):
        if not bool(active.any()):
            break
        cur = tkey[pos]
        done |= active & (cur == key)
        empty_rows = torch.nonzero(active & (cur == EMPTY_KEY)).flatten()
        if empty_rows.numel():
            s_e = pos[empty_rows]
            first = torch.full((T,), n, dtype=torch.int64, device=dev)
            first.scatter_reduce_(0, s_e, empty_rows, "amin")
            winners = torch.sort(first[first < n]).values
            room = max(cap - occ, 0)
            won = winners[:room]
            tkey[pos[won]] = key[won]
            occ += int(won.numel())
            after = tkey[s_e]
            done[empty_rows[after == key[empty_rows]]] = True
            escaped[empty_rows[after == EMPTY_KEY]] = True
        active = active & ~done & ~escaped
        pos = torch.where(active, torch.where(pos + 1 >= T, 0, pos + 1),
                          pos)
    escaped |= active
    st = torch.zeros((nstates, T), dtype=torch.int64, device=dev)
    rows = torch.nonzero(done).flatten()
    s = pos[rows]
    vb = vbits[rows]
    for a, (kind, vs, cs, vp) in enumerate(layout):
        bit = ((vb >> a) & 1).to(torch.bool)
        st[cs].index_add_(0, s, bit.to(torch.int64))
        if kind == _K_COUNT:
            continue
        v = vals[vp][rows]
        if kind == _K_SUM:
            st[vs].index_add_(0, s, torch.where(bit, v, 0))
            continue
        init = _I64_MAX if kind == _K_MIN else EMPTY_KEY
        red = torch.full((T,), init, dtype=torch.int64, device=dev)
        red.scatter_reduce_(0, s[bit], v[bit],
                            "amin" if kind == _K_MIN else "amax")
        st[vs] = torch.where(st[cs] > 0, red, 0)
    esc = escaped.sum(dtype=torch.int64)
    return tkey, st, esc, torch.tensor(occ, dtype=torch.int64, device=dev)


def hash_insert(slot, key, vbits, vals, layout: tuple, nstates: int,
                table_slots: int):
    """One table through K3 (``hash_insert_multi``) in the slot-plane
    form: slot/key [n] int64, slot = hash_slot(key, T) or -1 to skip the
    row (K3 computes the home slot itself, so only slot's sign is read),
    vbits [n] int32 (bit a: aggregate a takes the row), vals [NV, n]
    int64. Returns (table keys [T] int64, states [nstates, T] int64,
    escaped, occupied), the counters as 0-d int32 tensors."""
    planes = tuple((None if vp < 0 else vals[vp],
                    ((vbits >> a) & 1).to(torch.bool))
                   for a, (_kind, _vs, _cs, vp) in enumerate(layout))
    tkey, st, counters, _ = hash_insert_multi(
        key.to(torch.int64), slot >= 0, planes, layout, nstates,
        table_slots)
    return tkey[0], st[:, 0], counters[0, 0], counters[0, 1]


# the tables of one K3 launch (keys and states of every table it fills)
# stay under this many bytes; a partitioned aggregate above it takes its
# partitions in groups
MAX_LAUNCH_TABLE_BYTES = 1 << 30


def table_bytes(table_slots: int, nstates: int) -> int:
    """Device bytes of one K3 table: its keys and states, 8 B a slot
    each."""
    return 8 * table_slots * (1 + nstates)


def hash_insert_multi(key, mask, planes, layout: tuple, nstates: int,
                      table_slots: int, tables: int = 1, tid=None,
                      pairs: bool = False):
    """Run K3 over `tables` independent tables of `table_slots` slots in
    one launch. key [n] int64; mask [n] bool (False: skip the row); tid
    [n] int32, each row's table (may be None when tables == 1);
    `planes`, per aggregate of `layout`: (value [n] int32/int64, None for
    a count; validity [n] bool, None: every row the mask keeps). Returns
    (table keys [G, T] int64 (EMPTY_KEY = empty), states [nstates, G, T]
    int64, counters [G, 2] int32 (escaped, occupied), pairs): with
    `pairs` (a join build, state 0 = row id), the [G, T, 2] int64 table
    of {key, row id} slots that K4 reads, else None."""
    n = key.shape[0]
    T, G = table_slots, tables
    if key.dtype != torch.int64 or key.dim() != 1 or \
            mask.dtype != torch.bool or mask.shape != key.shape:
        raise ValueError("hash_insert_multi: key must be [n] int64 and "
                         "mask [n] bool")
    if G < 1 or (tid is None and G != 1) or (
            tid is not None and (tid.dtype != torch.int32 or
                                 tid.shape != key.shape)):
        raise ValueError("hash_insert_multi: tid must be [n] int32 "
                         "where there are several tables")
    if T & (T - 1) or not MIN_TABLE_SLOTS <= T <= MAX_TABLE_SLOTS:
        raise ValueError(f"hash_insert_multi: bad table size {T}")
    if len(layout) > MAX_HASH_AGGS or len(planes) != len(layout):
        raise ValueError("hash_insert_multi: planes do not match the "
                         "layout")
    for val, valid in planes:
        if val is not None and (val.shape != (n,) or not _is_integer(
                val.dtype)) or valid is not None and (
                valid.shape != (n,) or valid.dtype != torch.bool):
            raise ValueError("hash_insert_multi: bad value or validity "
                             "plane")
    dev = key.device
    if dev.type == "cpu":
        return hash_insert_multi_plain(key, mask, planes, layout, nstates,
                                       T, G, tid, pairs)
    if dev.type != "cuda":
        raise RuntimeError(f"hash_insert_multi: no kernel for {dev}")
    return _launch(key, mask, tid, planes, layout, nstates, T, G, pairs)


hash_insert_multi.launches = 0


def hash_insert_multi_plain(key, mask, planes, layout: tuple, nstates: int,
                            table_slots: int, tables: int = 1, tid=None,
                            pairs: bool = False):
    """Plain version of hash_insert_multi: hash_insert_plain per table,
    the home slot from hash_slot in torch."""
    T, dev = table_slots, key.device
    n = key.shape[0]
    home = hash_slot(key, T)
    vbits = torch.zeros(n, dtype=torch.int32, device=dev)
    vals = torch.zeros((_value_planes(layout), n), dtype=torch.int64,
                       device=dev)
    for a, ((_kind, _vs, _cs, vp), (val, valid)) in enumerate(
            zip(layout, planes)):
        bit = mask if valid is None else mask & valid
        vbits = vbits | (bit.to(torch.int32) << a)
        if vp >= 0:
            vals[vp] = val.to(torch.int64)
    tkeys, states, counts = [], [], []
    for g in range(tables):
        rows = mask if tid is None else mask & (tid == g)
        tk, st, esc, occ = hash_insert_plain(
            torch.where(rows, home, -1), key, vbits, vals, layout, nstates,
            T)
        tkeys.append(tk)
        states.append(st)
        counts.append([int(esc), int(occ)])
    tkey = torch.stack(tkeys)
    st = torch.stack(states, 1)
    counters = torch.tensor(counts, dtype=torch.int32, device=dev)
    return tkey, st, counters, \
        torch.stack((tkey, st[0]), -1) if pairs else None


def _value_planes(layout: tuple) -> int:
    """Value planes a layout reads (at least 1, as agg_layout gives)."""
    return max([vp + 1 for *_x, vp in layout] + [1])


class _Layout(ctypes.Structure):
    """csrc/hash_insert.cu's `Layout`."""
    _fields_ = [("kind", ctypes.c_int * MAX_HASH_AGGS),
                ("val_state", ctypes.c_int * MAX_HASH_AGGS),
                ("cnt_state", ctypes.c_int * MAX_HASH_AGGS),
                ("naggs", ctypes.c_int), ("nstates", ctypes.c_int)]


# (layout, nstates) -> (packed _Layout, its address): a plan's aggregate
# layout is packed once, not on every launch
_PACKED_LAYOUTS: dict = {}
_PlaneWords = ctypes.c_uint64 * (3 * MAX_HASH_AGGS)


def _packed_layout(layout: tuple, nstates: int) -> int:
    got = _PACKED_LAYOUTS.get((layout, nstates))
    if got is None:
        lay = _Layout()
        for a, (kind, vs, cs, _vp) in enumerate(layout):
            lay.kind[a], lay.val_state[a], lay.cnt_state[a] = kind, vs, cs
        lay.naggs, lay.nstates = len(layout), nstates
        got = _PACKED_LAYOUTS[(layout, nstates)] = (lay, ctypes.addressof(
            lay))
    return got[1]


def _launch(key, mask, tid, planes, layout, nstates, T, G, pairs):
    fn = library("hash_insert").k3_hash_insert_multi
    dev = key.device
    key, mask = key.contiguous(), mask.contiguous()
    words = [0] * (3 * MAX_HASH_AGGS)
    held = []                     # converted planes live across the call
    for a, (val, valid) in enumerate(planes):
        if val is not None:
            if val.dtype != torch.int64 and val.dtype != torch.int32:
                val = val.to(torch.int64)
            val = val.contiguous()
            held.append(val)
            words[3 * a] = val.data_ptr()
            words[3 * a + 2] = val.element_size()
        if valid is not None:
            valid = valid.contiguous()
            held.append(valid)
            words[3 * a + 1] = valid.data_ptr()
    if tid is not None:
        tid = tid.contiguous()
    gt = G * T
    cwords = G + (G & 1)          # counters, in int64 words (pairs align)
    body = cwords + gt * (1 + nstates)
    buf = torch.empty(body + (2 * gt if pairs else 0), dtype=torch.int64,
                      device=dev)
    base = buf.data_ptr()
    with launch_on(dev) as stream:
        status = fn(key.data_ptr(), mask.data_ptr(),
                    0 if tid is None else tid.data_ptr(), key.shape[0],
                    _packed_layout(layout, nstates), _PlaneWords(*words),
                    base, T, G, T * LOAD_NUM // LOAD_DEN,
                    base + 8 * body if pairs else 0, 0 if pairs else -1,
                    stream)
        check(status, "K3 hash insert launch")
        hash_insert_multi.launches += 1
    return (buf.as_strided((G, T), (T, 1), cwords),
            buf.as_strided((nstates, G, T), (gt, T, 1), cwords + gt),
            buf.view(torch.int32).as_strided((G, 2), (2, 1)),
            buf.as_strided((G, T, 2), (2 * T, 2, 1), body) if pairs
            else None)


# --------------------------------------------------------------------------
# hash aggregation over a packed key word
# --------------------------------------------------------------------------

def _is_integer(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_complex


def supports_aggs(batch: Batch, aggs: tuple) -> bool:
    """Value-side eligibility: no DISTINCT, <= MAX_HASH_AGGS aggregates,
    integer-typed (or bool) arguments only."""
    if len(aggs) > MAX_HASH_AGGS:
        return False
    for a in aggs:
        if a.distinct or a.func not in _KIND:
            return False
        if a.arg_index is not None and \
                not _is_integer(batch.columns[a.arg_index].data.dtype):
            return False
    return True


def _packed_key(batch: Batch, kmins, key_indices: tuple,
                key_bits: tuple) -> torch.Tensor:
    """The group key packed into one int64 word (digit 0 = NULL)."""
    packed = None
    for j, (ki, b) in enumerate(zip(key_indices, key_bits)):
        col = batch.columns[ki]
        digit = torch.where(col.valid,
                            col.data.to(torch.int64) - (int(kmins[j]) - 1),
                            0)
        packed = digit if packed is None else (packed << b) | digit
    return packed


def _agg_planes(batch: Batch, aggs: tuple) -> tuple:
    """K3's (value, validity) planes per aggregate: the argument column
    as it lies (counts read no value; count(*) takes every row)."""
    planes = []
    for spec in aggs:
        if spec.arg_index is None:
            planes.append((None, None))
            continue
        col = batch.columns[spec.arg_index]
        planes.append((None if _KIND[spec.func] == _K_COUNT else col.data,
                       col.valid))
    return tuple(planes)


def hash_group_aggregate(batch: Batch, kmins, key_indices: tuple,
                         key_bits: tuple, aggs: tuple, table_slots: int):
    """Group-by through the hash table. Keys pack into one int64 word with
    the layout of ``ops.aggregate.key_pack_plan`` (host `kmins`, `key_bits`).
    Returns (out_batch, escaped, n_groups); escaped > 0 means the caller
    must discard the batch and radix-partition. Output capacity is
    `table_slots`, live = occupied slots (slot order)."""
    tkey, st, counters = hash_group_aggregate_tables(
        batch, kmins, key_indices, key_bits, aggs, table_slots)
    out = group_rows(batch, tkey[0], st[:, 0], key_indices, key_bits, kmins,
                     aggs)
    return out, counters[0, 0], counters[0, 1]


def hash_group_aggregate_tables(batch: Batch, kmins, key_indices: tuple,
                                key_bits: tuple, aggs: tuple,
                                table_slots: int, tables: int = 1,
                                tid=None, live=None):
    """The insert of `hash_group_aggregate` into `tables` tables in one
    K3 launch, row i into table tid[i], for the rows `live` keeps
    (default: the batch's). Returns (table keys [G, T], states
    [nstates, G, T], counters [G, 2] int32 (escaped, occupied))."""
    layout, ns, _nv = agg_layout(aggs)
    tkey, st, counters, _ = hash_insert_multi(
        _packed_key(batch, kmins, key_indices, key_bits),
        batch.live if live is None else live, _agg_planes(batch, aggs),
        layout, ns, table_slots, tables, tid)
    return tkey, st, counters


def group_rows(batch: Batch, tkey, st, key_indices: tuple,
               key_bits: tuple, kmins, aggs: tuple) -> Batch:
    """Decode table slots (keys [m], states [nstates, m]) into the
    aggregate's output batch: group key columns, then one column per
    aggregate; live = occupied slots."""
    layout, _ns, _nv = agg_layout(aggs)
    occupied = tkey != EMPTY_KEY
    out_cols: List[Column] = []
    rem = tkey
    rev = []
    for j in range(len(key_indices) - 1, -1, -1):
        b = key_bits[j]
        digit = rem & ((1 << b) - 1)
        rem = rem >> b
        col = batch.columns[key_indices[j]]
        rev.append(Column(
            data=(digit - 1 + int(kmins[j])).to(col.data.dtype),
            valid=occupied & (digit != 0)))
    out_cols.extend(reversed(rev))

    for a, spec in enumerate(aggs):
        kind, vs, cs, vp = layout[a]
        cnt = st[cs]
        if kind == _K_COUNT:
            out_cols.append(Column(data=cnt, valid=occupied))
            continue
        valid = occupied & (cnt > 0)
        if kind == _K_SUM:
            out_cols.append(Column(data=st[vs], valid=valid))
        else:
            dt = batch.columns[spec.arg_index].data.dtype
            out_cols.append(Column(data=st[vs].to(dt), valid=valid))
    return Batch(columns=tuple(out_cols), live=occupied)


# --------------------------------------------------------------------------
# hybrid hash join: build = hash aggregation of row ids, probe = chained
# K1 gathers
# --------------------------------------------------------------------------

_JOIN_LAYOUT = ((_K_MIN, 0, 1, 0),)     # min(row_id) + its count


def _join_builds(builds, keys_per_build, table_slots: int, pairs: bool):
    """k hash-join builds in one K3 launch, build d into table d: every
    valid build key with min(row_id) as payload. Returns (table keys
    [k, T], src [k, T] int64 row ids, dup_rows [k], escaped [k]); with
    `pairs` the two planes are views of the interleaved table K4 reads.
    Per build the reference's accounting: keys equal to EMPTY_KEY are
    force-escaped, and dup_rows = ok rows - forced - escaped - occupied."""
    from .join import _combined_key
    dev = builds[0].device
    keys, oks, rows, n_valid, n_ok = [], [], [], [], []
    for b, bk_idx in zip(builds, keys_per_build):
        bk, bk_valid = _combined_key(b, bk_idx)
        valid = b.live & bk_valid
        ok = valid & (bk != EMPTY_KEY)
        keys.append(bk)
        oks.append(ok)
        rows.append(torch.arange(b.capacity, dtype=torch.int32, device=dev))
        n_valid.append(valid.sum(dtype=torch.int64))
        n_ok.append(ok.sum(dtype=torch.int64))
    k = len(builds)
    tid = None if k == 1 else torch.cat([
        torch.full((b.capacity,), d, dtype=torch.int32, device=dev)
        for d, b in enumerate(builds)])
    tkey, st, counters, pr = hash_insert_multi(
        torch.cat(keys) if k > 1 else keys[0],
        torch.cat(oks) if k > 1 else oks[0],
        ((torch.cat(rows) if k > 1 else rows[0], None),), _JOIN_LAYOUT, 2,
        table_slots, k, tid, pairs)
    n_ok = torch.stack(n_ok)
    forced = torch.stack(n_valid) - n_ok
    esc, occ = counters[:, 0], counters[:, 1]
    if pr is not None:
        tkey, src = pr[..., 0], pr[..., 1]
    else:
        src = st[0]
    return tkey, src, n_ok - forced - esc - occ, esc + forced


def build_join_table(build: Batch, build_keys: tuple, table_slots: int):
    """Hash-join build: insert every valid build key with min(row_id) as
    payload. Returns (table keys [T], src [T] int64 row ids, dup_rows,
    escaped) — dup_rows > 0 breaks a unique-build contract, escaped > 0
    means the table overflowed. Keys equal to EMPTY_KEY are force-escaped
    (same accounting as the reference)."""
    tkey, src, dup, esc = _join_builds([build], [build_keys], table_slots,
                                       False)
    return tkey[0], src[0], dup[0], esc[0]


def build_join_tables(builds, keys_per_build, table_slots: int):
    """A star's dimension builds in one K3 launch, all at one shared
    `table_slots`: build d is `build_join_table(builds[d],
    keys_per_build[d], table_slots)`. Returns (table keys [k, T], src
    [k, T], dup_rows [k], escaped [k]); keys and src are the two lanes of
    the interleaved {key, row id} table that ``multiway_probe`` reads
    with one load per probe step."""
    return _join_builds(builds, keys_per_build, table_slots, True)


def hash_join_probe(probe: Batch, build: Batch, tkey, src,
                    probe_keys: tuple, build_keys: tuple, kind: str,
                    gather_mode: str = "off"):
    """Probe a built, validated table: MAX_PROBES rounds of fused
    (key, row id) gathers walk each probe's chain (K1 when `gather_mode`
    is on); an empty slot or an exhausted chain is a definitive miss.
    Payload columns go through the dense join's gather machinery."""
    from .gather import gather_columns, gather_columns_plain
    from .join import _combined_key, _gather_build_payload
    table_slots = tkey.shape[0]
    pk, pk_valid = _combined_key(probe, probe_keys)
    ok = probe.live & pk_valid & (pk != EMPTY_KEY)
    slot = torch.where(ok, hash_slot(pk, table_slots), 0)
    unresolved = ok
    found = torch.full((probe.capacity,), -1, dtype=torch.int64,
                       device=probe.device)
    gather = gather_columns if gather_mode != "off" else \
        gather_columns_plain
    for _ in range(MAX_PROBES):
        key_at, src_at = gather([tkey, src], slot, fills=[EMPTY_KEY, -1])
        empty = key_at == EMPTY_KEY
        hit = unresolved & ~empty & (key_at == pk)
        found = torch.where(hit, src_at, found)
        unresolved = unresolved & ~empty & ~hit
        slot = torch.where(slot + 1 >= table_slots, 0, slot + 1)
    matched = found >= 0
    if kind == "semi":
        return probe.with_live(probe.live & matched)
    if kind == "anti":
        return probe.with_live(probe.live & ~matched)
    src_c = found.clamp(0, build.capacity - 1)
    return _gather_build_payload(probe, build, src_c, matched, pk,
                                 build_keys, kind, gather_mode)


def shard_join(probe: Batch, build: Batch, probe_keys: tuple,
               build_keys: tuple, kind: str, table_slots: int,
               gather_mode: str = "off"):
    """Shard-local fused build + probe: the per-shard body of the
    mesh-partitioned join (parallel/stages.partitioned_hash_join_step).
    One K3 launch builds the shard's table, `hash_join_probe` walks it (K1
    when `gather_mode` is on); the caller sums (dup_rows, escaped) over
    the mesh and owns the degrade decision (dup -> expansion join, escape
    -> host equi-join). Returns (joined, dup_rows, escaped)."""
    tkey, src, dup_rows, escaped = build_join_table(build, build_keys,
                                                    table_slots)
    joined = hash_join_probe(probe, build, tkey, src, probe_keys,
                             build_keys, kind, gather_mode)
    return joined, dup_rows, escaped


# --------------------------------------------------------------------------
# K4: fused multiway star probe over k dimension tables, one pass
# --------------------------------------------------------------------------

MAX_MULTI_DIMS = 5           # q5-class stars top out here; the planner cap


def multiway_table_bytes(k: int, table_slots: int) -> int:
    """The reference's resident footprint of k fused dimension tables (3
    int32 planes per slot: key lo, key hi, row id), kept so the
    executor's `multiway_vmem_kb` budget sheds the same dimensions."""
    return 3 * 4 * k * table_slots


def _probe_key(probe: Batch, key_indices: tuple):
    """A dimension's fact-side key as K4 reads it: a one-column key as the
    column lies (int32 or int64), a wider one combined into int64; with
    its validity plane."""
    if len(key_indices) == 1:
        col = probe.columns[key_indices[0]]
        if col.data.dtype in (torch.int32, torch.int64):
            return col.data, col.valid
    from .join import _combined_key
    return _combined_key(probe, key_indices)


def multiway_probe(probe: Batch, tkey: torch.Tensor, src: torch.Tensor,
                   probe_keys: tuple):
    """Fused star probe: k dup/escape-validated dimension tables
    (`build_join_tables` outputs, or any [k, T] key and row-id planes,
    all built at one shared T) probed in one pass over the fact batch.
    `probe_keys` holds the fact-side key index tuple of each dimension.
    Returns (found [k, n] int32 build row ids, -1 = miss at or before
    that dimension; miss [k] int64, the rows alive entering dimension d
    that failed there), as the reference's ``multiway_probe``. Payload
    gathers stay with the caller. On a card, one memset and one kernel:
    K4 reads the key columns and derives the slots itself. It reads the
    interleaved table build_join_tables gives; other planes cost one
    torch.stack first."""
    k = len(probe_keys)
    if tkey.dim() != 2 or tkey.shape != src.shape or \
            tkey.dtype != torch.int64 or src.dtype != torch.int64 or \
            tkey.shape[0] != k:
        raise ValueError("multiway_probe: tables must be [k, T] int64")
    T = tkey.shape[1]
    if not 1 <= k <= MAX_MULTI_DIMS or T <= 0 or T & (T - 1):
        raise ValueError(f"multiway_probe: bad k={k} or T={T}")
    keys = [_probe_key(probe, pk) for pk in probe_keys]
    dev = probe.device
    if dev.type == "cpu":
        return _multiway_probe_keys_plain(probe.live, keys, tkey, src)
    if dev.type != "cuda":
        raise RuntimeError(f"multiway_probe: no kernel for {dev}")
    return _launch_multiprobe(probe.live, keys, tkey, src)


multiway_probe.launches = 0


def encode_probe_keys(live, keys, table_slots: int):
    """The reference wrapper's encoding of a star's fact keys, in torch:
    (slot, key) [k, n] int64 with slot -2 = dead row, -1 = live row with a
    NULL or sentinel key, else the home slot, and key 0 where slot < 0.
    `keys` holds each dimension's (key, validity) planes."""
    slots, planes = [], []
    for key, valid in keys:
        key = key.to(torch.int64)
        ok = live & valid & (key != EMPTY_KEY)
        slots.append(torch.where(ok, hash_slot(key, table_slots),
                                 torch.where(live, -1, -2)))
        planes.append(torch.where(ok, key, 0))
    return torch.stack(slots), torch.stack(planes)


def _multiway_probe_keys_plain(live, keys, tkey, src):
    """Plain version of multiway_probe: encode_probe_keys, then
    multiway_probe_plain."""
    return multiway_probe_plain(*encode_probe_keys(live, keys,
                                                   tkey.shape[1]),
                                tkey, src)


def multiway_probe_plain(slot, key, tkey, src):
    """Vectorised plain version on encoded inputs (slot/key [k, n] int64,
    as ``multiway_probe_slots``): per dimension up to MAX_PROBES rounds
    of gathers over the unresolved rows; the short-circuit is a live-mask
    AND carried from one dimension to the next. found is int32."""
    k, n = slot.shape
    T = tkey.shape[1]
    dev = slot.device
    found = torch.full((k, n), -1, dtype=torch.int32, device=dev)
    miss = torch.zeros(k, dtype=torch.int64, device=dev)
    alive = slot[0] != -2
    for d in range(k):
        ok = alive & (slot[d] >= 0)
        pos = torch.where(ok, slot[d], 0)
        unresolved = ok
        hit = torch.zeros_like(ok)
        for _ in range(MAX_PROBES):
            if not bool(unresolved.any()):
                break
            at = tkey[d][pos]
            empty = at == EMPTY_KEY
            m = unresolved & ~empty & (at == key[d])
            found[d] = torch.where(m, src[d][pos].to(torch.int32), found[d])
            hit = hit | m
            unresolved = unresolved & ~empty & ~m
            pos = torch.where(pos + 1 >= T, 0, pos + 1)
        miss[d] = (alive & ~hit).sum()
        alive = hit
    return found, miss


def multiway_probe_slots(slot, key, tkey, src):
    """K4 on the reference wrapper's encoded inputs: slot/key [k, n] int64
    (slot -2 = dead row, -1 = live row with a NULL or sentinel key, else
    hash_slot(key, T): the kernel derives the home slot from the key, so
    only slot's sign is read), tkey/src [k, T] int64. Returns (found
    [k, n] int32, miss [k] int64)."""
    for t in (slot, key, tkey, src):
        if t.device != slot.device:
            raise ValueError("multiway_probe: inputs must share a device")
        if t.dtype != torch.int64 or t.dim() != 2:
            raise ValueError("multiway_probe: inputs must be 2-D int64")
    k, n = slot.shape
    T = tkey.shape[1]
    if key.shape != (k, n) or tkey.shape != (k, T) or src.shape != (k, T):
        raise ValueError("multiway_probe: shape mismatch")
    if not 1 <= k <= MAX_MULTI_DIMS or T <= 0 or T & (T - 1):
        raise ValueError(f"multiway_probe: bad k={k} or T={T}")
    dev = slot.device
    if dev.type == "cpu":
        return multiway_probe_plain(slot, key, tkey, src)
    if dev.type != "cuda":
        raise RuntimeError(f"multiway_probe: no kernel for {dev}")
    return _launch_multiprobe(slot[0] != -2,
                              [(key[d], slot[d] >= 0) for d in range(k)],
                              tkey, src)


_DimWords = ctypes.c_uint64 * (3 * MAX_MULTI_DIMS)


def _is_interleaved(tkey, src) -> bool:
    """Whether tkey/src are the two lanes of one contiguous, 16-byte
    aligned [k, T, 2] {key, row id} table, as build_join_tables gives
    them."""
    k, T = tkey.shape
    return (src.data_ptr() == tkey.data_ptr() + 8 and
            tkey.stride(1) == 2 and src.stride() == tkey.stride() and
            (k == 1 or tkey.stride(0) == 2 * T) and
            tkey.data_ptr() % 16 == 0)


def _launch_multiprobe(live, keys, tkey, src):
    fn = library("multiprobe").k4_multiprobe
    k, T = tkey.shape
    n = live.shape[0]
    dev = live.device
    live = live.contiguous()
    words = [0] * (3 * MAX_MULTI_DIMS)
    held = []                     # converted planes live across the call
    for d, (key, valid) in enumerate(keys):
        if key.shape != (n,) or valid.shape != (n,) or \
                valid.dtype != torch.bool or key.device != dev or \
                valid.device != dev:
            raise ValueError("multiway_probe: a key plane does not match "
                             "the fact batch")
        if key.dtype != torch.int64 and key.dtype != torch.int32:
            key = key.to(torch.int64)
        key, valid = key.contiguous(), valid.contiguous()
        held += [key, valid]
        words[3 * d] = key.data_ptr()
        words[3 * d + 1] = valid.data_ptr()
        words[3 * d + 2] = key.element_size()
    if tkey.device != dev or src.device != dev:
        raise ValueError("multiway_probe: tables must be on the batch's "
                         "device")
    # K4 reads the interleaved table; other tables (two planes, as the
    # slot-level tests give them) are interleaved here, k * T * 16 B
    if not _is_interleaved(tkey, src):
        tkey = torch.stack((tkey, src), -1)[..., 0]
    found = torch.empty((k, n), dtype=torch.int32, device=dev)
    miss = torch.empty(k, dtype=torch.int64, device=dev)
    with launch_on(dev) as stream:
        status = fn(live.data_ptr(), _DimWords(*words), n, k,
                    tkey.data_ptr(), T, found.data_ptr(), miss.data_ptr(),
                    stream)
        check(status, "K4 multiway probe launch")
        multiway_probe.launches += 1
    return found, miss
