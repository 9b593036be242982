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

The kernel (``csrc/hash_insert.cu``) runs one thread per row with 64-bit
atomics; which rows escape may differ from the TPU's sequential order, but
``esc > 0`` iff some live row was not accumulated, and with ``esc == 0``
the occupancy is exact and every group's states equal the sequential
kernel's (a run with escapes is discarded by the caller).
The plain torch version beside it is vectorised (up to MAX_PROBES rounds
over all unresolved rows) and gives the same guarantees.

The wrapper decides by the tensors' device: CPU -> plain version, CUDA ->
kernel or raise.

Hash joins: the build side is a hash aggregation of row ids by key
(min(row_id) plus a count); duplicates show as inserted > occupied. The
probe walks each chain with MAX_PROBES rounds of K1 gathers.

K4, the fused multiway star probe (the reference's ``_multiprobe_kernel``
launched by ``multiway_probe``), probes up to MAX_MULTI_DIMS such tables,
all built at one shared slot count, in one pass over the fact rows
(``csrc/multiprobe.cu``; plain version ``multiway_probe_plain``).
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from ..batch import Batch, Column
from .cuda_build import check, library, raw_stream

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
    """Run K3. slot/key [n] int64 (slot -1 = skip row), vbits [n] int32
    (bit a: aggregate a takes the row), vals [NV, n] int64. Returns
    (table keys [T] int64, states [nstates, T] int64, escaped, occupied)
    with the counters as 0-d int64 tensors."""
    dev = key.device
    for t in (slot, key, vbits, vals):
        if t.device != dev:
            raise ValueError("hash_insert: inputs must share a device")
        if t.dtype.is_floating_point or t.dtype == torch.bool:
            raise ValueError("hash_insert: inputs must be integer tensors")
    n = key.shape[0]
    if slot.shape != (n,) or vbits.shape != (n,) or vals.dim() != 2 or \
            vals.shape[1] != n:
        raise ValueError("hash_insert: shape mismatch")
    if table_slots & (table_slots - 1) or not \
            MIN_TABLE_SLOTS <= table_slots <= MAX_TABLE_SLOTS:
        raise ValueError(f"hash_insert: bad table size {table_slots}")
    if len(layout) > MAX_HASH_AGGS:
        raise ValueError("hash_insert: too many aggregates")
    if dev.type == "cpu":
        return hash_insert_plain(slot, key, vbits, vals, layout, nstates,
                                 table_slots)
    if dev.type != "cuda":
        raise RuntimeError(f"hash_insert: no kernel for {dev}")
    return _launch(slot, key, vbits, vals, layout, nstates, table_slots)


hash_insert.launches = 0


def _launch(slot, key, vbits, vals, layout, nstates, T):
    fn = library("hash_insert").k3_hash_insert
    slot = slot.to(torch.int64).contiguous()
    key = key.to(torch.int64).contiguous()
    vbits = vbits.to(torch.int32).contiguous()
    vals = vals.to(torch.int64).contiguous()
    n = key.shape[0]
    dev = key.device
    tkey = torch.empty(T, dtype=torch.int64, device=dev)
    st = torch.empty((max(nstates, 1), T), dtype=torch.int64, device=dev)
    counters = torch.empty(2, dtype=torch.int32, device=dev)
    k = len(layout)
    arr = [(ctypes.c_int * max(k, 1))(*[row[j] for row in layout])
           for j in range(4)]
    stream = raw_stream(dev)
    status = fn(slot.data_ptr(), key.data_ptr(), vbits.data_ptr(),
                vals.data_ptr(), n, tkey.data_ptr(), st.data_ptr(), T,
                T * LOAD_NUM // LOAD_DEN, counters.data_ptr(),
                *[ctypes.cast(a, ctypes.c_void_p) for a in arr],
                k, nstates, stream)
    check(status, "K3 hash insert launch")
    hash_insert.launches += 1
    c = counters.to(torch.int64)
    return tkey, st[:nstates], c[0], c[1]


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


def hash_group_aggregate(batch: Batch, kmins, key_indices: tuple,
                         key_bits: tuple, aggs: tuple, table_slots: int):
    """Group-by through the hash table. Keys pack into one int64 word with
    the layout of ``ops.aggregate.key_pack_plan`` (host `kmins`, `key_bits`).
    Returns (out_batch, escaped, n_groups); escaped > 0 means the caller
    must discard the batch and radix-partition. Output capacity is
    `table_slots`, live = occupied slots (slot order)."""
    n = batch.capacity
    dev = batch.device
    packed = torch.zeros(n, dtype=torch.int64, device=dev)
    for j, (ki, b) in enumerate(zip(key_indices, key_bits)):
        col = batch.columns[ki]
        norm = col.data.to(torch.int64) - int(kmins[j]) + 1
        packed = (packed << b) | torch.where(col.valid, norm, 0)
    slot = torch.where(batch.live, hash_slot(packed, table_slots), -1)

    layout, ns, nv = agg_layout(aggs)
    vbits = torch.zeros(n, dtype=torch.int32, device=dev)
    vplanes: List[torch.Tensor] = [torch.zeros(n, dtype=torch.int64,
                                               device=dev)] * nv
    for a, spec in enumerate(aggs):
        if spec.arg_index is None:
            bit = batch.live
        else:
            bit = batch.live & batch.columns[spec.arg_index].valid
        vbits = vbits | (bit.to(torch.int32) << a)
        kind, vs, cs, vp = layout[a]
        if kind != _K_COUNT:
            col = batch.columns[spec.arg_index]
            vplanes[vp] = torch.where(bit, col.data.to(torch.int64), 0)

    tkey, st, esc, occ = hash_insert(slot, packed, vbits,
                                     torch.stack(vplanes), layout, ns,
                                     table_slots)
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
    return Batch(columns=tuple(out_cols), live=occupied), esc, occ


# --------------------------------------------------------------------------
# hybrid hash join: build = hash aggregation of row ids, probe = chained
# K1 gathers
# --------------------------------------------------------------------------

_JOIN_LAYOUT = ((_K_MIN, 0, 1, 0),)     # min(row_id) + its count


def build_join_table(build: Batch, build_keys: tuple, table_slots: int):
    """Hash-join build: insert every valid build key with min(row_id) as
    payload. Returns (table keys [T], src [T] int64 row ids, dup_rows,
    escaped) — dup_rows > 0 breaks a unique-build contract, escaped > 0
    means the table overflowed. Keys equal to EMPTY_KEY are force-escaped
    (same accounting as the reference)."""
    from .join import _combined_key
    dev = build.device
    bk, bk_valid = _combined_key(build, build_keys)
    ok = build.live & bk_valid & (bk != EMPTY_KEY)
    forced = (build.live & bk_valid & (bk == EMPTY_KEY)).sum(
        dtype=torch.int64)
    slot = torch.where(ok, hash_slot(bk, table_slots), -1)
    rows = torch.arange(build.capacity, dtype=torch.int64, device=dev)
    tkey, st, esc, occ = hash_insert(slot, bk, ok.to(torch.int32),
                                     rows[None], _JOIN_LAYOUT, 2,
                                     table_slots)
    n_ok = ok.sum(dtype=torch.int64)
    escaped = esc + forced
    dup_rows = n_ok - forced - esc - occ
    return tkey, st[0], dup_rows, escaped


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


# --------------------------------------------------------------------------
# K4: fused multiway star probe over k dimension tables, one pass
# --------------------------------------------------------------------------

MAX_MULTI_DIMS = 5           # q5-class stars top out here; the planner cap


def multiway_table_bytes(k: int, table_slots: int) -> int:
    """The reference's resident footprint of k fused dimension tables (3
    int32 planes per slot: key lo, key hi, row id), kept so the
    executor's `multiway_vmem_kb` budget sheds the same dimensions."""
    return 3 * 4 * k * table_slots


def multiway_probe(probe: Batch, tkey: torch.Tensor, src: torch.Tensor,
                   probe_keys: tuple):
    """Fused star probe: k dup/escape-validated dimension tables
    (`build_join_table` outputs stacked to tkey/src [k, T], all built at
    one shared T) probed in one pass over the fact batch. `probe_keys`
    holds the fact-side key index tuple of each dimension. Returns
    (found [k, n] int64 build row ids, -1 = miss at or before that
    dimension; miss [k] int64, the rows alive entering dimension d that
    failed there). Payload gathers stay with the caller."""
    from .join import _combined_key
    T = tkey.shape[1]
    slots, keys = [], []
    for pk_idx in probe_keys:
        pk, pk_valid = _combined_key(probe, pk_idx)
        ok = probe.live & pk_valid & (pk != EMPTY_KEY)
        slots.append(torch.where(ok, hash_slot(pk, T),
                                 torch.where(probe.live, -1, -2)))
        keys.append(torch.where(ok, pk.to(torch.int64), 0))
    return multiway_probe_slots(torch.stack(slots), torch.stack(keys),
                                tkey, src)


multiway_probe.launches = 0


def multiway_probe_plain(slot, key, tkey, src):
    """Vectorised plain version: per dimension up to MAX_PROBES rounds of
    gathers over the unresolved rows; the short-circuit is a live-mask
    AND carried from one dimension to the next."""
    k, n = slot.shape
    T = tkey.shape[1]
    dev = slot.device
    found = torch.full((k, n), -1, dtype=torch.int64, device=dev)
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
            found[d] = torch.where(m, src[d][pos], found[d])
            hit = hit | m
            unresolved = unresolved & ~empty & ~m
            pos = torch.where(pos + 1 >= T, 0, pos + 1)
        miss[d] = (alive & ~hit).sum()
        alive = hit
    return found, miss


def multiway_probe_slots(slot, key, tkey, src):
    """Run K4 on encoded inputs: slot/key [k, n] int64 (slot -2 = dead
    row, -1 = live row with a NULL or sentinel key, else the home slot),
    tkey/src [k, T] int64. Returns (found [k, n], miss [k]) int64."""
    for t in (slot, key, tkey, src):
        if t.device != slot.device:
            raise ValueError("multiway_probe: inputs must share a device")
        if t.dtype != torch.int64 or t.dim() != 2:
            raise ValueError("multiway_probe: inputs must be 2-D int64")
    k, n = slot.shape
    T = tkey.shape[1]
    if key.shape != (k, n) or tkey.shape != (k, T) or src.shape != (k, T):
        raise ValueError("multiway_probe: shape mismatch")
    if not 1 <= k <= MAX_MULTI_DIMS or T <= 0:
        raise ValueError(f"multiway_probe: bad k={k} or T={T}")
    dev = slot.device
    if dev.type == "cpu":
        return multiway_probe_plain(slot, key, tkey, src)
    if dev.type != "cuda":
        raise RuntimeError(f"multiway_probe: no kernel for {dev}")
    return _launch_multiprobe(slot, key, tkey, src)


def _launch_multiprobe(slot, key, tkey, src):
    fn = library("multiprobe").k4_multiprobe
    slot, key, tkey, src = (t.contiguous() for t in (slot, key, tkey, src))
    k, n = slot.shape
    T = tkey.shape[1]
    found = torch.empty((k, n), dtype=torch.int64, device=slot.device)
    miss = torch.empty(k, dtype=torch.int64, device=slot.device)
    stream = raw_stream(slot.device)
    status = fn(slot.data_ptr(), key.data_ptr(), tkey.data_ptr(),
                src.data_ptr(), n, k, T, found.data_ptr(), miss.data_ptr(),
                stream)
    check(status, "K4 multiway probe launch")
    multiway_probe.launches += 1
    return found, miss
