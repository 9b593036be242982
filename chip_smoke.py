"""On-card smoke test of the PyTorch/CUDA port (trino_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each failing the run with a non-zero exit:

1. card and toolchain: `nvidia-smi` name and power limit, torch/CUDA
   versions, and the build of every kernel from ``trino_tpu_torch/csrc``
   (one nvcc per source, all started together);
2. K1 (gather) against its plain torch version on the card, bit-exact;
3. K3 (hash insert) against its plain version on the card: multiset of
   groups exact, a forced overflow escapes, join-build duplicates counted
   exactly, and the hash-join probe equal;
4. the main path: ``Session()`` on cuda over ``tpch.sf1`` runs TPC-H q1,
   q6 and q3 (one cold run, three steady), each result checked against a
   numpy oracle computed here from the generated arrays; the kernels'
   launch counters are reset just before and read just after, and K1 and
   K3 must both have launched;
5. timing of each kernel on the inputs of its largest launch in the main
   path: kernel ms (CUDA events, median of 10), the plain version's ms,
   one library call's ms where one computes the same function, and the
   least time the card could take (bound);
6. a `kernels` JSON line, the card line, and last the result line
   ``{"ok": true, "device": {...}}``.

Without CUDA, or without the package beside it, it exits non-zero and
prints no result. It never imports jax or the reference package.
"""

from __future__ import annotations

import datetime
import json
import os
import statistics
import subprocess
import sys
import time

# the H100's data-sheet memory rate (SXM part), bytes/s
HBM_BYTES_PER_S = 3.35e12
TPCH_SCHEMA = "sf1"

Q1 = """
SELECT l_returnflag, l_linestatus,
       sum(l_quantity) AS sum_qty,
       sum(l_extendedprice) AS sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
       avg(l_quantity) AS avg_qty,
       avg(l_extendedprice) AS avg_price,
       avg(l_discount) AS avg_disc,
       count(*) AS count_order
FROM lineitem
WHERE l_shipdate <= DATE '1998-12-01' - INTERVAL '90' DAY
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus
"""

Q3 = """
SELECT l_orderkey,
       sum(l_extendedprice * (1 - l_discount)) AS revenue,
       o_orderdate, o_shippriority
FROM customer, orders, lineitem
WHERE c_mktsegment = 'BUILDING'
  AND c_custkey = o_custkey
  AND l_orderkey = o_orderkey
  AND o_orderdate < DATE '1995-03-15'
  AND l_shipdate > DATE '1995-03-15'
GROUP BY l_orderkey, o_orderdate, o_shippriority
ORDER BY revenue DESC, o_orderdate, l_orderkey
LIMIT 10
"""

Q6 = """
SELECT sum(l_extendedprice * l_discount) AS revenue
FROM lineitem
WHERE l_shipdate >= DATE '1994-01-01'
  AND l_shipdate < DATE '1994-01-01' + INTERVAL '1' YEAR
  AND l_discount BETWEEN 0.05 AND 0.07
  AND l_quantity < 24
"""


class SmokeFailure(RuntimeError):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*parts) -> None:
    print(*parts, flush=True)


# --------------------------------------------------------------------------
# numpy oracle over the generated tables (decimals are scaled int64)
# --------------------------------------------------------------------------

def _days(s: str) -> int:
    return (datetime.date.fromisoformat(s) - datetime.date(1970, 1, 1)).days


def _col(table, name):
    import numpy as np
    return np.asarray(table.columns[table.schema.index_of(name)])


def _dec(v: int, scale: int):
    from decimal import Decimal
    return Decimal(int(v)).scaleb(-scale)


def _avg_half_up(total: int, count: int) -> int:
    q, r = divmod(abs(total), count)
    q += 2 * r >= count
    return q if total >= 0 else -q


def oracle_q1(li):
    import numpy as np
    m = _col(li, "l_shipdate") <= _days("1998-09-02")
    rf, ls = _col(li, "l_returnflag")[m], _col(li, "l_linestatus")[m]
    qty, ext = _col(li, "l_quantity")[m], _col(li, "l_extendedprice")[m]
    disc, tax = _col(li, "l_discount")[m], _col(li, "l_tax")[m]
    rf_pool = li.schema.field("l_returnflag").dictionary
    ls_pool = li.schema.field("l_linestatus").dictionary
    disc_price = ext * (100 - disc)
    charge = disc_price * (100 + tax)
    out = []
    for r in range(len(rf_pool)):
        for s in range(len(ls_pool)):
            g = (rf == r) & (ls == s)
            n = int(g.sum())
            if n == 0:
                continue
            sq, se, sd = int(qty[g].sum()), int(ext[g].sum()), \
                int(disc[g].sum())
            out.append((rf_pool[r], ls_pool[s], _dec(sq, 2), _dec(se, 2),
                        _dec(int(disc_price[g].sum()), 4),
                        _dec(int(charge[g].sum()), 6),
                        _dec(_avg_half_up(sq, n), 2),
                        _dec(_avg_half_up(se, n), 2),
                        _dec(_avg_half_up(sd, n), 2), n))
    return sorted(out, key=lambda t: (t[0], t[1]))


def oracle_q6(li):
    d = _col(li, "l_shipdate")
    disc = _col(li, "l_discount")
    m = (d >= _days("1994-01-01")) & (d < _days("1995-01-01")) & \
        (disc >= 5) & (disc <= 7) & (_col(li, "l_quantity") < 2400)
    return [(_dec(int((_col(li, "l_extendedprice")[m] * disc[m]).sum()),
                  4),)]


def oracle_q3(cust, orders, li):
    import numpy as np
    seg_pool = cust.schema.field("c_mktsegment").dictionary
    seg = _col(cust, "c_mktsegment") == seg_pool.index("BUILDING")
    ck = _col(cust, "c_custkey")
    cust_ok = np.zeros(int(ck.max()) + 1, np.bool_)
    cust_ok[ck[seg]] = True
    ok_o = cust_ok[_col(orders, "o_custkey")] & \
        (_col(orders, "o_orderdate") < _days("1995-03-15"))
    okey = _col(orders, "o_orderkey")
    lut = np.full(int(okey.max()) + 1, -1, np.int64)
    lut[okey[ok_o]] = np.nonzero(ok_o)[0]
    lk = _col(li, "l_orderkey")
    m = (_col(li, "l_shipdate") > _days("1995-03-15")) & (lut[lk] >= 0)
    rev = _col(li, "l_extendedprice")[m] * (100 - _col(li, "l_discount")[m])
    keys, inv = np.unique(lk[m], return_inverse=True)
    sums = np.zeros(len(keys), np.int64)
    np.add.at(sums, inv, rev)
    orow = lut[keys]
    odate = _col(orders, "o_orderdate")[orow]
    oprio = _col(orders, "o_shippriority")[orow]
    order = np.lexsort((keys, odate, -sums))[:10]
    epoch = datetime.date(1970, 1, 1)
    return [(int(keys[i]), _dec(int(sums[i]), 4),
             (epoch + datetime.timedelta(days=int(odate[i]))).isoformat(),
             int(oprio[i])) for i in order]


# --------------------------------------------------------------------------
# timing helpers
# --------------------------------------------------------------------------

def time_cuda(fn, reps: int = 10) -> float:
    """Median ms of `fn` over `reps` runs, CUDA events around each."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bits_equal(a, b) -> bool:
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def _max_abs_err(pairs) -> float:
    import torch
    err = 0.0
    for a, b in pairs:
        if a.numel():
            err = max(err, float((a.to(torch.float64) -
                                  b.to(torch.float64)).abs().max()))
    return err


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    from trino_tpu_torch.ops import cuda_build
    secs = cuda_build.build_all()
    log(f"kernel build: {secs:.3f} s for {list(cuda_build.KERNEL_SOURCES)}")
    return smi


def phase_k1(dev):
    import torch
    from trino_tpu_torch.ops import gather as k1
    g = torch.Generator().manual_seed(1)
    W, n = 1_500_000, 6_000_000
    tables = [
        torch.randint(-2 ** 62, 2 ** 62, (W,), generator=g),
        torch.randn(W, generator=g, dtype=torch.float64),
        torch.randint(-2 ** 31, 2 ** 31 - 1, (W,), generator=g).to(
            torch.int32),
        torch.randn(W, generator=g).to(torch.float32),
        torch.randint(0, 2, (W,), generator=g).to(torch.bool)]
    fills = [-7, 2.5, -1, -0.5, True]
    idx = torch.randint(-1000, W + 1000, (n,), generator=g)
    idx[:64] = torch.tensor([-(2 ** 62), 2 ** 62, -1, W] * 16)  # wild
    tc = [t.to(dev) for t in tables]
    ic = idx.to(dev)
    got = k1.gather_columns(tc, ic, fills)
    want = k1.gather_columns_plain(tc, ic, fills)
    torch.cuda.synchronize()
    for t, a, b in zip(tc, got, want):
        require(_bits_equal(a, b), f"K1 differs from plain for {t.dtype}")
    # the q3-shaped LUT probe: an 8M-entry int32 row LUT
    D = 8_388_608
    lut = torch.randint(-1, 1_500_000, (D + 1,), generator=g).to(
        torch.int32).to(dev)
    pidx = torch.randint(0, D + 1, (n,), generator=g).to(dev)
    a = k1.gather_columns([lut], pidx)[0]
    b = k1.gather_columns_plain([lut], pidx)[0]
    torch.cuda.synchronize()
    require(_bits_equal(a, b), "K1 differs from plain on the 8M LUT")
    log(f"K1 check: bit-exact on {len(tc)} dtypes (W={W}, n={n}, misses "
        f"and wild indices) and the {D + 1}-entry LUT")


def _agg_specs(*funcs):
    from trino_tpu_torch.ops.aggregate import AggSpec
    return tuple(AggSpec(f, None if f == "count_star" else 0)
                 for f in funcs)


def _group_rows(tkey, st):
    from trino_tpu_torch.ops.hashtable import EMPTY_KEY
    import torch
    m = tkey != EMPTY_KEY
    return sorted(map(tuple, torch.cat([tkey[m][None], st[:, m]]).T
                      .tolist()))


def phase_k3(dev):
    import torch
    from trino_tpu_torch.batch import Batch, Column
    from trino_tpu_torch.ops import hashtable as ht
    g = torch.Generator().manual_seed(2)
    # the largest table: at this load (0.09) no chain nears MAX_PROBES,
    # so neither version escapes and the states must agree exactly
    rows, groups, T = 6_000_000, 12_000, 1 << 17
    key = torch.randint(0, groups, (rows,), generator=g) * 1_000_003 + 17
    slot = ht.hash_slot(key, T)
    slot[::97] = -1                                   # dead rows
    big = torch.randint(2 ** 61, 2 ** 62, (rows,), generator=g)
    vals = torch.stack([big, torch.randint(-2 ** 62, 2 ** 62, (rows,),
                                           generator=g)])
    layout, ns, nv = ht.agg_layout(_agg_specs("sum", "count", "min",
                                              "max"))
    planes = torch.stack([vals[0], vals[1], vals[1]])[:nv]
    vbits = torch.randint(0, 16, (rows,), generator=g).to(torch.int32)
    args = [t.to(dev) for t in (slot, key, vbits, planes)]
    tk, st, esc, occ = ht.hash_insert(*args, layout, ns, T)
    tk2, st2, esc2, occ2 = ht.hash_insert_plain(*args, layout, ns, T)
    torch.cuda.synchronize()
    require(int(esc) == 0 and int(esc2) == 0, "K3 escaped on 12k groups")
    require(int(occ) == int(occ2) == groups, "K3 occupancy differs")
    require(_group_rows(tk, st) == _group_rows(tk2, st2),
            "K3 group states differ from plain")
    # forced overflow: 200k distinct keys into 1024 slots
    fk = torch.arange(200_000, dtype=torch.int64, device=dev)
    fslot = ht.hash_slot(fk, 1024)
    _, _, fesc, focc = ht.hash_insert(
        fslot, fk, torch.zeros(200_000, dtype=torch.int32, device=dev),
        torch.zeros((1, 200_000), dtype=torch.int64, device=dev), (), 0,
        1024)
    require(int(fesc) > 0, "K3 forced overflow did not escape")
    # join build with duplicate keys, then the probe
    nb = 60_000                   # within the largest table's load cap
    bkeys = torch.randint(0, 48_000, (nb,), generator=g)
    dups = nb - len(torch.unique(bkeys))
    bcol = Column(bkeys.to(dev), torch.ones(nb, dtype=torch.bool,
                                            device=dev))
    pay = Column(torch.arange(nb, device=dev),
                 torch.ones(nb, dtype=torch.bool, device=dev))
    build = Batch((bcol, pay), torch.ones(nb, dtype=torch.bool, device=dev))
    slots, fits = ht.join_table_slots(nb)
    require(fits, "join table sizing")
    tkey, src, dup, jesc = ht.build_join_table(build, (0,), slots)
    require(int(jesc) == 0, "K3 join build escaped")
    require(int(dup) == dups, f"dup_rows {int(dup)} != {dups}")
    np_ = 300_000
    pkeys = torch.randint(-10, 60_000, (np_,), generator=g).to(dev)
    probe = Batch((Column(pkeys, torch.ones(np_, dtype=torch.bool,
                                            device=dev)),),
                  torch.ones(np_, dtype=torch.bool, device=dev))
    out_k = ht.hash_join_probe(probe, build, tkey, src, (0,), (0,),
                               "inner", "on")
    out_p = ht.hash_join_probe(probe, build, tkey, src, (0,), (0,),
                               "inner", "off")
    torch.cuda.synchronize()
    require(torch.equal(out_k.live, out_p.live), "hash probe live differs")
    for ca, cb in zip(out_k.columns, out_p.columns):
        require(torch.equal(ca.data[out_k.live], cb.data[out_p.live]),
                "hash probe payload differs")
    log(f"K3 check: {groups} groups over {rows} rows equal as multisets "
        f"(sums of ~500 values >= 2^61 wrap), forced overflow escaped "
        f"{int(fesc)} rows, join dup_rows={int(dup)} exact, probe equal")


def _strategy_lines(session, sql):
    rows = session.execute("EXPLAIN " + sql).rows
    return [r[0] for r in rows if r[0].startswith(("agg strategy",
                                                   "join strategy"))]


def phase_main_path(recorder):
    import torch
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.ops import gather as k1
    from trino_tpu_torch.ops import hashtable as ht
    t0 = time.monotonic()
    session = Session(default_schema=TPCH_SCHEMA)
    require(session.device.type == "cuda", "Session() is not on cuda")
    conn = session.catalog.connector("tpch")
    tables = {t: conn.get_table(TPCH_SCHEMA, t)
              for t in ("customer", "orders", "lineitem")}
    log(f"tpch.{TPCH_SCHEMA} ready in {time.monotonic() - t0:.1f} s "
        f"(lineitem {tables['lineitem'].num_rows} rows)")
    expected = {"q1": oracle_q1(tables["lineitem"]),
                "q6": oracle_q6(tables["lineitem"]),
                "q3": oracle_q3(tables["customer"], tables["orders"],
                                tables["lineitem"])}
    k1.gather_columns.launches = 0
    ht.hash_insert.launches = 0
    recorder.active = True
    per_query = {}
    for name, sql in (("q1", Q1), ("q6", Q6), ("q3", Q3)):
        before = (k1.gather_columns.launches, ht.hash_insert.launches)
        walls = []
        for run in range(4):
            t = time.monotonic()
            res = session.execute(sql)
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t)
            require(list(res.rows) == expected[name],
                    f"{name} run {run} differs from the numpy oracle:\n"
                    f"{res.rows[:3]}\nvs\n{expected[name][:3]}")
        per_query[name] = {
            "cold_s": walls[0], "steady_median_s": statistics.median(
                walls[1:]),
            "k1_launches": k1.gather_columns.launches - before[0],
            "k3_launches": ht.hash_insert.launches - before[1],
            "strategy": dict(session.executor.strategy_decisions)}
        log(f"{name}: {len(res.rows)} rows match the oracle; cold "
            f"{walls[0]:.4f} s, steady median "
            f"{per_query[name]['steady_median_s']:.4f} s (runs "
            f"{[round(w, 4) for w in walls]}); launches K1 "
            f"{per_query[name]['k1_launches']} K3 "
            f"{per_query[name]['k3_launches']}; ran "
            f"{per_query[name]['strategy']}")
        log(f"{name} EXPLAIN: {_strategy_lines(session, sql)}")
    # per-node device-synchronised times of one more q3 run
    for row in session.execute("EXPLAIN ANALYZE " + Q3).rows:
        log("q3 EXPLAIN ANALYZE | " + row[0])
    recorder.active = False
    launches = {"K1": k1.gather_columns.launches,
                "K3": ht.hash_insert.launches}
    require(per_query["q3"]["k1_launches"] > 0, "q3 did not launch K1")
    require(per_query["q3"]["k3_launches"] > 0, "q3 did not launch K3")
    log("main path: " + json.dumps({"queries": per_query,
                                     "launches": launches}))
    return launches


class LaunchRecorder:
    """Keeps the inputs of the largest K1 and K3 launch of the main path
    (by rows) so that phase 5 times the kernels on them. Wraps the launch
    functions without touching the wrappers' counters."""

    def __init__(self):
        self.active = False
        self.k1 = None
        self.k3 = None

    def install(self):
        from trino_tpu_torch.ops import gather as k1
        from trino_tpu_torch.ops import hashtable as ht
        real_k1, real_k3 = k1._launch, ht._launch

        def k1_launch(tables, idx, fills):
            if self.active and (self.k1 is None or
                                idx.shape[0] > self.k1[1].shape[0]):
                self.k1 = (list(tables), idx, list(fills))
            return real_k1(tables, idx, fills)

        def k3_launch(slot, key, vbits, vals, layout, nstates, T):
            if self.active and (self.k3 is None or
                                key.shape[0] > self.k3[1].shape[0]):
                self.k3 = (slot, key, vbits, vals, layout, nstates, T)
            return real_k3(slot, key, vbits, vals, layout, nstates, T)

        k1._launch = k1_launch
        ht._launch = k3_launch


def phase_timing(recorder, launches):
    import torch
    from trino_tpu_torch.ops import gather as k1
    from trino_tpu_torch.ops import hashtable as ht
    require(recorder.k1 is not None and recorder.k3 is not None,
            "no K1/K3 launch recorded on the main path")
    out = []
    # K1 on the largest main-path launch
    tables, idx, fills = recorder.k1
    n = idx.shape[0]
    w = tables[0].shape[0]
    got = k1.gather_columns(tables, idx, fills)
    want = k1.gather_columns_plain(tables, idx, fills)
    require(all(_bits_equal(a, b) for a, b in zip(got, want)),
            "K1 differs from plain on the main-path inputs")
    ms = time_cuda(lambda: k1.gather_columns(tables, idx, fills))
    plain_ms = time_cuda(lambda: k1.gather_columns_plain(tables, idx,
                                                         fills))
    idx_c = idx.clamp(0, w - 1)
    lib_ms = time_cuda(lambda: [torch.index_select(t, 0, idx_c)
                                for t in tables])
    out_bytes = sum(t.element_size() for t in tables) * n
    in_bytes = 8 * n + sum(t.numel() * t.element_size() for t in tables)
    bound_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    sector_ms = (8 * n + out_bytes + 32 * n * len(tables)) / \
        HBM_BYTES_PER_S * 1e3
    log(f"timing K1: n={n} W={w} tables={[str(t.dtype) for t in tables]} "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"(index_select per table) {lib_ms:.4f} ms, bound {bound_ms:.4f} ms"
        f" (each input read once), {sector_ms:.4f} ms (one DRAM sector "
        f"per random read)")
    out.append({"name": "K1 gather_columns", "route": "cuda",
                "source": "trino_tpu_torch/csrc/gather.cu",
                "replaces": "trino_tpu/ops/pallas_gather.py:155",
                "launches": launches["K1"],
                "max_abs_err": _max_abs_err(zip(got, want)),
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": "bytes", "library_ms": lib_ms})
    # K3 on the largest main-path launch
    slot, key, vbits, vals, layout, nstates, T = recorder.k3
    n = key.shape[0]
    tk, st, esc, occ = ht.hash_insert(slot, key, vbits, vals, layout,
                                      nstates, T)
    tk2, st2, esc2, occ2 = ht.hash_insert_plain(slot, key, vbits, vals,
                                                layout, nstates, T)
    require(int(esc) == 0 and int(esc2) == 0, "K3 main-path input escaped")
    ra, rb = _group_rows(tk, st), _group_rows(tk2, st2)
    require(ra == rb, "K3 differs from plain on the main-path inputs")
    err = max((abs(x - y) for a, b in zip(ra, rb) for x, y in zip(a, b)),
              default=0)
    ms = time_cuda(lambda: ht.hash_insert(slot, key, vbits, vals, layout,
                                          nstates, T))
    plain_ms = time_cuda(lambda: ht.hash_insert_plain(
        slot, key, vbits, vals, layout, nstates, T), reps=5)
    in_bytes = n * (8 + 8 + 4) + vals.numel() * 8
    out_bytes = T * 8 * (1 + nstates) + 8
    bound_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"timing K3: n={n} T={T} groups={int(occ)} states={nstates} "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library none, "
        f"bound {bound_ms:.4f} ms (bytes: inputs read once, table "
        f"written once)")
    out.append({"name": "K3 hash_insert", "route": "cuda",
                "source": "trino_tpu_torch/csrc/hash_insert.cu",
                "replaces": "trino_tpu/ops/pallas_hash.py:189",
                "launches": launches["K3"], "max_abs_err": float(err),
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": "bytes", "library_ms": None})
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    dev = torch.device("cuda")
    smi = phase_card()
    phase_k1(dev)
    phase_k3(dev)
    recorder = LaunchRecorder()
    recorder.install()
    launches = phase_main_path(recorder)
    kernels = phase_timing(recorder, launches)
    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "trino_tpu."))
              or m == "trino_tpu"]
    require(not leaked, f"imported {leaked[:5]}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
