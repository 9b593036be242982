"""The end-to-end TPC-H configurations: SQL text to host rows at scale.

The JAX package's harness (``bench.py``) runs, by default, three
configurations end to end, each held against a single-node numpy
oracle over the same host arrays, to the cent:

- ``q5``: a q5-shaped TPC-H star at SF100 (only q5's columns, dbgen's
  formulas; about 600 M lineitem rows) streamed through the chunked
  driver (``exec/chunked.py``) from the narrowed fact-column cache
  (``exec/device_cache.py``);
- ``q6``: TPC-H q6 at ``tpch.sf1`` (scan, filter, global aggregate);
- ``q3``: TPC-H q3 at ``tpch.sf10`` (two joins and a grouped aggregate).

This module is that harness's default mode for the port. Names,
parameters, defaults and record keys are the reference's; the timings
are ``cold_ms`` (the first run: kernel builds and the upload included)
and ``steady_ms`` (the median of the later runs), and each record adds
the card's name and power limit, the fact cache's device bytes, the
peak allocated bytes, each kernel's launches, the star's degrade
reasons and the host's memory and CPU count.

Generated data goes under ``connectors/diskcache.cache_root()``: the
caller's ``$TRINO_TPU_DATA_CACHE`` when it is set, else a temporary
directory that the run removes at its end, so no data lands in the
repository's tree.

    python -m trino_tpu_torch.e2e [--only q5,q3] [--q5-scale N]
        [--chunk-rows N] [--runs N] [--device cpu] [--out PATH]

prints one JSON record and exits 0 when every configuration it ran was
verified. Everything runs on the card unless given ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

PREWARM = 1
RUNS = 3

Q6 = """
SELECT sum(l_extendedprice * l_discount) AS revenue
FROM lineitem
WHERE l_shipdate >= DATE '1994-01-01'
  AND l_shipdate < DATE '1994-01-01' + INTERVAL '1' YEAR
  AND l_discount BETWEEN 0.05 AND 0.07
  AND l_quantity < 24
"""

Q3 = """
SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) AS revenue,
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

Q5 = """
SELECT n_name, sum(l_extendedprice * (1 - l_discount)) AS revenue
FROM customer, orders, lineitem, supplier, nation, region
WHERE c_custkey = o_custkey
  AND l_orderkey = o_orderkey
  AND l_suppkey = s_suppkey
  AND c_nationkey = s_nationkey
  AND s_nationkey = n_nationkey
  AND n_regionkey = r_regionkey
  AND r_name = 'ASIA'
  AND o_orderdate >= DATE '1994-01-01'
  AND o_orderdate < DATE '1994-01-01' + INTERVAL '1' YEAR
GROUP BY n_name
ORDER BY revenue DESC
"""


# ---------------------------------------------------------------------------
# the oracles: single-node vectorized numpy over the same host arrays
# ---------------------------------------------------------------------------

def col(table, name):
    return np.asarray(table.columns[table.schema.index_of(name)])


def _days(s):
    return (np.datetime64(s) - np.datetime64("1970-01-01")).astype(int)


def numpy_q6(tables):
    li = tables["lineitem"]
    ship = col(li, "l_shipdate")
    disc = col(li, "l_discount")
    qty = col(li, "l_quantity")
    price = col(li, "l_extendedprice")
    m = (ship >= _days("1994-01-01")) & (ship < _days("1995-01-01")) & \
        (disc >= 5) & (disc <= 7) & (qty < 2400)
    return int((price[m] * disc[m]).sum())


def numpy_q3(tables):
    cust, orders, li = tables["customer"], tables["orders"], \
        tables["lineitem"]
    seg_pool = cust.schema.field("c_mktsegment").dictionary
    seg_code = seg_pool.index("BUILDING")
    ck = col(cust, "c_custkey")[col(cust, "c_mktsegment") == seg_code]
    cutoff = _days("1995-03-15")
    od = col(orders, "o_orderdate")
    om = od < cutoff
    okey, ocust = col(orders, "o_orderkey")[om], \
        col(orders, "o_custkey")[om]
    od_f, oprio = od[om], col(orders, "o_shippriority")[om]
    ck_sorted = np.sort(ck)
    pos = np.clip(np.searchsorted(ck_sorted, ocust), 0,
                  len(ck_sorted) - 1)
    keep = ck_sorted[pos] == ocust
    okey, od_f, oprio = okey[keep], od_f[keep], oprio[keep]
    order_o = np.argsort(okey, kind="stable")
    okey_s, od_s = okey[order_o], od_f[order_o]
    lk = col(li, "l_orderkey")
    lm = col(li, "l_shipdate") > cutoff
    lk, price, disc = lk[lm], col(li, "l_extendedprice")[lm], \
        col(li, "l_discount")[lm]
    pos = np.clip(np.searchsorted(okey_s, lk), 0, len(okey_s) - 1)
    keep = okey_s[pos] == lk
    lk = lk[keep]
    rev = price[keep] * (100 - disc[keep])     # scaled 1e4
    uniq, inv = np.unique(lk, return_inverse=True)
    sums = np.bincount(inv, weights=rev.astype(np.float64))
    upos = np.clip(np.searchsorted(okey_s, uniq), 0, len(okey_s) - 1)
    order = np.lexsort((uniq, od_s[upos], -sums))
    top = order[:10]
    return [(int(uniq[i]), float(sums[i]) / 1e4) for i in top]


def numpy_q5(tables, chunk=1 << 26):
    nat, reg = tables["nation"], tables["region"]
    sup, cust = tables["supplier"], tables["customer"]
    orders, li = tables["orders"], tables["lineitem"]
    r_pool = reg.schema.field("r_name").dictionary
    asia = r_pool.index("ASIA")
    asia_regionkeys = col(reg, "r_regionkey")[col(reg, "r_name") == asia]
    asia_nations = col(nat, "n_nationkey")[
        np.isin(col(nat, "n_regionkey"), asia_regionkeys)]
    od = col(orders, "o_orderdate")
    om = (od >= _days("1994-01-01")) & (od < _days("1995-01-01"))
    okey, ocust = col(orders, "o_orderkey")[om], \
        col(orders, "o_custkey")[om]
    c_nation = col(cust, "c_nationkey")      # custkey dense 1..N
    o_nation = c_nation[ocust - 1]
    ok = np.isin(o_nation, asia_nations)
    okey, o_nation = okey[ok], o_nation[ok]
    order_o = np.argsort(okey, kind="stable")
    okey_s, onat_s = okey[order_o], o_nation[order_o]
    s_nation = col(sup, "s_nationkey")
    acc = np.zeros(25, dtype=np.float64)
    n = li.num_rows
    lk_all, ls_all = col(li, "l_orderkey"), col(li, "l_suppkey")
    price_all, disc_all = col(li, "l_extendedprice"), \
        col(li, "l_discount")
    for start in range(0, n, chunk):
        lk = lk_all[start:start + chunk]
        ls = ls_all[start:start + chunk]
        price = price_all[start:start + chunk]
        disc = disc_all[start:start + chunk]
        pos = np.clip(np.searchsorted(okey_s, lk), 0, len(okey_s) - 1)
        keep = okey_s[pos] == lk
        snat = s_nation[ls[keep] - 1]
        match = snat == onat_s[pos[keep]]
        rev = (price[keep][match] * (100 - disc[keep][match])
               ).astype(np.float64)
        acc += np.bincount(snat[match], weights=rev, minlength=25)
    n_pool = nat.schema.field("n_name").dictionary
    name_of = {int(k): n_pool[int(c)]
               for k, c in zip(col(nat, "n_nationkey"),
                               col(nat, "n_name"))}
    return [(name_of[i], acc[i] / 1e4)
            for i in np.argsort(-acc) if acc[i] > 0]


# ---------------------------------------------------------------------------
# q5-shaped generation (q5's columns only, dbgen's formulas)
# ---------------------------------------------------------------------------

def q5_tables(scale: float, seed: int = 19920101):
    """The q5 columns only, same shapes and distributions as the tpch
    generator. Persisted through the on-disk table cache
    (``connectors/diskcache.py``), so generation is paid once per cache
    root, not once per run."""
    from .connectors.diskcache import load_table, save_table
    from .connectors.tpch.datagen import TableData
    dataset = f"bench_q5_sf{scale:g}_s{seed}"
    names = ["region", "nation", "supplier", "customer", "orders",
             "lineitem"]
    cached = {}
    for nm in names:
        t = load_table(dataset, nm, TableData)
        if t is None:
            break
        cached[nm] = t
    else:
        return cached
    tables = _q5_tables_generate(scale, seed)
    for t in tables.values():
        save_table(dataset, t)
    return tables


def _q5_tables_generate(scale: float, seed: int = 19920101):
    """The reference generator's rng calls in its order, so both
    packages give the same arrays for one seed."""
    from .batch import Field, Schema
    from .connectors.tpch.datagen import (ENDDATE, NATIONS, REGIONS,
                                          STARTDATE, TableData, _codes_for,
                                          retail_price_cents)
    from .types import BIGINT, DATE, VARCHAR, decimal
    rng = np.random.default_rng(seed)
    t = {}
    t["region"] = TableData(
        "region", Schema.of(Field("r_regionkey", BIGINT),
                            Field("r_name", VARCHAR,
                                  dictionary=tuple(sorted(REGIONS)))),
        [np.arange(5, dtype=np.int64),
         _codes_for(REGIONS, sorted(REGIONS))],
        primary_key=("r_regionkey",))
    n_names = [n for n, _ in NATIONS]
    t["nation"] = TableData(
        "nation", Schema.of(Field("n_nationkey", BIGINT),
                            Field("n_name", VARCHAR,
                                  dictionary=tuple(sorted(n_names))),
                            Field("n_regionkey", BIGINT)),
        [np.arange(25, dtype=np.int64),
         _codes_for(n_names, sorted(n_names)),
         np.array([r for _, r in NATIONS], dtype=np.int64)],
        primary_key=("n_nationkey",))
    n_supp = int(scale * 10_000)
    t["supplier"] = TableData(
        "supplier", Schema.of(Field("s_suppkey", BIGINT),
                              Field("s_nationkey", BIGINT)),
        [np.arange(1, n_supp + 1, dtype=np.int64),
         rng.integers(0, 25, n_supp).astype(np.int64)],
        primary_key=("s_suppkey",))
    n_cust = int(scale * 150_000)
    t["customer"] = TableData(
        "customer", Schema.of(Field("c_custkey", BIGINT),
                              Field("c_nationkey", BIGINT)),
        [np.arange(1, n_cust + 1, dtype=np.int64),
         rng.integers(0, 25, n_cust).astype(np.int64)],
        primary_key=("c_custkey",))
    n_ord = int(scale * 1_500_000)
    idx = np.arange(n_ord, dtype=np.int64)
    orderkey = (idx // 8) * 32 + (idx % 8) + 1
    m_active = max(1, n_cust - n_cust // 3)
    j = rng.integers(1, m_active + 1, n_ord).astype(np.int64)
    o_custkey = np.clip(j + (j - 1) // 2, 1, n_cust)
    o_orderdate = rng.integers(STARTDATE, ENDDATE - 151 + 1,
                               n_ord).astype(np.int32)
    t["orders"] = TableData(
        "orders", Schema.of(Field("o_orderkey", BIGINT),
                            Field("o_custkey", BIGINT),
                            Field("o_orderdate", DATE)),
        [orderkey, o_custkey, o_orderdate],
        primary_key=("o_orderkey",))
    lines_per_order = rng.integers(1, 8, n_ord)
    l_orderkey = np.repeat(orderkey, lines_per_order)
    n_li = len(l_orderkey)
    l_partkey = rng.integers(1, int(scale * 200_000) + 1,
                             n_li).astype(np.int64)
    li_i = rng.integers(0, 4, n_li).astype(np.int64)
    l_suppkey = ((l_partkey + li_i * (n_supp // 4 + (l_partkey - 1)
                                      // n_supp)) % n_supp) + 1
    l_quantity = rng.integers(1, 51, n_li).astype(np.int64)
    l_extendedprice = l_quantity * retail_price_cents(l_partkey)
    del l_partkey, li_i, l_quantity
    l_discount = rng.integers(0, 11, n_li).astype(np.int64)
    d122 = decimal(12, 2)
    t["lineitem"] = TableData(
        "lineitem", Schema.of(Field("l_orderkey", BIGINT),
                              Field("l_suppkey", BIGINT),
                              Field("l_extendedprice", d122),
                              Field("l_discount", d122)),
        [l_orderkey, l_suppkey, l_extendedprice, l_discount])
    return t


class BenchConnector:
    """Prebuilt q5-shaped tables under one schema."""
    name = "bench"

    def __init__(self, tables, schema):
        self._tables = tables
        self._schema = schema
        self._cache = {schema: tables}         # stats-probe shape

    def scale_for_schema(self, schema):
        return schema

    def schema_names(self):
        return [self._schema]

    def table_names(self, schema):
        return sorted(self._tables)

    def get_table(self, schema, table):
        return self._tables[table]


# ---------------------------------------------------------------------------
# timing and the oracle cache
# ---------------------------------------------------------------------------

def run_config(session, sql, runs=RUNS, prewarm=PREWARM, on_cold=None):
    """End-to-end timings: cold (the first run: kernel builds and the
    upload), then the steady-state median. Returns (result, cold_ms,
    steady_ms, the steady walls in ms); `on_cold` is called with the
    cold run's result before the steady runs."""
    t0 = time.monotonic()
    result = session.execute(sql)
    cold_ms = (time.monotonic() - t0) * 1000
    if on_cold is not None:
        on_cold(result)
    for _ in range(max(0, prewarm - 1)):
        session.execute(sql)
    times = []
    for _ in range(runs):
        t0 = time.monotonic()
        result = session.execute(sql)
        times.append((time.monotonic() - t0) * 1000)
    return result, cold_ms, statistics.median(times), times


def cached_baseline(key: str, fn):
    """The oracles are deterministic per dataset, so their (result, wall)
    pair is measured once per cache root and kept beside the table
    cache. Returns (result, cpu_ms, whether it came from the cache)."""
    import pickle
    from .connectors.diskcache import cache_root
    os.makedirs(cache_root(), exist_ok=True)
    path = os.path.join(cache_root(), f"baseline_torch_{key}.pkl")
    if os.path.exists(path):
        with open(path, "rb") as f:
            rec = pickle.load(f)
        return rec["result"], rec["cpu_ms"], True
    t0 = time.monotonic()
    result = fn()
    cpu_ms = (time.monotonic() - t0) * 1000
    with open(path, "wb") as f:
        pickle.dump({"result": result, "cpu_ms": cpu_ms}, f)
    return result, cpu_ms, False


def op_stats(session, reg_before=None):
    """The executor's counters (nonzero only) and, given a registry
    snapshot from before the runs, each operator's dispatch wall-ms,
    the page bytes and the rows scanned since."""
    from .metrics import REGISTRY
    st = {k: v for k, v in
          dataclasses.asdict(session.executor.stats).items() if v}
    out = {"exec": st}
    if reg_before is not None:
        after = REGISTRY.snapshot()
        wall = {}
        for key, v in after.items():
            if key[0] == "trino_tpu_operator_wall_ms_total":
                d = v - reg_before.get(key, 0)
                if d > 0:
                    wall[key[1]] = round(d, 1)
        out["operator_wall_ms"] = wall
        key = ("trino_tpu_task_output_bytes_total",)
        out["bytes_shuffled"] = int(after.get(key, 0) -
                                    reg_before.get(key, 0))
        key = ("trino_tpu_operator_rows_total", "scan")
        out["rows_scanned"] = int(after.get(key, 0) -
                                  reg_before.get(key, 0))
    return out


def reg_snapshot():
    from .metrics import REGISTRY
    return REGISTRY.snapshot()


# ---------------------------------------------------------------------------
# the card's and the host's facts
# ---------------------------------------------------------------------------

def kernel_counters() -> dict:
    """The wrapper of each kernel, by the kernel table's name; each
    carries a `launches` count."""
    from .ops import direct_agg as k5
    from .ops import gather as k1
    from .ops import hashtable as ht
    return {"K1": k1.gather_columns, "K2": k1.gather_word_windowed,
            "K3": ht.hash_insert_multi, "K4": ht.multiway_probe,
            "K5": k5.direct_group_aggregate_mxu}


def _launches() -> dict:
    return {name: fn.launches for name, fn in kernel_counters().items()}


def card_facts(device) -> dict:
    """The card's name and power limit as nvidia-smi gives them, and the
    host's memory and CPU count. On the CPU the card's keys are None."""
    out = {"card": None, "power_limit": None}
    if device.type == "cuda":
        try:
            line = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30, check=True).stdout.splitlines()[0]
            name, limit = (p.strip() for p in line.rsplit(",", 1))
            out.update(card=name, power_limit=limit)
        except (OSError, subprocess.SubprocessError, ValueError,
                IndexError):
            import torch
            out["card"] = torch.cuda.get_device_name(device)
    out["host_mem_total_kb"] = _mem_total_kb()
    out["host_cpus"] = os.cpu_count()
    return out


def _mem_total_kb():
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


class _CardWatch:
    """Per configuration: the kernels' launches, the peak allocated
    bytes (reset at the start) and the executor's fact cache bytes."""

    def __init__(self, device):
        self.device = device
        self.before = _launches()
        if device.type == "cuda":
            import torch
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)

    def read(self, session) -> dict:
        after = _launches()
        peak = None
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)
            peak = int(torch.cuda.max_memory_allocated(self.device))
        ex = session.executor
        return {
            "launches": {k: after[k] - self.before[k] for k in after},
            "peak_allocated_bytes": peak,
            "fact_cache_device_bytes": int(ex.fact_cache.total_bytes()),
            "scan_cache_bytes": int(sum(ex._scan_cache_bytes.values())),
            "pool_peak_bytes": int(ex.pool.peak),
            "pool_limit_bytes": int(ex.pool.limit),
            "multijoin_degrade_reasons":
                dict(ex.stats.multijoin_degrade_reasons),
            "multijoin_fused_probes": ex.stats.multijoin_fused_probes,
            "strategy": dict(ex.strategy_decisions)}


@contextlib.contextmanager
def data_cache_root(path=None):
    """Point ``connectors/diskcache.cache_root()`` at `path`; with no
    `path`, keep the caller's ``$TRINO_TPU_DATA_CACHE`` when it is set,
    else use a fresh temporary directory and remove it on exit."""
    saved = os.environ.get("TRINO_TPU_DATA_CACHE")
    made = None
    if path is None and saved:
        path = saved
    if path is None:
        made = path = tempfile.mkdtemp(prefix="trino_tpu_e2e_")
    os.environ["TRINO_TPU_DATA_CACHE"] = path
    try:
        yield path
    finally:
        if saved is None:
            os.environ.pop("TRINO_TPU_DATA_CACHE", None)
        else:
            os.environ["TRINO_TPU_DATA_CACHE"] = saved
        if made is not None:
            shutil.rmtree(made, ignore_errors=True)


# ---------------------------------------------------------------------------
# the three configurations
# ---------------------------------------------------------------------------

def _resolve(device):
    from .exec.session import resolve_device
    return resolve_device(None if device in (None, "cuda") else device)


# the tpch configurations' tables
_TPCH_TABLES = {"q6": ("lineitem",), "q3": ("customer", "orders",
                                            "lineitem")}


def _q5_oracle(tables, scale):
    return cached_baseline(f"q5_sf{scale:g}", lambda: numpy_q5(tables))


def _tpch_oracle(name, schema, tables):
    oracle = numpy_q6 if name == "q6" else numpy_q3
    return cached_baseline(f"{name}_{schema}", lambda: oracle(tables))


def _configs(only) -> list:
    return [c.strip() for c in only.split(",") if c.strip()]


def prepare(only="q5,q6,q3", q5_scale=100.0, q6_schema="sf1",
            q3_schema="sf10") -> dict:
    """Generate (or load) the named configurations' tables and their
    oracles' results under the current cache root, as `run_e2e` does,
    so that a later `run_e2e` over the same root (another process too)
    finds them on disk: the set-up outside a timed run. Needs no card.
    Returns the seconds each configuration took."""
    from .connectors.tpch.connector import TpchConnector
    configs = _configs(only)
    out = {}
    if "q5" in configs:
        t0 = time.monotonic()
        _q5_oracle(q5_tables(float(q5_scale)), float(q5_scale))
        out["q5"] = round(time.monotonic() - t0, 1)
    conn = TpchConnector()
    for name, schema in (("q6", q6_schema), ("q3", q3_schema)):
        if name in configs:
            t0 = time.monotonic()
            _tpch_oracle(name, schema, {t: conn.get_table(schema, t)
                                        for t in _TPCH_TABLES[name]})
            out[name] = round(time.monotonic() - t0, 1)
    return out


def _q5_rows(result):
    return [(r[0], round(float(r[1]), 2)) for r in result.rows]


def _q5_config(scale, chunk_rows, runs, dev, log, on_session):
    from .catalog import Catalog
    from .exec.session import Session
    t0 = time.monotonic()
    tables = q5_tables(scale)
    gen_s = time.monotonic() - t0
    log(f"q5: scale {scale:g} ready in {gen_s:.1f} s "
        f"({tables['lineitem'].num_rows} lineitem rows)")
    cat = Catalog()
    cat.register("bench", BenchConnector(tables, "q5"))
    session = Session(catalog=cat, default_cat="bench",
                      default_schema="q5", device=dev)
    session.properties["spill_chunk_rows"] = chunk_rows
    session.executor.spill_chunk_rows = chunk_rows
    want_raw, cpu_ms, cached = _q5_oracle(tables, scale)
    reg0 = reg_snapshot()
    watch = _CardWatch(dev)
    st = session.executor.stats
    cold_state = {}

    def on_cold(result):
        cold_state["rows"] = _q5_rows(result)
        cold_state["chunks"] = st.fact_cache_chunks

    res, cold, steady, walls = run_config(session, Q5, runs=runs,
                                          prewarm=1, on_cold=on_cold)
    got = _q5_rows(res)
    want = [(n, round(v, 2)) for n, v in want_raw]
    chunks0, cold_got = cold_state["chunks"], cold_state["rows"]
    rec = {
        "cold_ms": round(cold, 1), "steady_ms": round(steady, 1),
        "steady_runs_ms": [round(w, 1) for w in walls],
        "cpu_ms": round(cpu_ms, 1), "oracle_cached": cached,
        "speedup": round(cpu_ms / steady, 2),
        "gen_s": round(gen_s, 1), "scale": scale,
        "rows_lineitem": tables["lineitem"].num_rows,
        "chunk_rows": chunk_rows,
        "chunked": True, "verified": got == want and cold_got == want,
        "fact_cache_chunks": st.fact_cache_chunks,
        "steady_fact_cache_chunks": st.fact_cache_chunks - chunks0,
        "chunk_lut_joins": st.chunk_lut_joins,
        **watch.read(session),
        "operator_stats": op_stats(session, reg0)}
    if not rec["verified"]:
        rec["rows"], rec["want"] = got, want
    if on_session is not None:
        on_session(f"q5_sf{scale:g}", session, rec)
    return rec


def _tpch_config(name, schema, runs, dev, log, on_session):
    from .exec.session import Session
    t0 = time.monotonic()
    session = Session(default_schema=schema, device=dev)
    tables = {t: session.catalog.get_table("tpch", schema, t)
              for t in _TPCH_TABLES[name]}
    gen_s = time.monotonic() - t0
    log(f"{name}: tpch.{schema} ready in {gen_s:.1f} s "
        f"({tables['lineitem'].num_rows} lineitem rows)")
    want_raw, cpu_ms, cached = _tpch_oracle(name, schema, tables)
    reg0 = reg_snapshot()
    watch = _CardWatch(dev)
    sql = Q6 if name == "q6" else Q3
    res, cold, steady, walls = run_config(session, sql, runs=runs)
    if name == "q6":
        got = float(res.rows[0][0])
        verified = abs(got - want_raw / 1e4) < 1e-2
        shown = (got, want_raw / 1e4)
    else:
        got = [(int(r[0]), round(float(r[1]), 2)) for r in res.rows]
        want = [(k, round(v, 2)) for k, v in want_raw]
        verified = got == want
        shown = (got, want)
    rec = {
        "cold_ms": round(cold, 1), "steady_ms": round(steady, 1),
        "steady_runs_ms": [round(w, 1) for w in walls],
        "cpu_ms": round(cpu_ms, 1), "oracle_cached": cached,
        "gen_s": round(gen_s, 1),
        "speedup": round(cpu_ms / steady, 2), "verified": verified,
        "rows_lineitem": tables["lineitem"].num_rows,
        **watch.read(session),
        "operator_stats": op_stats(session, reg0)}
    if not verified:
        rec["rows"], rec["want"] = shown
    if on_session is not None:
        on_session(f"{name}_{schema}", session, rec)
    return rec


def _release(dev) -> None:
    """Free the last configuration's tables and device memory before the
    next one generates its own (the reference `del`s them)."""
    import gc
    gc.collect()
    if dev.type == "cuda":
        import torch
        torch.cuda.empty_cache()


def run_e2e(only="q5,q6,q3", q5_scale=100.0, chunk_rows=33_554_432,
            q6_schema="sf1", q3_schema="sf10", runs=None, device="cuda",
            out_path=None, data_cache=None, log=None,
            on_session=None) -> dict:
    """Run the configurations named in `only` (q5 first, as the
    reference orders them) and return the record
    ``{"metric", "value", "unit", "vs_baseline", "detail"}`` whose
    ``detail`` holds one entry per configuration (``q5_sf100``,
    ``q6_sf1``, ``q3_sf10``, named by their schemas). `runs` is the
    number of steady runs: None keeps the reference's (q5 one, q6 and
    q3 three). The data goes under `data_cache` (see
    ``data_cache_root``); with `out_path` the record is also written
    there. `on_session(key, session, record)` is called after each
    configuration's runs, with its Session still warm (a caller's extra
    measurements), and `log` takes each progress line."""
    log = log or (lambda msg: print(f"[e2e] {msg}", file=sys.stderr,
                                    flush=True))
    dev = _resolve(device)
    configs = _configs(only)
    facts = card_facts(dev)
    detail = {"device": str(dev), "prewarm": PREWARM,
              "runs": RUNS if runs is None else runs, **facts}
    t_start = time.monotonic()
    with data_cache_root(data_cache) as root:
        detail["data_cache"] = root
        if "q5" in configs:
            detail[f"q5_sf{q5_scale:g}"] = _q5_config(
                float(q5_scale), int(chunk_rows),
                1 if runs is None else runs, dev, log, on_session)
            _release(dev)
        if "q6" in configs:
            detail[f"q6_{q6_schema}"] = _tpch_config(
                "q6", q6_schema, RUNS if runs is None else runs, dev, log,
                on_session)
            _release(dev)
        if "q3" in configs:
            detail[f"q3_{q3_schema}"] = _tpch_config(
                "q3", q3_schema, RUNS if runs is None else runs, dev, log,
                on_session)
            _release(dev)
    ran = [k for k in detail if k.startswith(("q5_", "q6_", "q3_"))]
    headline = next((detail[k] for k in sorted(
        ran, key=lambda k: ("q3_", "q5_", "q6_").index(k[:3]))), None)
    detail["verified"] = bool(ran) and all(detail[k]["verified"]
                                           for k in ran)
    detail["elapsed_s"] = round(time.monotonic() - t_start, 1)
    rec = {"metric": "tpch_e2e_sql_to_result_wall_ms",
           "value": headline["steady_ms"] if headline else None,
           "unit": "ms",
           "vs_baseline": headline["speedup"] if headline else None,
           "detail": detail}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m trino_tpu_torch.e2e",
        description="run the end-to-end TPC-H configurations, print one "
                    "JSON record (exit 0 when every one was verified)")
    p.add_argument("--only", default="q5,q6,q3",
                   help="configurations to run, of q5,q6,q3")
    p.add_argument("--q5-scale", type=float, default=100.0,
                   help="scale factor of the q5-shaped tables (100)")
    p.add_argument("--chunk-rows", type=int, default=33_554_432,
                   help="q5's spill_chunk_rows (33,554,432)")
    p.add_argument("--q6-schema", default="sf1")
    p.add_argument("--q3-schema", default="sf10")
    p.add_argument("--runs", type=int, default=None,
                   help="steady runs (q5 1, q6 and q3 3)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--out", default=None,
                   help="also write the record to this JSON file")
    p.add_argument("--data-cache", default=None,
                   help="generated data's root (default: "
                        "$TRINO_TPU_DATA_CACHE, else a temporary "
                        "directory removed at the end)")
    return p


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    rec = run_e2e(only=a.only, q5_scale=a.q5_scale,
                  chunk_rows=a.chunk_rows, q6_schema=a.q6_schema,
                  q3_schema=a.q3_schema, runs=a.runs, device=a.device,
                  out_path=a.out, data_cache=a.data_cache)
    print(json.dumps(rec), flush=True)
    return 0 if rec["detail"]["verified"] else 1


if __name__ == "__main__":
    sys.exit(main())
