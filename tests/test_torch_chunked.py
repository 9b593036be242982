"""The chunked driver on the port (trino_tpu_torch/exec/chunked.py) against
the reference's (trino_tpu/exec/chunked.py), on the very same generated
tables: TPC-H at tpch.tiny with `spill_chunk_rows = 8192` (lineitem in 8
chunks) and TPC-DS stars at tpcds.tiny with `spill_chunk_rows = 16384`,
plus the driver's machinery — the adaptive windowed probe (K2's plain
version here, the interpreted TPU kernel in the reference), the plain
rerun on a violated window, the prefetch pipeline, streaming builds and
spilled partial states.

Tolerances: port vs reference rows, adaptation records and driver
counters are equal exactly; vs the sqlite oracle, which sums REALs, rel
1e-9 and abs 0.01 (TPC-H) / 0.02 (TPC-DS) with ORDER BY kept, as
tests/test_torch_session.py and tests/test_torch_tpcds.py. The
reference's on-disk decision cache is off, so its first run is plain
there as here."""

import time

import numpy as np
import pytest
import torch

from oracle import assert_rows_match, load_oracle, oracle_query
from tpcds_queries import ORACLE, QUERIES as DS_QUERIES
from tpch_full import QUERIES as H_QUERIES
from test_tpch_queries import Q1, Q3, Q6, TPCH_TABLES
from trino_tpu.catalog import Catalog as JaxCatalog
from trino_tpu.connectors.tpcds.connector import (TABLE_NAMES,
                                                  TpcdsConnector)
from trino_tpu.connectors.tpch.connector import TpchConnector
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu_torch.batch import batch_from_numpy
from trino_tpu_torch.catalog import catalog_from_tables
from trino_tpu_torch.exec import chunked, spill
from trino_tpu_torch.exec.session import Session
from trino_tpu_torch.ops import gather

# pytest-xdist runs one process per core: one torch thread each keeps
# the CPU tests from oversubscribing the cores
torch.set_num_threads(1)

QUERIES = {"q1": Q1, "q3": Q3, "q6": Q6, "q12": H_QUERIES[12]}
COUNTERS = ("fused_chunk_pipelines", "agg_spill_chunks",
            "fact_cache_chunks", "escaped_window_reruns",
            "scan_chunks_skipped")


@pytest.fixture(scope="module", autouse=True)
def private_caches(tmp_path_factory):
    """Both packages' disk caches (the reference's decision file, both
    fact caches' narrowed columns) in a directory of this module's own."""
    mp = pytest.MonkeyPatch()
    mp.setenv("TRINO_TPU_DATA_CACHE", str(tmp_path_factory.mktemp("dc")))
    mp.setenv("TRINO_TPU_DECISION_CACHE", "0")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def tables():
    conn = TpchConnector()
    return {t: conn.get_table("tiny", t) for t in TPCH_TABLES}


@pytest.fixture(scope="module")
def oracle(tables):
    return load_oracle([tables[t] for t in TPCH_TABLES])


def _sessions(tables, props=(("spill_chunk_rows", "8192"),)):
    conn = TpchConnector()
    conn._cache[0.01] = dict(tables)
    cat = JaxCatalog()
    cat.register("tpch", conn)
    js = JaxSession(cat, default_schema="tiny")
    ts = Session(catalog_from_tables(tables), default_schema="tiny",
                 device="cpu")
    for name, value in (("enable_pallas_gather", "true"),) + tuple(props):
        js.execute(f"SET SESSION {name} = '{value}'")
        ts.execute(f"SET SESSION {name} = '{value}'")
    return js, ts


def _port_only(tables, props=(("spill_chunk_rows", "8192"),)):
    ts = Session(catalog_from_tables(tables), default_schema="tiny",
                 device="cpu")
    for name, value in props:
        ts.execute(f"SET SESSION {name} = '{value}'")
    return ts


def _adapt_records(executor):
    return sorted(v for k, v in executor._decision_cache.items()
                  if k[0] == "fusedadapt")


@pytest.mark.parametrize("name", ["q1", "q3", "q6", "q12"])
def test_chunked_query_three_ways(tables, oracle, monkeypatch, name):
    """Each query twice: the first run is plain and records, the second
    adapts. Rows equal the reference's on both runs and the oracle; the
    driver took the same paths (fused or per-node, fact cache, window
    reruns) and recorded the same measurements."""
    js, ts = _sessions(tables)
    sql = QUERIES[name]
    windowed = []
    real = gather.gather_word_windowed

    def spy(planes, idx, word_dtype):
        windowed.append(idx.shape[0])
        return real(planes, idx, word_dtype)
    monkeypatch.setattr(gather, "gather_word_windowed", spy)
    for run in range(2):
        want = js.execute(sql).rows
        got = ts.execute(sql).rows
        assert got == want, (name, run)
        assert_rows_match(got, oracle_query(oracle, sql), rel_tol=1e-9,
                          abs_tol=0.01, ordered=True)
        for c in COUNTERS:
            assert getattr(ts.executor.stats, c) == \
                getattr(js.executor.stats, c), (name, run, c)
        assert ts.executor.stats.agg_spill_chunks == 8 * (run + 1)
    assert _adapt_records(ts.executor) == _adapt_records(js.executor)
    assert ts.executor.strategy_decisions == js.executor.strategy_decisions
    fused = ts.executor.stats.fused_chunk_pipelines
    if name == "q3":
        # a grouped sort/hash aggregate: the per-node loop, with the
        # dense joins' LUTs pinned through the chunk-mode caches
        assert fused == 0 and ts.executor.stats.chunk_lut_joins > 0
    else:
        assert fused == 2
    if name == "q12":
        # the packed orders join: measured span and live rows, then one
        # K2 call per chunk on the adapted run, none escaping
        assert _adapt_records(ts.executor) == [(8256, 52)]
        assert len(windowed) == 8
        assert ts.executor.stats.escaped_window_reruns == 0
    else:
        assert windowed == []


@pytest.mark.parametrize("qnum", [4, 21, 22])
def test_chunked_semi_anti_queries(tables, oracle, qnum):
    """TPC-H q4 (semi join), q21 (semi and anti joins with a residual)
    and q22 (anti join) with `spill_chunk_rows = 8192`, twice: rows equal
    the reference's chunked run, the port's unchunked run and the oracle,
    and the chunk counters moved as the reference's did (q21 streams
    lineitem in 8 chunks; q4 and q22 keep the resident path in both)."""
    js, ts = _sessions(tables)
    plain = _port_only(tables, props=())
    sql = H_QUERIES[qnum]
    for run in range(2):
        want = js.execute(sql).rows
        got = ts.execute(sql).rows
        assert got == want, (qnum, run)
        assert plain.execute(sql).rows == want
        assert_rows_match(got, oracle_query(oracle, sql), rel_tol=1e-9,
                          abs_tol=0.01, ordered=True)
        for c in COUNTERS:
            assert getattr(ts.executor.stats, c) == \
                getattr(js.executor.stats, c), (qnum, run, c)
    chunks = ts.executor.stats.agg_spill_chunks
    assert chunks == (16 if qnum == 21 else 0)


def test_poisoned_record_reruns_plain(tables):
    """An absurdly small recorded span makes the adapted window escape:
    the in-program flag catches it, the driver reruns the plain program
    with the same rows, and the stale record is replaced. (The window
    slice, as in tests/test_fused_adapt.py: K2 picks a window per
    1024-index tile and does not escape on q12's near-sorted keys.)"""
    ts = _port_only(tables, (("spill_chunk_rows", "8192"),
                             ("enable_pallas_gather", "false")))
    sql = QUERIES["q12"]
    want = ts.execute(sql).rows
    key = next(k for k in ts.executor._decision_cache
               if k[0] == "fusedadapt"
               and ts.executor._decision_cache[k])
    n = len(ts.executor._decision_cache[key])
    ts.executor._decision_cache[key] = tuple([8] * n)
    assert ts.execute(sql).rows == want
    assert ts.executor.stats.escaped_window_reruns == 1
    assert ts.executor._decision_cache.get(key) == (8256, 52)


def test_adapted_compaction_equals_reference(tables):
    """The compaction half of the adaptation (off by default in both
    packages): a q12-shaped join whose 1,530 measured live rows per chunk
    compact the 8,192-row chunk to 2,048 after the orders join, with the
    same rows as the reference; a recorded live count below the truth
    overflows the capacity, which the stats vector reports, and the driver
    reruns plain in both."""
    js, ts = _sessions(tables)
    for ex in (js.executor, ts.executor):
        ex.enable_adapt_compact = True
    sql = ("SELECT l_shipmode, count(*) AS c, sum(o_shippriority) AS s"
           " FROM orders, lineitem WHERE o_orderkey = l_orderkey"
           " AND l_quantity < 10 GROUP BY l_shipmode ORDER BY l_shipmode")
    for run in range(2):
        assert ts.execute(sql).rows == js.execute(sql).rows, run
    assert _adapt_records(ts.executor) == _adapt_records(js.executor) == \
        [(8288, 1530)]
    assert ts.executor.stats.fused_chunk_pipelines == 2
    for ex in (js.executor, ts.executor):
        key = next(k for k in ex._decision_cache if k[0] == "fusedadapt")
        ex._decision_cache[key] = (8288, 1)
    assert ts.execute(sql).rows == js.execute(sql).rows
    for c in ("compaction_overflows", "escaped_window_reruns"):
        assert getattr(ts.executor.stats, c) == \
            getattr(js.executor.stats, c) == 1, c


def test_unchunked_rows_equal_chunked(tables):
    ts = _port_only(tables, ())
    plain = {n: ts.execute(q).rows for n, q in QUERIES.items()}
    ts.execute("SET SESSION spill_chunk_rows = 8192")
    for n, q in QUERIES.items():
        assert ts.execute(q).rows == plain[n], n


# --------------------------------------------------------------------------
# the prefetch pipeline (fact cache off: a device-resident fact table
# decodes nothing per chunk and bypasses the pipeline by design)
# --------------------------------------------------------------------------

PREFETCH_SQL = ("SELECT l_returnflag, count(*) AS c, sum(l_extendedprice) "
                "AS s FROM lineitem GROUP BY l_returnflag "
                "ORDER BY l_returnflag")


@pytest.fixture
def decoding(tables):
    ts = _port_only(tables)
    ts.executor.enable_fact_cache = False     # force per-chunk decode
    return ts


def test_depth0_is_serial_and_pipeline_bit_exact(decoding):
    s = decoding
    s.execute("SET SESSION prefetch_depth = 0")
    serial = s.execute(PREFETCH_SQL).rows
    spans0 = s.executor.chunk_spans
    assert spans0["chunks"] == 8 and spans0["prefetched"] == 0
    s.execute("SET SESSION prefetch_depth = 2")
    piped = s.execute(PREFETCH_SQL).rows
    spans2 = s.executor.chunk_spans
    assert piped == serial
    assert spans2["prefetched"] == spans2["chunks"] == 8
    assert s.executor.stats.scan_prefetched_chunks == 8
    assert s.executor.stats.fact_cache_chunks == 0
    assert s.executor.pool.snapshot()["revocable_holders"].get(
        "scan-prefetch", 0) == 0


def test_prewarm_chunks_bit_exact(decoding):
    """`prewarm_chunks` runs the fused program once more on a zero-row
    chunk on a thread while chunk 0 decodes (as
    tests/test_prewarm.py::test_prewarm_chunks_bit_exact drives the
    reference); its output is discarded, so the rows do not change."""
    s = decoding
    baseline = s.execute(PREFETCH_SQL).rows
    chunks = s.executor.chunk_spans["chunks"]
    assert chunks > 1
    calls = []
    cache = s.executor._fused_cache
    for key, program in list(cache.items()):
        def counted(*args, _program=program):
            calls.append(int(args[0].live.sum()))
            return _program(*args)
        cache[key] = counted
    s.execute("SET SESSION prewarm_chunks = true")
    assert s.execute(PREFETCH_SQL).rows == baseline
    deadline = time.time() + 5          # the warm thread is not joined
    while len(calls) < chunks + 1 and time.time() < deadline:
        time.sleep(0.01)
    assert len(calls) == chunks + 1 and calls.count(0) == 1


class InjectedFailure(RuntimeError):
    pass


class OneShotInjector:
    """Raises once at the named point, then never again."""

    def __init__(self, point):
        self.point = point
        self.fired = []

    def maybe_fail(self, point, detail=""):
        if point == self.point and not self.fired:
            self.fired.append(detail)
            raise InjectedFailure(f"{point} {detail}")


def test_fault_at_prefetch_surfaces_and_retry_is_exact(decoding):
    s = decoding
    want = s.execute(PREFETCH_SQL).rows
    inj = OneShotInjector("SCAN_PREFETCH")
    s.executor.failure_injector = inj
    try:
        with pytest.raises(InjectedFailure):
            s.execute(PREFETCH_SQL)
        got = s.execute(PREFETCH_SQL).rows      # injection spent
    finally:
        s.executor.failure_injector = None
    assert inj.fired == ["chunk@0"]
    assert got == want
    pool = s.executor.pool.snapshot()["revocable_holders"]
    assert pool.get("scan-prefetch", 0) == 0
    assert pool.get("agg-partials", 0) == 0


def test_staged_buffers_revocable_under_pressure(decoding):
    ex = decoding.executor
    starts = [0, 8, 16]

    def decode(start):
        return batch_from_numpy([np.arange(start, start + 8,
                                           dtype=np.int64)], device="cpu")

    pipe = chunked._PrefetchPipeline(ex, starts, decode, depth=len(starts))
    try:
        deadline = time.time() + 5
        while len(pipe._staged) < len(starts) and time.time() < deadline:
            time.sleep(0.01)
        assert len(pipe._staged) == len(starts)
        snap = ex.pool.snapshot()
        assert snap["revocable_holders"].get("scan-prefetch", 0) > 0
        assert ex.pool.request_revocation(1 << 40) > 0
        assert not pipe._staged
        # the consumer re-decodes revoked chunks inline — same data
        for st in starts:
            got = pipe.next(st).columns[0].data.numpy()[:8]
            np.testing.assert_array_equal(
                got, np.arange(st, st + 8, dtype=np.int64))
    finally:
        pipe.close()
    assert ex.pool.snapshot()["revocable_holders"].get(
        "scan-prefetch", 0) == 0


def test_prefetch_composes_with_zone_pruning(decoding):
    """Zone maps skip whole chunks and the pipeline decodes only the
    survivors; rows equal the serial unpruned run."""
    s = decoding
    s.execute("SET SESSION zone_map_rows = 8192")
    sql = ("SELECT count(*) AS c, sum(l_quantity) AS q FROM lineitem "
           "WHERE l_orderkey < 25000")
    s.execute("SET SESSION enable_zone_map_pruning = false")
    s.execute("SET SESSION prefetch_depth = 0")
    base = s.execute(sql).rows
    chunks_all = s.executor.chunk_spans["chunks"]
    s.execute("SET SESSION enable_zone_map_pruning = true")
    s.execute("SET SESSION prefetch_depth = 2")
    got = s.execute(sql).rows
    spans = s.executor.chunk_spans
    assert got == base
    assert spans["chunks"] < chunks_all
    assert spans["prefetched"] == spans["chunks"]
    assert s.executor.stats.scan_chunks_skipped == chunks_all - \
        spans["chunks"]


# --------------------------------------------------------------------------
# streaming builds and spilled partial states
# --------------------------------------------------------------------------

def test_streaming_build_join_matches_reference(tables, oracle):
    """A build side above `stream_build_min_kb` streams chunk-wise through
    the dense LUT with host payload gathers (as
    tests/test_memory_spill.py drives the reference: 500-row build
    chunks; the query's TopN keeps the chunked driver out)."""
    sql = ("SELECT o_orderkey, o_totalprice, c_name, c_acctbal"
           " FROM orders o JOIN customer c ON o.o_custkey = c.c_custkey"
           " WHERE o_orderdate < DATE '1993-01-01'"
           " ORDER BY o_orderkey LIMIT 200")
    js, ts = _sessions(tables, (("stream_build_min_kb", "1"),))
    js.executor.spill_chunk_rows = 500
    ts.executor.spill_chunk_rows = 500
    want = js.execute(sql).rows
    got = ts.execute(sql).rows
    assert got == want and len(got) == 200
    assert ts.executor.stats.streamed_build_joins == 1
    assert ts.executor.stats.agg_spill_chunks == \
        js.executor.stats.agg_spill_chunks == 3
    assert_rows_match(got, oracle_query(oracle, sql), rel_tol=1e-9,
                      abs_tol=0.01, ordered=True)


@pytest.mark.parametrize("name,partitioned", [("q1", False), ("q3", False),
                                              ("q1", True)])
def test_partial_state_revoked_to_host_pages(tables, monkeypatch, name,
                                             partitioned):
    """Every device partial is revoked to host pages as it arrives; the
    merge goes through merge_partial_pages (partition-wise when the pool
    reports no room) and gives the resident merge's rows."""
    ts = _port_only(tables)
    want = ts.execute(QUERIES[name]).rows
    real_add = spill.PartialState.add

    def add_then_spill(self, batch):
        real_add(self, batch)
        self.spill_all()
    monkeypatch.setattr(spill.PartialState, "add", add_then_spill)
    if partitioned:
        monkeypatch.setattr(ts.executor.pool, "available", lambda: 0)
    assert ts.execute(QUERIES[name]).rows == want
    assert ts.executor.stats.spilled_aggregations >= 8
    assert ts.executor.pool.snapshot()["revocable_holders"].get(
        "agg-partials", 0) == 0


# --------------------------------------------------------------------------
# TPC-DS stars, chunked: the dimension tables pin through the chunk-mode
# caches and every chunk re-probes the star
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ds_tables():
    conn = TpcdsConnector()
    return {t: conn.get_table("tiny", t) for t in TABLE_NAMES}


@pytest.mark.parametrize("qid", [3, 96])
def test_chunked_star_equals_reference(ds_tables, qid):
    """The star has no packed (K2) join. The reference's gathers stay at
    their CPU default, jnp.take: its interpreted K1 gives the same words
    (tests/test_pallas_gather.py) at over ten times the time here, and the
    port's K1 is held against it in tests/test_torch_gather.py."""
    conn = TpcdsConnector()
    conn._cache[0.01] = dict(ds_tables)
    cat = JaxCatalog()
    cat.register("tpcds", conn)
    js = JaxSession(cat, default_cat="tpcds", default_schema="tiny")
    ts = Session(catalog_from_tables(ds_tables, "tiny", "tpcds"),
                 default_cat="tpcds", default_schema="tiny", device="cpu")
    ts.execute("SET SESSION enable_pallas_gather = 'true'")
    for name, value in (("enable_pallas_hash", "true"),
                        ("enable_multiway_join", "true"),
                        ("spill_chunk_rows", "16384")):
        js.execute(f"SET SESSION {name} = '{value}'")
        ts.execute(f"SET SESSION {name} = '{value}'")
    sql = DS_QUERIES[qid]
    want = js.execute(sql).rows
    got = ts.execute(sql).rows
    assert got == want
    chunks = -(-ds_tables["store_sales"].num_rows // 16384)
    for ex in (ts.executor, js.executor):
        assert ex.stats.agg_spill_chunks == chunks
        assert ex.stats.multijoin_fused_probes == chunks
    assert ts.executor.stats.multijoin_degrades == \
        js.executor.stats.multijoin_degrades
    assert ts.executor.strategy_decisions["MultiJoinNode"] == \
        js.executor.strategy_decisions["MultiJoinNode"]
    orc = load_oracle(ds_tables.values())
    assert_rows_match(got, oracle_query(orc, ORACLE.get(qid, sql)),
                      rel_tol=1e-9, abs_tol=0.02, ordered=True)
