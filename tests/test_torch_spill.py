"""The port's memory-pressure tier (trino_tpu_torch/exec/spill.py and
Executor.run's spill retry) against the reference's, at `tpch.tiny` and
`tpcds.tiny`.

The spill tests of tests/test_memory_pressure.py run through both
packages: each query runs resident to measure its pool peak, then again
with the pool at a half and a quarter of that peak (the pool is in MiB
through `query_max_memory_mb`, as in the reference's tests). Both
packages take the same strategies at their defaults, reserve the same
bytes and so pick the same partition counts; their spilled rows are
compared with the reference's spilled rows exactly (doubles to the last
bit), and their `spilled_*` counters with the reference's. The
reference's `auto` K3 is off on the CPU and the port's is on (the TPU's
rule), so GROUP BY l_orderkey runs with `enable_pallas_hash = 'false'` on
both sides there, as the parity notes advise; the port's hash path under
pressure has a test of its own. Spill directories are made under each
test's `tmp_path`."""

from collections import Counter

import pytest
import torch

import test_memory_pressure
from spill_queries import (AGG_Q, GROUP_ALL_Q, GROUP_Q, JOIN_Q, SORT_Q,
                           SUMAGG_Q)
from trino_tpu.catalog import Catalog as JaxCatalog
from trino_tpu.connectors.tpcds.connector import (TABLE_NAMES,
                                                  TpcdsConnector)
from trino_tpu.exec.memory import \
    ExceededMemoryLimitError as JaxExceededMemoryLimitError
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu.metrics import MULTIJOIN_DEGRADES as JAX_DEGRADES
from trino_tpu_torch.catalog import catalog_from_tables
from trino_tpu_torch.exec.executor import QueryTerminatedError
from trino_tpu_torch.exec.memory import (ExceededMemoryLimitError,
                                         MemoryKilledError)
from trino_tpu_torch.exec.session import Session
from trino_tpu_torch.exec.spill import HostSpiller, get_spiller
from trino_tpu_torch.metrics import (SPILL_BYTES, SPILL_PARTITIONS,
                                     SPILL_RETRIES)
from trino_tpu_torch.planner.optimizer import prune_plan
from trino_tpu_torch.server.failureinjector import FailureInjector
from trino_tpu_torch.sql.parser import parse

torch.set_num_threads(1)

STAR_Q = ("SELECT d_year, i_brand_id, s_store_sk, count(*) AS c, "
          "sum(ss_quantity) AS q FROM store_sales, date_dim, item, store "
          "WHERE ss_sold_date_sk = d_date_sk AND ss_item_sk = i_item_sk "
          "AND ss_store_sk = s_store_sk "
          "GROUP BY d_year, i_brand_id, s_store_sk")
QUERIES = {"join": JOIN_Q, "agg": AGG_Q, "group": GROUP_Q,
           "group_all": GROUP_ALL_Q, "sort": SORT_Q}
# session properties that give both packages the same strategies
PROPS = {name: ("SET SESSION enable_pallas_hash = 'false'",)
         for name in ("group", "group_all")}


@pytest.fixture(autouse=True)
def spill_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_SPILL_DIR", str(tmp_path))
    return tmp_path


def _pair(name=None):
    pair = (JaxSession(default_schema="tiny"),
            Session(default_schema="tiny", device="cpu"))
    for sql in PROPS.get(name, ()):
        for s in pair:
            s.execute(sql)
    return pair


def _limit(sessions, limit: int) -> None:
    for s in sessions:
        s.executor.pool.set_limit(limit)
        s.properties["query_max_memory_mb"] = max(1, limit >> 20)


def _spilled(stats) -> tuple:
    return (stats.spilled_joins, stats.spilled_aggregations,
            stats.spilled_sorts)


@pytest.fixture(scope="module")
def baseline():
    """Resident rows and pool peaks, each query in fresh sessions."""
    out = {}
    for name, sql in QUERIES.items():
        js, ts = _pair(name)
        out[name] = (js.execute(sql).rows, ts.execute(sql).rows,
                     js.executor.pool.peak, ts.executor.pool.peak)
    return out


def test_shared_query_texts_are_the_reference_tests():
    assert JOIN_Q == test_memory_pressure.JOIN_Q
    assert AGG_Q == test_memory_pressure.AGG_Q


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_resident_rows_and_pool_peaks_equal(baseline, name):
    jrows, trows, jpeak, tpeak = baseline[name]
    assert trows == jrows
    assert tpeak == jpeak


@pytest.mark.parametrize("frac", [2, 4])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_spilled_rows_and_counters_equal_reference(baseline, name, frac):
    """A query whose working set exceeds its pool spills in both
    packages, the same way, to the same rows."""
    jrows, _, peak, _ = baseline[name]
    js, ts = _pair(name)
    _limit((js, ts), max(1, peak // frac))
    want = js.execute(QUERIES[name]).rows
    got = ts.execute(QUERIES[name]).rows
    assert got == want == jrows
    assert _spilled(ts.executor.stats) == _spilled(js.executor.stats)
    if frac >= 4:
        assert sum(_spilled(ts.executor.stats)) >= 1


@pytest.mark.parametrize("name", ["group", "group_all"])
def test_spilled_hash_aggregate_runs_the_table_kernel(baseline, name):
    """GROUP BY l_orderkey at a quarter of its peak (its 20 largest
    groups, and every group): every partition's aggregate runs through
    the port's hash strategy (K3's plain version here, K3 on the card)
    and the spill counters reach the registry."""
    jrows = baseline[name][0]
    ts = Session(default_schema="tiny", device="cpu")
    assert ts.execute(QUERIES[name]).rows == jrows
    peak = ts.executor.pool.peak
    ts = Session(default_schema="tiny", device="cpu")
    _limit((ts,), max(1, peak // 4))
    b0, p0 = SPILL_BYTES.value(), SPILL_PARTITIONS.value()
    assert ts.execute(QUERIES[name]).rows == jrows
    st = ts.executor.stats
    assert st.spilled_aggregations == 1
    assert st.hash_agg_calls >= ts.executor.spill_partitions
    assert ts.executor.strategy_decisions["AggregateNode"] == "hash"
    spiller = ts.executor.spiller
    assert SPILL_BYTES.value() - b0 == spiller.bytes_spilled > 0
    assert SPILL_PARTITIONS.value() - p0 >= ts.executor.spill_partitions


def test_chunk_and_merge_aggregate_equals_reference(baseline):
    """AGG_Q has four groups: partitioning cannot shrink it, so both
    packages aggregate fixed row chunks and merge their partial states
    (compared with the reference's own chunk-and-merge)."""
    _, _, peak, _ = baseline["agg"]
    js, ts = _pair()
    _limit((js, ts), max(1, peak // 4))
    for s in (js, ts):
        s.execute("SET SESSION mxu_agg = 'true'")
    for sql in (AGG_Q, SUMAGG_Q):
        assert ts.execute(sql).rows == js.execute(sql).rows
    assert _spilled(ts.executor.stats) == _spilled(js.executor.stats) \
        == (0, 2, 0)
    # the sums and counts alone take K5 (its plain version here)
    assert ts.executor.strategy_decisions["AggregateNode"] == "mxu"


def test_spill_disabled_fails_cleanly():
    js, ts = _pair()
    for s in (js, ts):
        s.execute("SET SESSION spill_enabled = false")
        s.execute("SET SESSION query_max_memory_mb = 1")
    with pytest.raises(JaxExceededMemoryLimitError):
        js.execute(JOIN_Q)
    with pytest.raises(ExceededMemoryLimitError):
        ts.execute(JOIN_Q)
    assert sum(_spilled(ts.executor.stats)) == 0
    # raising the limit restores service on the same session
    ts.execute("SET SESSION query_max_memory_mb = 4096")
    assert ts.execute("SELECT count(*) FROM nation").rows[0][0] == 25


def test_killed_query_is_never_spilled(monkeypatch):
    """The low-memory killer's verdict is final: a MemoryKilledError out
    of a reservation is re-raised, not retried through the spill tier;
    request_kill and request_cancel stop the next plan node."""
    ts = Session(default_schema="tiny", device="cpu")
    pool = ts.executor.pool
    real = pool.reserve

    def reserve(nbytes, *a, **kw):
        if nbytes > (1 << 20):
            raise MemoryKilledError("killed by the low-memory killer")
        return real(nbytes, *a, **kw)
    monkeypatch.setattr(pool, "reserve", reserve)
    with pytest.raises(MemoryKilledError):
        ts.execute(JOIN_Q)
    assert sum(_spilled(ts.executor.stats)) == 0
    monkeypatch.setattr(pool, "reserve", real)
    root = prune_plan(ts.planner().plan_query(parse(JOIN_Q)).node)
    ts.executor.request_kill("low-memory killer")
    with pytest.raises(MemoryKilledError):
        ts.executor.run(root.child)
    ts.executor._kill_reason = None
    ts.executor.request_cancel("user")
    with pytest.raises(QueryTerminatedError):
        ts.executor.run(root.child)
    # execute() clears both for the next query
    assert ts.execute("SELECT count(*) FROM nation").rows[0][0] == 25


def test_chunked_partial_state_spills_under_pressure():
    """The chunked driver's partial-aggregation state is revocable:
    under a 2 MiB pool the partials move to host and the merge
    re-aggregates partition-wise, in both packages, to the same rows."""
    js, ts = _pair("group")
    want = js.execute(GROUP_Q).rows
    js2, ts2 = _pair("group")
    for s in (js2, ts2):
        s.execute("SET SESSION spill_chunk_rows = 8192")
        s.execute("SET SESSION query_max_memory_mb = 2")
    assert js2.execute(GROUP_Q).rows == want
    assert ts2.execute(GROUP_Q).rows == want
    assert ts2.executor.stats.spilled_aggregations == \
        js2.executor.stats.spilled_aggregations


def test_spill_chaos_spool_write_fault_no_wrong_answer(baseline, spill_dir):
    """SPOOL_WRITE faults (a clean raise and a corrupted page) during a
    forced-disk spill degrade to the RAM copy: exact rows, and the
    recoveries are counted, never silent."""
    jrows, _, peak, _ = baseline["join"]
    ts = Session(default_schema="tiny", device="cpu")
    ts.executor.spill_force_disk = True
    _limit((ts,), max(1, peak // 4))
    spiller = get_spiller(ts.executor)
    assert spiller.root == str(spill_dir)
    inj = FailureInjector()
    inj.inject("SPOOL_WRITE", times=2, fault="RAISE")
    inj.inject("SPOOL_WRITE", times=2, fault="CORRUPT")
    spiller.injector = inj
    r0 = SPILL_RETRIES.value()
    assert ts.execute(JOIN_Q).rows == jrows
    assert inj.injected_count >= 1
    assert spiller.write_recoveries >= 1
    assert spiller.disk_writes >= 1
    assert SPILL_RETRIES.value() - r0 == spiller.write_recoveries


def test_host_spiller_ram_and_disk_tiers(tmp_path):
    import numpy as np
    sp = HostSpiller(root=str(tmp_path), disk_min_bytes=1 << 10)
    small = [np.arange(10, dtype=np.int64)], [np.ones(10, np.bool_)]
    big = [np.arange(4096, dtype=np.int64)], [np.ones(4096, np.bool_)]
    sp.put("a", *small)
    sp.put("b", *big)
    assert sp.disk_writes == 1 and list(tmp_path.iterdir())
    for key, (arrs, vals) in (("a", small), ("b", big)):
        ga, gv = sp.get(key)
        assert np.array_equal(ga[0], arrs[0])
        assert np.array_equal(gv[0], vals[0])
    assert not [p for p in tmp_path.iterdir() if p.suffix == ".spool"]


def test_tpcds_star_spills_through_its_ladder():
    """A fused TPC-DS star whose MultiJoinNode output exceeds the pool
    spills as the top hop of its pairwise ladder in both packages (the
    `spill` degrade), to the same rows."""
    conn = TpcdsConnector()
    tables = {t: conn.get_table("tiny", t) for t in TABLE_NAMES}
    jcat = JaxCatalog()
    jcat.register("tpcds", conn)

    def pair():
        js = JaxSession(jcat, default_cat="tpcds", default_schema="tiny")
        ts = Session(catalog_from_tables(tables, "tiny", "tpcds"),
                     default_cat="tpcds", default_schema="tiny",
                     device="cpu")
        for s in (js, ts):
            s.execute("SET SESSION enable_multiway_join = 'true'")
        return js, ts

    js, ts = pair()
    want = Counter(js.execute(STAR_Q).rows)
    assert Counter(ts.execute(STAR_Q).rows) == want
    assert ts.executor.strategy_decisions["MultiJoinNode"] == \
        js.executor.strategy_decisions["MultiJoinNode"]
    peak = js.executor.pool.peak
    js, ts = pair()
    _limit((js, ts), max(1, peak // 4))
    before = JAX_DEGRADES.value(reason="spill")
    jrows = js.execute(STAR_Q).rows
    trows = ts.execute(STAR_Q).rows
    assert Counter(trows) == Counter(jrows) == want
    assert ts.executor.stats.spilled_joins == \
        js.executor.stats.spilled_joins >= 1
    assert ts.executor.stats.multijoin_degrade_reasons.get("spill", 0) == \
        JAX_DEGRADES.value(reason="spill") - before >= 1
