"""The Prometheus families the executor tier feeds, in the port against
the reference: the same SQL through the JAX Session and the port's CPU
Session over the same generated tables, each package's registry read
before and after.

Families: trino_tpu_agg_strategy_decisions_total{strategy},
trino_tpu_join_strategy_decisions_total{strategy},
trino_tpu_multijoin_fused_probes_total,
trino_tpu_multijoin_degrades_total{reason},
trino_tpu_scan_zones_pruned_total,
trino_tpu_device_cache_hits_total / _misses_total,
trino_tpu_scan_prefetch_buffers_in_use (gauge),
trino_tpu_scan_prefetch_stall_seconds, and the profiled
trino_tpu_operator_rows_total{operator},
trino_tpu_operator_device_ms_total{operator},
trino_tpu_operator_compile_ms_total{operator}.

Where both packages record the same `strategy_decisions`, every family's
label set and delta are equal (counts exactly). TPU_MODELLED lists the
statements where the port takes the TPU's decision on the CPU and the
reference does not, so the deltas differ by design; the test holds that
they really differ there. Time families are held to their label sets and
signs; the port's only compile is a kernel library build (none on the
CPU), so OPERATOR_COMPILE_MS is checked with a faked build. The
reference's observability lints (tests/test_metrics_lint.py) run on the
port's servers and registry: every route has a pre-initialised request
counter and a table-driven handler, and every required family renders a
sample on a cold registry."""

import time

import numpy as np
import pytest
import torch

import trino_tpu.metrics as JM
import trino_tpu_torch.metrics as TM
from test_torch_profiling import BUILD_S, GROUP_SQL, _fake_builds
from test_tpch_queries import TPCH_TABLES
from tpch_full import QUERIES as H
from trino_tpu.batch import Field as JField
from trino_tpu.batch import Schema as JSchema
from trino_tpu.batch import batch_from_numpy as jax_batch_from_numpy
from trino_tpu.catalog import Catalog as JaxCatalog
from trino_tpu.connectors.tpch.connector import TpchConnector
from trino_tpu.connectors.tpch.datagen import TableData as JTableData
from trino_tpu.exec.chunked import _PrefetchPipeline as JaxPipeline
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu import types as jtypes
from trino_tpu_torch import types as ttypes
from trino_tpu_torch.batch import Field, Schema, batch_from_numpy
from trino_tpu_torch.catalog import catalog_from_tables
from trino_tpu_torch.connectors.tpch.datagen import TableData
from trino_tpu_torch.exec import executor as executor_mod
from trino_tpu_torch.exec.chunked import _PrefetchPipeline
from trino_tpu_torch.exec.session import Session
from trino_tpu_torch.ops import cuda_build

torch.set_num_threads(1)

FAMILIES = ("AGG_STRATEGY_DECISIONS", "JOIN_STRATEGY_DECISIONS",
            "MULTIJOIN_FUSED_PROBES", "MULTIJOIN_DEGRADES",
            "SCAN_ZONES_PRUNED", "DEVICE_CACHE_HITS", "DEVICE_CACHE_MISSES",
            "SCAN_PREFETCH_STALL_SECONDS", "OPERATOR_ROWS",
            "OPERATOR_DEVICE_MS", "OPERATOR_COMPILE_MS")
COUNTS = ("AGG_STRATEGY_DECISIONS", "JOIN_STRATEGY_DECISIONS",
          "MULTIJOIN_FUSED_PROBES", "MULTIJOIN_DEGRADES",
          "SCAN_ZONES_PRUNED", "DEVICE_CACHE_HITS", "DEVICE_CACHE_MISSES",
          "OPERATOR_ROWS")

STAR = (("enable_multiway_join", "true"),)
CHUNKED = (("spill_chunk_rows", "8192"),)
# name -> (SQL, session properties on both sides, runs)
CASES = {
    "q1": (H[1], (), 1),
    "q3": (H[3], (), 1),
    "q6": (H[6], (), 1),
    "q12": (H[12], (), 1),
    # the fused star on both sides (the reference's K4 interpreted)
    "q5_star": (H[5], STAR, 1),
    # every dimension over the table budget: both degrade to the ladder
    "q5_vmem": (H[5], STAR + (("multiway_vmem_kb", "1"),), 1),
    # chunked: the fact cache misses, then hits
    "q1_chunked": (H[1], CHUNKED, 2),
    "q3_chunked": (H[3], CHUNKED, 2),
    # profiled: the operator families
    "q3_profiled": (H[3], (("enable_profiling", "true"),), 1),
}
# statements where the port models the TPU's decision on the CPU: under
# `auto` the port's planner fuses q5's star (K4 on, as on a TPU), the
# reference's CPU planner keeps the pairwise joins (ROADMAP Queue C)
TPU_MODELLED = {"q5_auto": (H[5], (), 1)}


@pytest.fixture(scope="module")
def tables():
    conn = TpchConnector()
    return {t: conn.get_table("tiny", t) for t in TPCH_TABLES}


def _sessions(tables, props):
    conn = TpchConnector()
    conn._cache[0.01] = dict(tables)
    cat = JaxCatalog()
    cat.register("tpch", conn)
    js = JaxSession(cat, default_schema="tiny")
    ts = Session(catalog_from_tables(tables), default_schema="tiny",
                 device="cpu")
    for name, value in props:
        js.execute(f"SET SESSION {name} = '{value}'")
        ts.execute(f"SET SESSION {name} = '{value}'")
    return js, ts


def _snap(mod):
    return {f: dict(getattr(mod, f)._values) for f in FAMILIES}


def _delta(before, after):
    out = {}
    for f in FAMILIES:
        d = {k: v - before[f].get(k, 0.0) for k, v in after[f].items()
             if v != before[f].get(k, 0.0)}
        if d:
            out[f] = d
    return out


def _run(session, mod, sql):
    before = _snap(mod)
    rows = session.execute(sql).rows
    return rows, _delta(before, _snap(mod)), \
        dict(session.executor.strategy_decisions)


def _both(tables, case):
    sql, props, runs = case
    js, ts = _sessions(tables, props)
    out = []
    for _ in range(runs):
        out.append((_run(js, JM, sql), _run(ts, TM, sql)))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_families_move_as_the_reference(tables, name):
    for (jrows, jd, jdec), (trows, td, tdec) in _both(tables, CASES[name]):
        assert trows == jrows
        assert tdec == jdec
        for f in COUNTS:
            assert td.get(f, {}) == jd.get(f, {}), f
        # time families: the same labels move, by non-negative amounts
        if ("enable_profiling", "true") in CASES[name][1]:
            assert set(td["OPERATOR_DEVICE_MS"]) == \
                set(jd["OPERATOR_DEVICE_MS"])
            assert all(v >= 0 for v in td["OPERATOR_DEVICE_MS"].values())
            # no kernel library is built on the CPU
            assert "OPERATOR_COMPILE_MS" not in td
        else:
            assert "OPERATOR_DEVICE_MS" not in td
            assert "OPERATOR_DEVICE_MS" not in jd
    if name == "q5_star":
        # one fused pass: one probe, one multiway decision
        assert td["MULTIJOIN_FUSED_PROBES"] == {(): 1.0}
        assert td["JOIN_STRATEGY_DECISIONS"][("multiway",)] == 1.0


@pytest.mark.parametrize("name", sorted(TPU_MODELLED))
def test_tpu_modelled_statements_differ_as_listed(tables, name):
    ((jrows, jd, jdec), (trows, td, tdec)), = _both(tables,
                                                    TPU_MODELLED[name])
    assert trows == jrows
    assert tdec != jdec
    assert tdec["MultiJoinNode"].startswith("multiway[")
    assert "MultiJoinNode" not in jdec
    assert td["MULTIJOIN_FUSED_PROBES"] == {(): 1.0}
    assert "MULTIJOIN_FUSED_PROBES" not in jd


def test_operator_compile_ms_on_a_kernel_build(monkeypatch):
    _fake_builds(monkeypatch)
    real = executor_mod.Executor.run_aggregate

    def run_aggregate(self, node):
        cuda_build.library("direct_agg")
        return real(self, node)

    monkeypatch.setattr(executor_mod.Executor, "run_aggregate",
                        run_aggregate)
    s = Session(default_schema="tiny", device="cpu")
    s.execute("SET SESSION enable_profiling = true")
    before = _snap(TM)
    s.execute(GROUP_SQL)
    d = _delta(before, _snap(TM))["OPERATOR_COMPILE_MS"]
    # the aggregate and its ancestors (inclusive times)
    assert d[("AggregateNode",)] == pytest.approx(BUILD_S * 1000, abs=1e-6)
    assert set(d) == {("AggregateNode",), ("ProjectNode",), ("SortNode",)}


# ---------------------------------------------------------------------------
# zone maps: the reference's edge table and a chunked skip
# ---------------------------------------------------------------------------

N = 8192
EDGE_ZONE_ROWS = 1024


def _edge(session, field, schema, table_data, t):
    k = np.arange(N, dtype=np.int64)
    d = (np.arange(N, dtype=np.int64) - N // 2) * 5
    dt = (10957 + (np.arange(N, dtype=np.int32) // 32)).astype(np.int32)
    pool = tuple(f"s{i:04d}" for i in range(64))
    codes = (np.arange(N) * 64 // N).astype(np.int32)
    valids = [np.ones(N, dtype=np.bool_) for _ in range(4)]
    valids[0][:EDGE_ZONE_ROWS] = False                  # NULL-only zone
    data = table_data("edge", schema((
        field("k", t.BIGINT), field("d", t.decimal(12, 2)),
        field("dt", t.DATE), field("v", t.VARCHAR, dictionary=pool))),
        [k, d, dt, codes], valids=valids)
    session.catalog.connector("memory").create_table("default", "edge", data)
    session.execute(f"SET SESSION zone_map_rows = {EDGE_ZONE_ROWS}")
    session.execute("SET SESSION routing_mode = device")
    session.execute("SET SESSION enable_zone_map_pruning = true")
    return session


@pytest.mark.parametrize("pred", ["k > 8000", "k < 1500",
                                  "v BETWEEN 's0010' AND 's0020'"])
def test_zones_pruned_on_the_edge_table(pred):
    js = _edge(JaxSession(), JField, JSchema, JTableData, jtypes)
    ts = _edge(Session(device="cpu"), Field, Schema, TableData, ttypes)
    sql = (f"SELECT count(*) AS c, min(k) AS mn, max(k) AS mx "
           f"FROM memory.default.edge WHERE {pred}")
    (jrows, jd, _), (trows, td, _) = _run(js, JM, sql), _run(ts, TM, sql)
    assert trows == jrows
    assert td["SCAN_ZONES_PRUNED"] == jd["SCAN_ZONES_PRUNED"]
    assert td["SCAN_ZONES_PRUNED"][()] == ts.executor.stats.scan_zones_pruned


def test_chunks_skipped_count_as_zones_pruned(tables):
    props = CHUNKED + (("zone_map_rows", "8192"),
                      ("enable_zone_map_pruning", "true"))
    sql = ("SELECT count(*) AS c, sum(l_quantity) AS q FROM lineitem "
           "WHERE l_orderkey < 25000")
    ((jrows, jd, _), (trows, td, _)), = _both(tables, (sql, props, 1))
    assert trows == jrows
    assert td["SCAN_ZONES_PRUNED"] == jd["SCAN_ZONES_PRUNED"]
    assert td["SCAN_ZONES_PRUNED"][()] > 0


# ---------------------------------------------------------------------------
# the prefetch pipeline: the staged-buffer gauge and the stall counter
# ---------------------------------------------------------------------------

def _pipeline_session(cls):
    s = cls(default_schema="tiny", device="cpu") if cls is Session \
        else cls(default_schema="tiny")
    s.executor.enable_fact_cache = False
    return s


def test_prefetch_gauge_follows_staging_and_revocation():
    starts = [0, 8, 16]
    readings = {}
    for label, cls, pipe_cls, mod, make in (
            ("jax", JaxSession, JaxPipeline, JM,
             lambda a: jax_batch_from_numpy([a])),
            ("port", Session, _PrefetchPipeline, TM,
             lambda a: batch_from_numpy([a], device="cpu"))):
        ex = _pipeline_session(cls).executor
        pipe = pipe_cls(ex, starts,
                        lambda st: make(np.arange(st, st + 8,
                                                  dtype=np.int64)),
                        depth=len(starts))
        seen = []
        try:
            deadline = time.time() + 5
            while len(pipe._staged) < len(starts) and \
                    time.time() < deadline:
                time.sleep(0.01)
            seen.append(mod.SCAN_PREFETCH_BUFFERS.value())
            assert ex.pool.request_revocation(1 << 40) > 0
            assert not pipe._staged
            seen.append(mod.SCAN_PREFETCH_BUFFERS.value())
            for st in starts:
                got = np.asarray(pipe.next(st).columns[0].data)[:8]
                np.testing.assert_array_equal(
                    got, np.arange(st, st + 8, dtype=np.int64))
        finally:
            pipe.close()
        seen.append(mod.SCAN_PREFETCH_BUFFERS.value())
        assert ex.pool.snapshot()["revocable_holders"].get(
            "scan-prefetch", 0) == 0
        readings[label] = seen
    assert readings["port"] == readings["jax"] == [3, 0, 0]


def test_prefetch_stall_seconds_count_the_waits():
    starts = [0, 8, 16]
    for cls, pipe_cls, mod, make in (
            (JaxSession, JaxPipeline, JM,
             lambda a: jax_batch_from_numpy([a])),
            (Session, _PrefetchPipeline, TM,
             lambda a: batch_from_numpy([a], device="cpu"))):
        ex = _pipeline_session(cls).executor

        def decode(st, make=make):
            time.sleep(0.02)          # the consumer waits on every chunk
            return make(np.arange(st, st + 8, dtype=np.int64))

        stalls0 = ex.stats.scan_prefetch_stalls
        secs0 = mod.SCAN_PREFETCH_STALL_SECONDS.value()
        pipe = pipe_cls(ex, starts, decode, depth=1)
        try:
            for st in starts:
                pipe.next(st)
        finally:
            pipe.close()
        assert ex.stats.scan_prefetch_stalls - stalls0 == len(starts)
        assert mod.SCAN_PREFETCH_STALL_SECONDS.value() - secs0 >= \
            0.015 * len(starts)


def test_chunked_run_through_the_pipeline_on_both(tables):
    """The whole chunked driver with the pipeline on: the same stall
    family is present in both registries, and the gauge ends at 0."""
    props = CHUNKED + (("prefetch_depth", "2"),)
    js, ts = _sessions(tables, props)
    js.executor.enable_fact_cache = False
    ts.executor.enable_fact_cache = False
    (jrows, jd, _), (trows, td, _) = _run(js, JM, H[1]), _run(ts, TM, H[1])
    assert trows == jrows
    assert ts.executor.chunk_spans["prefetched"] == \
        js.executor.chunk_spans["prefetched"] > 0
    assert TM.SCAN_PREFETCH_BUFFERS.value() == 0
    assert "DEVICE_CACHE_HITS" not in td and "DEVICE_CACHE_MISSES" not in td
    rendered = TM.REGISTRY.render()
    assert "trino_tpu_scan_prefetch_stall_seconds" in rendered


# ---------------------------------------------------------------------------
# the reference's observability lints (tests/test_metrics_lint.py) on the
# port's servers and registry
# ---------------------------------------------------------------------------

def _port_servers():
    from trino_tpu_torch.server import coordinator, worker
    return ((coordinator, coordinator._Handler),
            (worker, worker._WorkerHandler))


@pytest.mark.parametrize("server", ["coordinator", "worker"])
def test_every_port_route_has_a_preinitialized_counter(server):
    from trino_tpu_torch.server.routes import route_label
    (module, handler), = [s for s in _port_servers()
                          if s[0].SERVER_NAME == server]
    for method, pattern, fn_name, _auth in module.ROUTES:
        assert TM.HTTP_REQUESTS.has_sample(
            server=module.SERVER_NAME, route=route_label(method, pattern))
        assert callable(getattr(handler, fn_name, None)), fn_name
        assert method in ("GET", "POST", "DELETE", "PUT")


@pytest.mark.parametrize("server", ["coordinator", "worker"])
def test_no_inline_route_dispatch_in_the_port(server):
    import inspect
    (module, handler), = [s for s in _port_servers()
                          if s[0].SERVER_NAME == server]
    for do in ("do_GET", "do_POST", "do_DELETE", "do_PUT"):
        fn = getattr(handler, do, None)
        if fn is None:
            continue
        src = inspect.getsource(fn)
        assert "/v1" not in src and "parts[" not in src, \
            f"{module.__name__}.{do} dispatches a route outside ROUTES"


def test_required_families_render_preinitialized_in_the_port():
    from test_metrics_lint import REQUIRED_FAMILIES
    text = TM.REGISTRY.render()
    lines = [line for line in text.splitlines() if not line.startswith("#")]
    for family in REQUIRED_FAMILIES:
        assert f"# TYPE {family} " in text, family
        assert any(line.startswith(family) and " " in line
                   for line in lines), family
