"""The port's critical-path wall-time attribution and cluster flight
recorder on the CPU (tpch.tiny): the reference's timeline file
(tests/test_timeline.py) carried over to `trino_tpu_torch`.

The two invariants this file defends:
- timeline phases ALWAYS sum exactly to elapsed wall (asserted on live
  distributed queries, on admission-held queries, and on synthetic
  inputs), with the blocking critical path charging the slower of two
  concurrent stages;
- the flight-recorder ring is byte-bounded no matter how long it runs,
  scrapes incrementally via `?since=`, federates worker rings into the
  coordinator's cluster series, and adds zero threads and zero spans
  when telemetry/tracing are off.

The parity cases at the end feed the same seeded spans, task rollups
and flight-recorder samples through both packages' attribution,
critical path, breakdown line and histogram deltas.
"""

import threading
import time
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import pytest

from trino_tpu_torch.client.client import Client
from trino_tpu_torch.events import EventListener
from trino_tpu_torch.exec.session import Session
from trino_tpu_torch.server.coordinator import CoordinatorServer
from trino_tpu_torch.server.security import internal_headers
from trino_tpu_torch.server.telemetry import (FlightRecorder,
                                              histogram_deltas,
                                              percentile_from_buckets)
from trino_tpu_torch.server.timeline import (PHASES, attribute_phases,
                                             breakdown_line, critical_path,
                                             dominant_phase,
                                             stage_intervals)
from trino_tpu_torch.server.worker import WorkerServer
from trino_tpu_torch.utils.tracing import Tracer


# ---------------------------------------------------------------------------
# pure helpers: critical path, attribution, formatting
# ---------------------------------------------------------------------------

def test_critical_path_picks_slower_parallel_stage():
    # source(1s) ; then build-A(1s) || build-B(3s) ; then final(1s):
    # the path charges B (the blocker), never A, never A+B
    ivs = [{"name": "source-stage", "start": 0.0, "end": 1.0},
           {"name": "build-stage[f1]", "start": 1.0, "end": 2.0},
           {"name": "build-stage[f2]", "start": 1.0, "end": 4.0},
           {"name": "final-stage", "start": 4.0, "end": 5.0}]
    total, picks = critical_path(ivs)
    assert total == pytest.approx(5.0)
    assert [p["name"] for p in picks] == \
        ["source-stage", "build-stage[f2]", "final-stage"]
    assert picks[1]["seconds"] == pytest.approx(3.0)


def test_critical_path_transitive_overlap_forms_one_group():
    # A overlaps B, B overlaps C, A does not overlap C — still ONE
    # concurrency group (transitive), charged its longest member
    ivs = [{"name": "a", "start": 0.0, "end": 2.0},
           {"name": "b", "start": 1.0, "end": 5.0},
           {"name": "c", "start": 4.0, "end": 6.0}]
    total, picks = critical_path(ivs)
    assert [p["name"] for p in picks] == ["b"]
    assert total == pytest.approx(4.0)


def test_critical_path_empty():
    assert critical_path([]) == (0.0, [])


def test_attribute_phases_sums_exactly_synthetic():
    ph = attribute_phases(2.0, 0.5, None, None)
    assert ph["queued"] == 0.5
    assert sum(ph.values()) == 2.0
    assert set(ph) == set(PHASES)
    # estimates overrunning the budget scale down, never break the sum
    spans = [{"name": "plan", "durationMs": 5000.0,
              "startTimeUnixNano": 0}]
    ph = attribute_phases(1.0, 0.0, spans, None)
    assert sum(ph.values()) == 1.0
    assert ph["plan"] <= 1.0
    # degenerate walls stay well-formed
    assert sum(attribute_phases(0.0, 0.0, None, None).values()) == 0.0


def test_attribute_phases_write_commit_fallback():
    # untraced writes attribute commit wall from the scheduler's
    # recorded commit_s instead of spans
    ph = attribute_phases(1.0, 0.0, None, None,
                          write_stats={"commit_s": 0.25})
    assert ph["write-commit"] == pytest.approx(0.25)
    assert sum(ph.values()) == 1.0


def test_dominant_phase_prefers_attributed_over_other():
    assert dominant_phase({"queued": 0.4, "other": 0.4, "plan": 0.1}) \
        == "queued"
    assert dominant_phase({"queued": 0.1, "other": 0.5}) == "other"
    assert dominant_phase({}) == ""


def test_breakdown_line_format():
    ph = {p: 0.0 for p in PHASES}
    ph["queued"], ph["device"] = 0.5, 0.25
    line = breakdown_line(ph, 0.75)
    assert line.startswith("critical path: ")
    assert "queued 500.0ms" in line and "device 250.0ms" in line
    assert "plan" not in line            # zero phases elided
    assert "other 0.0ms" in line         # except the residual
    assert line.endswith("= 750.0ms")


# ---------------------------------------------------------------------------
# clock skew: adopt() rebasing + announce-time estimation
# ---------------------------------------------------------------------------

def test_adopt_rebases_remote_spans_by_clock_offset():
    t = Tracer()
    now = time.time()
    remote = {"name": "worker-task",
              "startTimeUnixNano": int((now + 5.0) * 1e9),
              "durationMs": 10.0}
    t.adopt([remote], offset_s=5.0)
    (got,) = t.export()
    assert abs(got["startTimeUnixNano"] / 1e9 - now) < 0.001
    # the caller's dict was copied, not mutated
    assert remote["startTimeUnixNano"] == int((now + 5.0) * 1e9)
    # zero offset adopts verbatim
    t2 = Tracer()
    t2.adopt([remote])
    assert t2.export()[0]["startTimeUnixNano"] == \
        remote["startTimeUnixNano"]


def test_skewed_intervals_normalize_onto_one_clock():
    """A worker 5s in the future must not produce a stage interval that
    starts before the coordinator span that dispatched it."""
    t = Tracer()
    with t.span("source-stage"):
        skewed = {"name": "worker-task",
                  "startTimeUnixNano": int((time.time() + 5.0) * 1e9),
                  "durationMs": 1.0}
        t.adopt([skewed], offset_s=5.0)
    spans = t.export()
    stage = next(s for s in spans if s["name"] == "source-stage")
    task = next(s for s in spans if s["name"] == "worker-task")
    assert task["startTimeUnixNano"] >= stage["startTimeUnixNano"]


# ---------------------------------------------------------------------------
# flight recorder: bounded ring, delta encoding, incremental scrape
# ---------------------------------------------------------------------------

def test_flight_recorder_ring_is_byte_bounded():
    from trino_tpu_torch.metrics import (TELEMETRY_RING_EVICTIONS,
                                         MetricsRegistry)
    reg = MetricsRegistry()
    c = reg.counter("t_events_total", "test counter")
    rec = FlightRecorder("t", interval_s=0, max_bytes=512, registry=reg)
    ev0 = TELEMETRY_RING_EVICTIONS.value()
    for i in range(300):
        c.inc()
        rec.sample_once(now=1000.0 + i)
    assert rec.ring_bytes() <= 512
    assert 1 <= rec.sample_count() < 300
    assert TELEMETRY_RING_EVICTIONS.value() > ev0
    # the oldest samples were the ones evicted
    assert rec.since(0.0)[0]["ts"] > 1000.0


def test_flight_recorder_delta_encoding_and_since():
    from trino_tpu_torch.metrics import MetricsRegistry
    reg = MetricsRegistry()
    c = reg.counter("t_events_total", "test counter")
    g = reg.gauge("t_depth", "test gauge")
    rec = FlightRecorder("t", interval_s=0, registry=reg)
    c.inc(3)
    g.set(7)
    rec.sample_once(now=10.0)
    c.inc(2)                         # gauge unchanged
    s2 = rec.sample_once(now=11.0)
    assert s2["values"] == {"t_events_total": 2.0}   # delta, no gauge
    assert s2["interval_s"] == pytest.approx(1.0)
    g.set(9)                         # counter unchanged
    s3 = rec.sample_once(now=12.0)
    assert s3["values"] == {"t_depth": 9.0}
    # incremental scrape: strictly after the cursor
    assert [s["ts"] for s in rec.since(10.0)] == [11.0, 12.0]
    assert rec.since(12.0) == []


def test_percentile_from_buckets():
    # 50 obs <= 0.1, 50 more in (0.1, 0.5]: the median sits at the
    # first bucket's bound, p99 interpolates inside the second
    buckets = [(0.1, 50.0), (0.5, 100.0), ("+Inf", 100.0)]
    assert percentile_from_buckets(buckets, 0.5) == pytest.approx(0.1)
    p99 = percentile_from_buckets(buckets, 0.99)
    assert 0.1 < p99 <= 0.5
    assert percentile_from_buckets([], 0.5) is None
    assert percentile_from_buckets([(0.1, 0.0)], 0.5) is None
    # everything past the last finite bound reports that bound
    assert percentile_from_buckets([(0.1, 0.0), ("+Inf", 10.0)], 0.99) \
        == pytest.approx(0.1)


def test_histogram_deltas_parses_recorder_samples():
    fam = "trino_tpu_tenant_query_seconds"
    samples = [{"ts": 1.0, "interval_s": 1.0, "values": {
        f"{fam}|alpha_bucket|le=0.1": 5.0,
        f"{fam}|alpha_bucket|le=+Inf": 6.0,
        f"{fam}|alpha_count": 6.0,
        f"{fam}|alpha_sum": 0.9,
        f"{fam}|beta_count": 3.0}}]
    out = histogram_deltas(samples, fam, labelval="alpha")
    assert len(out) == 1
    assert out[0]["count"] == 6.0
    assert ("0.1", 5.0) in out[0]["buckets"]
    p = percentile_from_buckets(out[0]["buckets"], 0.5)
    assert 0.0 < p <= 0.1


# ---------------------------------------------------------------------------
# cluster: end-to-end timelines, telemetry federation, system tables
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cluster():
    session = Session(default_schema="tiny", device="cpu")
    coord = CoordinatorServer(session).start()
    coord.state.scheduler.split_rows = 8192
    workers = [WorkerServer(f"tl-w{i}", coord.uri,
                            announce_interval_s=0.1,
                            catalog=session.catalog, device="cpu").start()
               for i in range(2)]
    deadline = time.time() + 15
    while len(coord.state.active_nodes()) < 2 and \
            time.time() < deadline:
        time.sleep(0.05)
    assert len(coord.state.active_nodes()) >= 2
    yield coord, workers, session
    for w in workers:
        w.stop(graceful=False)
    coord.stop()


DIST_SQL = ("SELECT l_returnflag, count(*) AS c FROM lineitem "
            "GROUP BY l_returnflag ORDER BY l_returnflag")


def test_distributed_timeline_sums_exactly_to_wall(cluster):
    coord, workers, session = cluster
    # cold spool: a durable-exchange hit would skip task dispatch
    coord.state.scheduler.spool.clear()
    client = Client(coord.uri, user="tl")
    client.execute("SET SESSION enable_tracing = true")
    try:
        r = client.execute(DIST_SQL)
        info = client.query_info(r.query_id)
        assert info["distributed"], info["fallbackReason"]
        tq = coord.state.tracker.get(r.query_id)
        tl = tq.timeline
        assert tl is not None
        # THE invariant: phases sum to elapsed wall, exactly
        assert sum(tl["phases"].values()) == tl["wall_s"]
        assert all(v >= 0.0 for v in tl["phases"].values())
        assert set(tl["phases"]) == set(PHASES)
        assert tl["dominant"] in PHASES
        # the stage spans produced a real blocking path made of stages
        assert tl["criticalPathSeconds"] > 0.0
        names = [p["name"] for p in tl["criticalPath"]]
        assert names
        assert all(n.startswith(("source-stage", "build-stage",
                                 "partitioned-exchange", "final-stage",
                                 "distributed-write"))
                   for n in names), names
        assert tl["breakdown"].startswith("critical path: ")
        # ... and the HTTP surface serves the same doc, sum intact
        doc = client._request(
            "GET", f"{coord.uri}/v1/query/{r.query_id}/timeline")
        assert sum(doc["phases"].values()) == doc["wall_s"]
        assert doc["breakdown"] == tl["breakdown"]
    finally:
        client.execute("SET SESSION enable_tracing = false")


def test_timeline_http_404_on_unknown_query(cluster):
    coord, workers, session = cluster
    client = Client(coord.uri, user="tl")
    with pytest.raises(HTTPError):
        client._request("GET", f"{coord.uri}/v1/query/nope_1/timeline")


def test_untraced_timeline_still_sums_and_adds_no_spans(cluster):
    coord, workers, session = cluster
    coord.state.scheduler.spool.clear()
    client = Client(coord.uri, user="tl")
    r = client.execute(DIST_SQL)
    tq = coord.state.tracker.get(r.query_id)
    tl = tq.timeline
    assert tl is not None
    assert sum(tl["phases"].values()) == tl["wall_s"]
    # tracing off: zero spans collected anywhere
    assert (tq.trace or []) == []
    assert session.tracer.export() == []


def test_queued_phase_under_soft_memory_admission_hold():
    from trino_tpu_torch.server.resourcegroups import (ResourceGroupConfig,
                                                       ResourceGroupManager)
    session = Session(default_schema="tiny", device="cpu")
    coord = CoordinatorServer(session).start()
    try:
        disp = coord.state.dispatcher
        # warm the compile caches so the released run is fast enough
        # that the admission hold dominates the wall deterministically
        warm = disp.submit("SELECT count(*) FROM nation", "held")
        deadline = time.time() + 30
        while not warm.state_machine.is_done() and time.time() < deadline:
            time.sleep(0.01)
        rgm = ResourceGroupManager(ResourceGroupConfig(
            "root", hard_concurrency_limit=4,
            soft_memory_limit_bytes=1000))
        disp.resource_groups = rgm
        rgm.set_cluster_memory(5000)       # over the soft limit: hold
        tq = disp.submit("SELECT count(*) FROM nation", "held")
        time.sleep(0.6)
        assert tq.state == "QUEUED"
        for runnable in rgm.set_cluster_memory(100):   # release
            runnable()
        deadline = time.time() + 30
        while not tq.state_machine.is_done() and time.time() < deadline:
            time.sleep(0.01)
        assert tq.state == "FINISHED"
        tl = tq.timeline
        assert tl["phases"]["queued"] >= 0.5
        assert sum(tl["phases"].values()) == tl["wall_s"]
        # the hold dominates this trivial query's wall
        assert tl["dominant"] == "queued"
    finally:
        coord.stop()


def test_announce_now_estimates_clock_offset(cluster):
    coord, workers, session = cluster
    try:
        coord.state.announce("tl-skewed", "http://127.0.0.1:1",
                             state="DRAINING", now=time.time() + 5.0)
        node = coord.state.nodes["tl-skewed"]
        assert 4.5 < node.clock_offset < 5.5
        # refresh updates the estimate
        coord.state.announce("tl-skewed", "http://127.0.0.1:1",
                             state="DRAINING", now=time.time() - 2.0)
        assert -2.5 < coord.state.nodes["tl-skewed"].clock_offset < -1.5
        # a real worker's offset is ~zero (same host clock)
        real = coord.state.nodes[workers[0].node_id]
        assert abs(real.clock_offset) < 1.0
    finally:
        coord.state.announce("tl-skewed", "", state="LEFT")


def test_worker_telemetry_endpoint_incremental_scrape(cluster):
    coord, workers, session = cluster
    w = workers[0]
    w.telemetry.sample_once()
    req = Request(f"{w.uri}/v1/telemetry?since=0",
                  headers=internal_headers())
    import json as _json
    with urlopen(req, timeout=10) as resp:
        doc = _json.loads(resp.read().decode())
    assert doc["nodeId"] == w.node_id
    assert doc["samples"]
    last = doc["samples"][-1]["ts"]
    req = Request(f"{w.uri}/v1/telemetry?since={last}",
                  headers=internal_headers())
    with urlopen(req, timeout=10) as resp:
        doc2 = _json.loads(resp.read().decode())
    assert doc2["samples"] == []          # nothing new since the cursor


def test_cluster_federation_spans_coordinator_and_workers(cluster):
    coord, workers, session = cluster
    for w in workers:
        w.telemetry.sample_once()
    coord.state.telemetry.collect()
    nodes = {r[1] for r in coord.state.telemetry.rows()}
    assert "coordinator" in nodes
    assert any(n.startswith("tl-w") for n in nodes)
    # family-prefix filtering works on the federated rows
    rows = coord.state.telemetry.rows(
        metric="trino_tpu_telemetry_samples_total")
    assert rows and all(
        r[2].startswith("trino_tpu_telemetry_samples_total")
        for r in rows)


def test_system_runtime_metrics_history(cluster):
    coord, workers, session = cluster
    for w in workers:
        w.telemetry.sample_once()
    client = Client(coord.uri, user="tl")
    r = client.execute("SELECT node_id, metric, ts, value "
                       "FROM system.runtime.metrics_history")
    assert r.rows
    nodes = {row[0] for row in r.rows}
    assert "coordinator" in nodes
    assert any(n.startswith("tl-w") for n in nodes), nodes
    assert all(row[2] > 0 for row in r.rows)          # real timestamps


def test_system_runtime_query_timeline(cluster):
    coord, workers, session = cluster
    client = Client(coord.uri, user="tl")
    target = client.execute(DIST_SQL)
    r = client.execute("SELECT query_id, phase, seconds, wall_seconds "
                       "FROM system.runtime.query_timeline")
    mine = [row for row in r.rows if row[0] == target.query_id]
    assert {row[1] for row in mine} == set(PHASES)
    wall = mine[0][3]
    assert abs(sum(row[2] for row in mine) - wall) < 1e-9
    assert all(row[2] >= 0.0 for row in mine)


def test_explain_analyze_prints_critical_path(cluster):
    coord, workers, session = cluster
    coord.state.scheduler.spool.clear()
    client = Client(coord.uri, user="tl")
    r = client.execute("EXPLAIN ANALYZE " + DIST_SQL)
    assert client.query_info(r.query_id)["distributed"]
    text = "\n".join(row[0] for row in r.rows)
    assert "critical path: " in text
    line = next(ln for ln in text.splitlines()
                if ln.startswith("critical path: "))
    assert line.rstrip().endswith("ms")
    assert "other" in line               # the residual always prints


def test_telemetry_off_means_zero_threads(cluster):
    coord, workers, session = cluster
    # no interval configured anywhere in this module: no sampler or
    # federation threads may exist
    assert coord.state.telemetry.recorder.sampling is False
    assert coord.state.telemetry.collecting is False
    assert all(w.telemetry.sampling is False for w in workers)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("telemetry")]


def test_dominant_phase_reaches_history_and_events(cluster):
    coord, workers, session = cluster

    class Sink(EventListener):
        def __init__(self):
            self.completed = []

        def query_completed(self, ev):
            self.completed.append(ev)

    sink = Sink()
    coord.state.dispatcher.event_listeners.register(sink)
    client = Client(coord.uri, user="tl")
    r = client.execute("SELECT count(*) FROM nation")
    # the completion event fires after the client sees the result
    deadline = time.time() + 10
    while not any(e.query_id == r.query_id for e in sink.completed) \
            and time.time() < deadline:
        time.sleep(0.02)
    ev = next(e for e in sink.completed if e.query_id == r.query_id)
    assert ev.dominant_phase in PHASES
    hist = [h for h in coord.state.history.snapshot()
            if h.get("query_id") == r.query_id]
    assert hist and hist[0].get("dominant_phase") == ev.dominant_phase


def test_timeline_metrics_account_every_phase(cluster):
    from trino_tpu_torch.metrics import (CRITICAL_PATH_SECONDS,
                                         TIMELINE_QUERIES)
    coord, workers, session = cluster
    before = TIMELINE_QUERIES.value()
    Client(coord.uri, user="tl").execute("SELECT 1")
    assert TIMELINE_QUERIES.value() > before
    for p in PHASES:
        assert CRITICAL_PATH_SECONDS.has_sample(phase=p), p


# ---------------------------------------------------------------------------
# parity with the reference on the same spans and samples
# ---------------------------------------------------------------------------

def _seeded_query(seed):
    """A query's coordinator and adopted worker spans, its task rollup
    and its wall, drawn from one seed."""
    import random
    rng = random.Random(seed)
    t0 = 1_700_000_000.0
    spans = []

    def span(name, start, dur_ms, **extra):
        spans.append({"name": name,
                      "startTimeUnixNano": int((t0 + start) * 1e9),
                      "durationMs": dur_ms, **extra})

    span("plan", 0.0, rng.uniform(1, 30))
    span("plan-distributed", 0.01, rng.uniform(1, 10))
    for a in range(rng.choice([1, 1, 2, 3])):
        span("query", 0.02 + a, rng.uniform(50, 900))
    at = 0.05
    for name in ("source-stage", "partitioned-exchange"):
        dur = rng.uniform(20, 400)
        span(name, at, dur)
        at += dur / 1000.0 * rng.choice([0.5, 1.0, 1.2])
    for frag in range(rng.choice([0, 1, 2])):
        span("build-stage", at - 0.01, rng.uniform(5, 200),
             attributes={"fragment": f"f{frag}"})
    span("final-stage", at + 0.2, rng.uniform(1, 50))
    if rng.random() < 0.5:
        span("write-commit", at + 0.3, rng.uniform(1, 80))
    for task in range(3):
        for _ in range(rng.choice([0, 1, 3])):
            span("exchange-pull", at, rng.uniform(0.5, 20),
                 parentSpanId=f"t{task}")
    tasks = [{"stage": rng.choice(["source", "partitioned", None]),
              "wall_ms": rng.uniform(10, 500),
              "device_ms": rng.uniform(0, 100),
              "compile_ms": rng.choice([0.0, rng.uniform(0, 50)])}
             for _ in range(rng.choice([0, 2, 5]))]
    wall = rng.uniform(0.05, 2.0)
    queued = rng.choice([0.0, rng.uniform(0, wall)])
    write = {"commit_s": rng.uniform(0, 0.1)} if rng.random() < 0.3 \
        else None
    return wall, queued, spans, {"tasks": tasks}, write


def _timeline_of(mod, seed):
    wall, queued, spans, stats, write = _seeded_query(seed)
    ph = mod.attribute_phases(wall, queued, spans, stats,
                              write_stats=write)
    ivs = mod.stage_intervals(spans)
    return (ph, sum(ph.values()) == wall, ivs, mod.critical_path(ivs),
            mod.dominant_phase(ph), mod.breakdown_line(ph, wall))


@pytest.mark.parametrize("seed", range(6))
def test_timeline_equals_reference(seed):
    import trino_tpu.server.timeline as jax_timeline
    import trino_tpu_torch.server.timeline as port_timeline
    port = _timeline_of(port_timeline, seed)
    assert port[1], "phases must sum exactly to the wall"
    assert port == _timeline_of(jax_timeline, seed)


def test_histogram_deltas_equal_reference():
    import random

    from trino_tpu.server.telemetry import \
        histogram_deltas as jax_histogram_deltas
    from trino_tpu.server.telemetry import \
        percentile_from_buckets as jax_percentile
    rng = random.Random(11)
    samples, cum = [], {}
    for i in range(12):
        for lab in ("alpha", "beta"):
            for le in ("0.1", "1.0", "+Inf"):
                key = f"q_seconds|{lab}_bucket|le={le}"
                cum[key] = cum.get(key, 0.0) + rng.choice([0, 0, 1, 3])
            cum[f"q_seconds|{lab}_count"] = \
                cum[f"q_seconds|{lab}_bucket|le=+Inf"]
            cum[f"q_seconds|{lab}_sum"] = \
                cum.get(f"q_seconds|{lab}_sum", 0.0) + rng.random()
        samples.append({"ts": 100.0 + i, "interval_s": 1.0,
                        "values": dict(cum)})
    for lab in (None, "alpha", "beta"):
        port = histogram_deltas(samples, "q_seconds", lab)
        ref = jax_histogram_deltas(samples, "q_seconds", lab)
        assert port == ref
        for d in port:
            assert percentile_from_buckets(d["buckets"], 0.99) == \
                jax_percentile(d["buckets"], 0.99)
