"""The end-to-end TPC-H configurations on the port
(trino_tpu_torch/e2e.py) against the reference's harness (bench.py's
default mode), on the CPU at small scale.

- the q5-shaped generator: the port's `_q5_tables_generate` equals
  `bench._q5_tables_generate` for one seed, every column byte for byte
  and every schema by name, type and dictionary;
- the oracles: `numpy_q3`, `numpy_q5`, `numpy_q6` equal the reference's
  on the same tables;
- Q5 over the port's `BenchConnector` at scale 0.05, chunked
  (`spill_chunk_rows = 65536`, lineitem in 5 chunks) and unchunked,
  against the JAX Session over `bench.BenchConnector` and against
  `numpy_q5`; Q3 and Q6 at `tpch.tiny` against both as well;
- `e2e.main` at small scales on the CPU: exit 0, every configuration
  verified, and nothing written outside a temporary cache root.

Tolerances: the generated arrays, the oracles' results and the rows of
the two Sessions are equal exactly (the revenue sums are exact decimals
in both packages); against the numpy oracles, which sum doubles, the
rows are equal to the cent, as the reference's harness holds them."""

import json
import os
import tempfile

import numpy as np
import pytest
import torch

import bench
from trino_tpu.catalog import Catalog as JaxCatalog
from trino_tpu.connectors.tpch.connector import TpchConnector
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu_torch import e2e
from trino_tpu_torch.catalog import Catalog, catalog_from_tables
from trino_tpu_torch.exec.session import Session

# pytest-xdist runs one process per core: one torch thread each keeps
# the CPU tests from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q5_SCALE = 0.05
CHUNK_ROWS = 65_536


@pytest.fixture(scope="module", autouse=True)
def private_caches(tmp_path_factory):
    """Both packages' disk caches in a directory of this module's own."""
    mp = pytest.MonkeyPatch()
    mp.setenv("TRINO_TPU_DATA_CACHE", str(tmp_path_factory.mktemp("dc")))
    mp.setenv("TRINO_TPU_DECISION_CACHE", "0")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def q5_pair():
    return (e2e._q5_tables_generate(Q5_SCALE),
            bench._q5_tables_generate(Q5_SCALE))


@pytest.fixture(scope="module")
def tiny():
    conn = TpchConnector()
    return {t: conn.get_table("tiny", t)
            for t in ("customer", "orders", "lineitem")}


# ---------------------------------------------------------------------------
# the generator and the oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [0.01, 0.05])
def test_q5_tables_equal_reference_generator(scale):
    mine = e2e._q5_tables_generate(scale)
    ref = bench._q5_tables_generate(scale)
    assert list(mine) == list(ref)
    for name, t in mine.items():
        r = ref[name]
        assert t.name == r.name and t.num_rows == r.num_rows
        assert tuple(t.primary_key) == tuple(r.primary_key)
        assert [(f.name, f.dtype.kind.value, f.dtype.precision,
                 f.dtype.scale, f.dictionary) for f in t.schema.fields] == \
            [(f.name, f.dtype.kind.value, f.dtype.precision,
              f.dtype.scale, f.dictionary) for f in r.schema.fields]
        for a, b in zip(t.columns, r.columns):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def test_q5_tables_persist_and_reload(tmp_path, monkeypatch):
    """q5_tables writes through the disk cache once and reads back the
    same arrays (memory-mapped) on the next call."""
    monkeypatch.setenv("TRINO_TPU_DATA_CACHE", str(tmp_path))
    first = e2e.q5_tables(0.01)
    assert os.path.isdir(tmp_path / "bench_q5_sf0.01_s19920101" /
                         "lineitem")
    again = e2e.q5_tables(0.01)
    for name, t in first.items():
        for a, b in zip(t.columns, again[name].columns):
            assert isinstance(b, np.memmap)
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
        assert again[name].schema == t.schema


def test_numpy_q5_equals_reference(q5_pair):
    mine, ref = q5_pair
    assert e2e.numpy_q5(mine) == bench.numpy_q5(ref)
    # and in chunks smaller than the table, as at scale
    assert e2e.numpy_q5(mine, chunk=40_000) == bench.numpy_q5(ref)


@pytest.mark.parametrize("name", ["q3", "q6"])
def test_numpy_q3_q6_equal_reference(tiny, name):
    from trino_tpu_torch.catalog import port_table
    mine = {t: port_table(v) for t, v in tiny.items()}
    assert getattr(e2e, f"numpy_{name}")(mine) == \
        getattr(bench, f"numpy_{name}")(tiny)


# ---------------------------------------------------------------------------
# the three statements through both Sessions
# ---------------------------------------------------------------------------

def _q5_sessions(q5_pair, chunk_rows):
    mine, ref = q5_pair
    jcat = JaxCatalog()
    jcat.register("bench", bench.BenchConnector(ref, "q5"))
    js = JaxSession(jcat, default_cat="bench", default_schema="q5")
    cat = Catalog()
    cat.register("bench", e2e.BenchConnector(mine, "q5"))
    ts = Session(cat, default_cat="bench", default_schema="q5",
                 device="cpu")
    if chunk_rows:
        js.properties["spill_chunk_rows"] = chunk_rows
        js.executor.spill_chunk_rows = chunk_rows
        ts.properties["spill_chunk_rows"] = chunk_rows
        ts.executor.spill_chunk_rows = chunk_rows
    return js, ts


@pytest.mark.parametrize("chunk_rows", [CHUNK_ROWS, 0],
                         ids=["chunked", "unchunked"])
def test_q5_equals_jax_session_and_oracle(q5_pair, chunk_rows):
    js, ts = _q5_sessions(q5_pair, chunk_rows)
    want = js.execute(e2e.Q5).rows
    got = ts.execute(e2e.Q5).rows
    assert got == want
    # a steady run (the fact cache resident) answers the same
    assert ts.execute(e2e.Q5).rows == want
    oracle = [(n, round(v, 2)) for n, v in e2e.numpy_q5(q5_pair[0])]
    assert [(r[0], round(float(r[1]), 2)) for r in got] == oracle
    st = ts.executor.stats
    assert st.multijoin_fused_probes > 0
    if chunk_rows:
        n = q5_pair[0]["lineitem"].num_rows
        # both runs slice every chunk from the narrowed resident columns
        assert st.fact_cache_chunks == 2 * -(-n // chunk_rows)
        assert ts.executor.fact_cache.total_bytes() > 0
    else:
        assert st.fact_cache_chunks == 0


@pytest.mark.parametrize("name", ["q3", "q6"])
def test_q3_q6_equal_jax_session_and_oracle(tiny, name):
    conn = TpchConnector()
    conn._cache[0.01] = dict(tiny)
    jcat = JaxCatalog()
    jcat.register("tpch", conn)
    js = JaxSession(jcat, default_schema="tiny")
    ts = Session(catalog_from_tables(tiny), default_schema="tiny",
                 device="cpu")
    sql = getattr(e2e, name.upper())
    got = ts.execute(sql).rows
    assert got == js.execute(sql).rows
    oracle = getattr(e2e, f"numpy_{name}")(
        {t: ts.catalog.get_table("tpch", "tiny", t) for t in tiny})
    if name == "q6":
        assert abs(float(got[0][0]) - oracle / 1e4) < 1e-2
    else:
        assert [(int(r[0]), round(float(r[1]), 2)) for r in got] == \
            [(k, round(v, 2)) for k, v in oracle]


def test_q5_sql_texts_are_the_reference_s():
    for name in ("Q3", "Q5", "Q6"):
        assert getattr(e2e, name) == getattr(bench, name)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

_SMALL = ["--q5-scale", "0.02", "--chunk-rows", "32768", "--q6-schema",
          "tiny", "--q3-schema", "tiny", "--device", "cpu"]


def _tree_listing():
    out = set()
    for dirpath, dirnames, files in os.walk(REPO):
        dirnames[:] = [d for d in dirnames
                       if d not in (".git", "__pycache__", ".pytest_cache",
                                    ".hypothesis")]
        out.update(os.path.join(dirpath, f) for f in files)
    return out


def test_main_verifies_and_leaves_no_data(tmp_path, monkeypatch, capsys):
    """With no TRINO_TPU_DATA_CACHE, the data goes to a temporary root
    that the run removes: the repository's tree and the temporary
    directory hold no new file afterwards."""
    monkeypatch.delenv("TRINO_TPU_DATA_CACHE", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    before = _tree_listing()
    assert e2e.main(_SMALL) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    d = rec["detail"]
    assert d["verified"] is True
    assert sorted(k for k in d if k[:3] in ("q5_", "q6_", "q3_")) == \
        ["q3_tiny", "q5_sf0.02", "q6_tiny"]
    q5 = d["q5_sf0.02"]
    for key in ("cold_ms", "steady_ms", "cpu_ms", "gen_s", "scale",
                "rows_lineitem", "chunked", "verified",
                "fact_cache_chunks", "chunk_lut_joins", "launches",
                "peak_allocated_bytes", "fact_cache_device_bytes",
                "multijoin_degrade_reasons"):
        assert key in q5, key
    assert q5["chunked"] and q5["steady_fact_cache_chunks"] > 0
    assert q5["fact_cache_device_bytes"] > 0
    assert not any(k.startswith("tpu_") for c in ("q5_sf0.02", "q6_tiny",
                                                  "q3_tiny") for k in d[c])
    assert d["host_cpus"] == os.cpu_count()
    assert rec["value"] == d["q3_tiny"]["steady_ms"]
    assert "TRINO_TPU_DATA_CACHE" not in os.environ
    assert os.listdir(tmp_path) == []
    assert _tree_listing() == before


def test_main_keeps_a_given_cache_root(tmp_path):
    out = tmp_path / "rec.json"
    root = tmp_path / "data"
    assert e2e.main(_SMALL + ["--only", "q5", "--runs", "2",
                              "--data-cache", str(root),
                              "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    q5 = rec["detail"]["q5_sf0.02"]
    assert rec["detail"]["data_cache"] == str(root)
    assert len(q5["steady_runs_ms"]) == 2
    assert os.path.isdir(root / "bench_q5_sf0.02_s19920101")
    assert os.path.isfile(root / "baseline_torch_q5_sf0.02.pkl")


def test_main_fails_an_unverified_configuration(monkeypatch, capsys):
    """A configuration whose rows differ from its oracle is recorded
    with both and the exit is 1."""
    real = e2e.numpy_q6
    monkeypatch.setattr(e2e, "numpy_q6", lambda t: real(t) + 10_000)
    assert e2e.main(_SMALL + ["--only", "q6"]) == 1
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "detail"]
    assert d["verified"] is False and d["q6_tiny"]["verified"] is False
    assert d["q6_tiny"]["rows"] != d["q6_tiny"]["want"]


def test_prepare_then_run_reads_the_prepared_data(tmp_path):
    """`prepare` (no Session, no card) generates the tables and the
    oracles' results under a cache root; a later run over that root
    takes both from disk and is verified."""
    root = str(tmp_path / "data")
    with e2e.data_cache_root(root):
        took = e2e.prepare("q5,q3", q5_scale=0.02, q3_schema="tiny")
    assert sorted(took) == ["q3", "q5"]
    assert os.path.isfile(os.path.join(root, "baseline_torch_q5_sf0.02.pkl"))
    assert os.path.isfile(os.path.join(root, "baseline_torch_q3_tiny.pkl"))
    rec = e2e.run_e2e("q5,q3", q5_scale=0.02, chunk_rows=32_768,
                      q3_schema="tiny", runs=1, device="cpu",
                      data_cache=root, log=lambda msg: None)
    d = rec["detail"]
    assert d["verified"] is True
    assert d["q5_sf0.02"]["oracle_cached"] and d["q3_tiny"]["oracle_cached"]
