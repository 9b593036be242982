"""The file connectors on the port (trino_tpu_torch/formats, connectors/
csvfile.py, parquetdir.py, orcdir.py, dirtable.py and the staged write
protocol in server/writeprotocol.py) against the reference's copies.

- The port's Parquet and ORC writers produce the reference's bytes for
  the same table and options, and each package decodes the other's
  files to equal tables (columns, validity, VARCHAR pools, types).
- The CSV loader infers the reference's schema and rows.
- SQL over each connector (CTAS through the staged write, INSERT, DROP,
  queries) equals the JAX Session's rows and stored tables.
- A pruned decode (Parquet row groups, ORC stripes skipped by
  statistics) returns the rows of the full decode that the predicate can
  match, skips the reference's groups, and feeds the executor's scan
  (`pruned_decodes`, with no fallback) to the full scan's rows.

pyarrow, where installed, reads the port's files as an independent
reader; those cases skip where it is absent, as the reference's do.
Tolerances: none (byte and row equality)."""

import os

import numpy as np
import pytest
import torch

from trino_tpu.catalog import Catalog as JaxCatalog
from trino_tpu.connectors import csvfile as j_csv
from trino_tpu.connectors import orcdir as j_orc
from trino_tpu.connectors import parquetdir as j_pq
from trino_tpu.connectors.tpch.connector import TpchConnector
from trino_tpu.formats import orc as j_orcfmt
from trino_tpu.formats import parquet as j_pqfmt
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu_torch.catalog import catalog_from_tables, port_table
from trino_tpu_torch.connectors import csvfile as t_csv
from trino_tpu_torch.connectors import orcdir as t_orc
from trino_tpu_torch.connectors import parquetdir as t_pq
from trino_tpu_torch.exec.session import Session
from trino_tpu_torch.formats import orc as t_orcfmt
from trino_tpu_torch.formats import parquet as t_pqfmt
from trino_tpu_torch.planner.optimizer import prune_plan
from trino_tpu_torch.server import writeprotocol as t_wp
from trino_tpu_torch.sql.parser import parse

# pytest-xdist runs one process per core: one torch thread each keeps
# the CPU tests from oversubscribing the cores
torch.set_num_threads(1)

TABLES = ("orders", "customer", "nation")


@pytest.fixture(scope="module")
def tables():
    conn = TpchConnector()
    return {t: conn.get_table("tiny", t) for t in TABLES}


def _mixed_table(pkg):
    """Every exportable type, NULLs in each nullable column, a VARCHAR
    pool with a string no row uses; built with `pkg`'s own classes."""
    if pkg == "jax":
        from trino_tpu.batch import Field, Schema
        from trino_tpu.connectors.tpch.datagen import TableData
        from trino_tpu import types as T
    else:
        from trino_tpu_torch.batch import Field, Schema
        from trino_tpu_torch.connectors.tpch.datagen import TableData
        from trino_tpu_torch import types as T
    rng = np.random.default_rng(7)
    n = 5000
    fields = (Field("k", T.BIGINT), Field("i", T.INTEGER),
              Field("d", T.DOUBLE), Field("m", T.decimal(12, 2)),
              Field("day", T.DATE),
              Field("s", T.VARCHAR, dictionary=("a", "bb", "ccc", "zz")),
              Field("b", T.BOOLEAN))
    cols = [np.arange(n, dtype=np.int64) * 3 - 7000,
            rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
            rng.standard_normal(n) * 1e6,
            rng.integers(-10**11, 10**11, n),
            rng.integers(0, 20000, n).astype(np.int32),
            rng.integers(0, 3, n).astype(np.int32),
            rng.random(n) < 0.5]
    valids = [None] + [rng.random(n) > 0.1 for _ in range(6)]
    return TableData("mixed", Schema(fields), cols, valids=valids)


def assert_data_equal(got, want):
    assert [(f.name, repr(f.dtype), f.dictionary)
            for f in got.schema.fields] == \
        [(f.name, repr(f.dtype), f.dictionary) for f in want.schema.fields]
    for a, b in zip(got.columns, want.columns):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    gv = got.valids or [None] * len(got.columns)
    wv = want.valids or [None] * len(want.columns)
    for a, b in zip(gv, wv):
        a = np.ones(got.num_rows, np.bool_) if a is None else np.asarray(a)
        b = np.ones(want.num_rows, np.bool_) if b is None else np.asarray(b)
        assert a.tobytes() == b.tobytes()


def _writer(fmt, **options):
    """A writer of `fmt` for either package: the connector's exporter at
    its defaults, else the format module's writer with `options` (row
    groups, stripes, codecs) on the exporter's flattening."""
    def write(pkg, data, path):
        pq, orc = (t_pq, t_orc) if pkg == "torch" else (j_pq, j_orc)
        if not options:
            (pq if fmt == "parquet" else orc).export_table(data, path)
        elif fmt == "parquet":
            fmod = t_pqfmt if pkg == "torch" else j_pqfmt
            fmod.write_parquet(path, *pq.flatten_table(data, "parquet"),
                               **options)
        else:
            fmod = t_orcfmt if pkg == "torch" else j_orcfmt
            fmod.write_orc(path, *pq.flatten_table(data, "ORC"), **options)
    return write, fmt


WRITES = {
    "parquet": _writer("parquet"),
    "parquet row groups": _writer("parquet", row_group_rows=1000),
    "parquet gzip": _writer("parquet", compression="gzip"),
    "orc": _writer("orc"),
    "orc zlib stripes": _writer("orc", compression="zlib",
                                stripe_rows=1000),
}


@pytest.mark.parametrize("what", list(WRITES))
def test_writers_byte_equal_and_cross_read(tmp_path, monkeypatch, what):
    # a gzip member records its write time: both writers see one clock
    monkeypatch.setattr("time.time", lambda: 1_700_000_000.0)
    write, fmt = WRITES[what]
    jpath, tpath = str(tmp_path / f"j.{fmt}"), str(tmp_path / f"t.{fmt}")
    write("jax", _mixed_table("jax"), jpath)
    write("torch", _mixed_table("torch"), tpath)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    tload = t_pq.load_parquet if fmt == "parquet" else t_orc.load_orc
    jload = j_pq.load_parquet if fmt == "parquet" else j_orc.load_orc
    # each package reads the other's file to the same table
    assert_data_equal(tload(jpath, "t"), jload(tpath, "t"))
    assert_data_equal(tload(tpath, "t"), port_table(jload(jpath, "t")))


def test_pyarrow_reads_port_files(tmp_path):
    pq = pytest.importorskip("pyarrow.parquet")
    po = pytest.importorskip("pyarrow.orc")
    data = _mixed_table("torch")
    _writer("parquet", row_group_rows=999)[0](
        "torch", data, str(tmp_path / "t.parquet"))
    _writer("orc", compression="zlib")[0](
        "torch", data, str(tmp_path / "t.orc"))
    for tab in (pq.read_table(str(tmp_path / "t.parquet")),
                po.read_table(str(tmp_path / "t.orc"))):
        assert tab.num_rows == data.num_rows
        assert tab.column("k").to_pylist() == data.columns[0].tolist()
        s = tab.column("s").to_pylist()
        pool = data.schema.fields[5].dictionary
        assert s == [pool[c] if v else None for c, v in
                     zip(data.columns[5], data.valids[5])]


def test_csv_inference_equal(tmp_path):
    d = tmp_path / "default"
    d.mkdir()
    (d / "people.csv").write_text(
        "name,age,height,joined,note\n"
        "alice,34,1.7,2020-01-15,x\n"
        "bob,28,1.82,2021-06-01,\n"
        "carol,,1.65,2019-11-30,1e3\n"
        "dave,41,,2022-03-10,2021-13-01\n")
    path = str(d / "people.csv")
    got, want = t_csv.load_csv(path, "people"), j_csv.load_csv(path, "people")
    assert [f.dtype.kind.value for f in got.schema.fields] == \
        ["varchar", "bigint", "double", "date", "varchar"]
    assert_data_equal(got, port_table(want))


def _sessions(tables, root):
    """JAX and port sessions over the same tpch.tiny tables, with Parquet,
    ORC and CSV catalogs (the writers at their defaults), each package
    under its own root."""
    conn = TpchConnector()
    conn._cache[0.01] = dict(tables)
    jcat = JaxCatalog()
    jcat.register("tpch", conn)
    tcat = catalog_from_tables(tables)
    for name, cat, pq, orc, csv in (
            ("jax", jcat, j_pq.ParquetConnector, j_orc.OrcConnector,
             j_csv.CsvConnector),
            ("torch", tcat, t_pq.ParquetConnector, t_orc.OrcConnector,
             t_csv.CsvConnector)):
        base = os.path.join(root, name)
        cat.register("pq", pq(os.path.join(base, "pq")))
        cat.register("orc", orc(os.path.join(base, "orc")))
        csv_dir = os.path.join(base, "csv", "default")
        os.makedirs(csv_dir)
        with open(os.path.join(csv_dir, "nums.csv"), "w") as f:
            f.write("k,v,day,tag\n" + "".join(
                f"{i},{i * 0.25},2020-01-{1 + i % 28:02d},t{i % 7}\n"
                for i in range(300)))
        cat.register("csv", csv(os.path.join(base, "csv")))
    js = JaxSession(jcat, default_schema="tiny")
    ts = Session(tcat, default_schema="tiny", device="cpu")
    return js, ts


STEPS = [
    "CREATE TABLE pq.s.orders AS SELECT * FROM tpch.tiny.orders",
    "CREATE TABLE orc.s.orders AS SELECT * FROM tpch.tiny.orders",
    "CREATE TABLE pq.s.nation AS SELECT * FROM tpch.tiny.nation",
    "INSERT INTO pq.s.nation SELECT * FROM tpch.tiny.nation "
    "WHERE n_regionkey = 1",
    "INSERT INTO pq.s.orders SELECT * FROM tpch.tiny.orders "
    "WHERE o_orderkey < 100",
    "SELECT o_orderstatus, count(*), sum(o_totalprice) FROM pq.s.orders "
    "GROUP BY o_orderstatus ORDER BY 1",
    "SELECT o_orderstatus, count(*), sum(o_totalprice) FROM orc.s.orders "
    "GROUP BY o_orderstatus ORDER BY 1",
    "SELECT n_name, count(*) FROM pq.s.nation GROUP BY n_name ORDER BY 1",
    "SELECT c_name, o_totalprice FROM orc.s.orders JOIN tpch.tiny.customer"
    " ON o_custkey = c_custkey WHERE o_orderkey < 200 ORDER BY 2 DESC, 1",
    "SELECT tag, count(*), sum(v), min(day) FROM csv.default.nums "
    "GROUP BY tag ORDER BY tag",
    "CREATE TABLE orc.s.small AS SELECT tag, k FROM csv.default.nums "
    "WHERE k < 20",
    "SELECT * FROM orc.s.small ORDER BY k",
    "DROP TABLE orc.s.small",
    "SHOW TABLES FROM orc.s",
    "DROP TABLE IF EXISTS orc.s.small",
]


def test_sql_over_file_connectors_equals_reference(tables, tmp_path):
    js, ts = _sessions(tables, str(tmp_path))
    for sql in STEPS:
        assert ts.execute(sql).rows == js.execute(sql).rows, sql
    # ORC decodes every integer as BIGINT, so an INTEGER column does not
    # insert: the reference's error, and no part is published
    sql = "INSERT INTO orc.s.orders SELECT * FROM tpch.tiny.orders"
    with pytest.raises(ValueError) as jerr:
        js.execute(sql)
    with pytest.raises(ValueError) as terr:
        ts.execute(sql)
    assert str(terr.value) == str(jerr.value)
    for cat in ("pq", "orc"):
        jconn, tconn = js.catalog.connector(cat), ts.catalog.connector(cat)
        assert tconn.table_names("s") == jconn.table_names("s")
        for name in tconn.table_names("s"):
            tconn._cache.clear()
            jconn._cache.clear()
            assert_data_equal(tconn.get_table("s", name),
                              port_table(jconn.get_table("s", name)))
    # a committed write leaves no staging files, journals or temp names
    for dirpath, dirnames, files in os.walk(str(tmp_path / "torch")):
        assert not any(f.startswith(".") or f.endswith(".journal")
                       for f in files + dirnames), dirpath
    assert t_wp.WRITE_COMMITS.value(outcome="committed") >= 5


def ranged_writes(table, parts=8, step=7500):
    """CTAS of tpch.tiny.orders' first `step` keys into `table`, then an
    INSERT of each later key range: one part file each, with its own
    row-group or stripe statistics. o_shippriority is written as BIGINT,
    the kind ORC reads any integer back as (an INSERT's kinds must match
    the stored table's)."""
    cols = ("o_orderkey, o_custkey, o_orderstatus, o_totalprice, "
            "o_orderdate, o_orderpriority, o_clerk, CAST(o_shippriority "
            "AS BIGINT) AS o_shippriority, o_comment")
    src = f"SELECT {cols} FROM tpch.tiny.orders WHERE o_orderkey"
    return [f"CREATE TABLE {table} AS {src} < {step}"] + [
        f"INSERT INTO {table} {src} >= {lo} AND o_orderkey < {lo + step}"
        for lo in range(step, parts * step, step)]


@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_pruned_decode_equals_reference(tables, tmp_path, fmt):
    """A table written as a CTAS and INSERTs over key ranges (a part
    each): the connector's pruned decode skips the reference's parts'
    groups and returns the surviving groups' rows; through the executor
    (its connector cache cold, as a scan that did not plan the query
    sees it) the pruned scan returns the full scan's rows."""
    js, ts = _sessions(tables, str(tmp_path))
    cat = "pq" if fmt == "parquet" else "orc"
    for sql in ranged_writes(f"{cat}.s.orders"):
        assert ts.execute(sql).rows == js.execute(sql).rows, sql
    ranges = {"o_orderkey": (1, 4000)}
    tconn, jconn = ts.catalog.connector(cat), js.catalog.connector(cat)
    got = tconn.get_table_pruned("s", "orders", ranges)
    want = jconn.get_table_pruned("s", "orders", ranges)
    assert_data_equal(got, port_table(want))
    skipped = "skipped_row_groups" if fmt == "parquet" else \
        "skipped_stripes"
    total = "total_row_groups" if fmt == "parquet" else "total_stripes"
    assert getattr(got, skipped) == getattr(want, skipped) == 7
    assert getattr(got, total) == getattr(want, total) == 8
    sql = (f"SELECT count(*), sum(o_totalprice), max(o_orderdate) FROM "
           f"{cat}.s.orders WHERE o_orderkey < 4000")
    full = ts.execute(sql).rows
    assert full == js.execute(sql).rows
    rel = ts.planner().plan_query(parse(sql))
    root = prune_plan(rel.node)
    tconn._cache.clear()
    cold = Session(ts.catalog, default_schema="tiny", device="cpu")
    batch = cold.executor.execute(root)
    names, arrays, valids = cold.executor.result_to_host(root, batch)
    assert cold.decode_rows(rel, arrays, valids) == full
    stats = cold.executor.stats
    assert (stats.pruned_decodes, stats.pruned_groups_skipped,
            stats.pruned_decode_fallbacks) == (1, 7, 0)
