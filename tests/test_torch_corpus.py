"""The corpus file and its canonical form (tests/torch_corpus.py):
tests/torch_corpus_sf1.json, which tools/corpus_reference.py writes from
the reference's rows at SF1 and chip_smoke.py's `phase_corpus_card`
holds the card against, lists every corpus query with its fields; the
canonical rule is the parity test's; the canonical digest of the JAX
Session equals the port CPU Session's at tiny; the module imports
neither jax nor the reference package.

Tolerance: none (digests of `repr`s are equal or not)."""

import os
import subprocess
import sys

import pytest
import torch

import torch_corpus as tc
from test_torch_parity import _ends_in_order_by
from tpcds_queries import QUERIES as TPCDS
from tpch_full import QUERIES as TPCH

torch.set_num_threads(1)

FIELDS = {"rows", "sha256", "head", "seconds"}


@pytest.fixture(scope="module")
def corpus():
    return tc.load()


def test_file_lists_every_query_with_its_fields(corpus):
    want = {tc.key("tpch", q) for q in TPCH} | \
        {tc.key("tpcds", q) for q in TPCDS}
    assert len(want) == 22 + 99
    assert set(corpus["queries"]) == want
    for k, entry in corpus["queries"].items():
        if "error" in entry:
            # the reference did not answer at sf1: the card is held
            # against the port CPU Session's answer, kept beside the error
            assert set(entry) == {"error", "seconds", "port_cpu"}, k
            entry = entry["port_cpu"]
        assert set(entry) == FIELDS, k
        assert len(entry["sha256"]) == 64
        assert entry["head"] == entry["head"][:tc.HEAD_ROWS]
        assert len(entry["head"]) == min(entry["rows"], tc.HEAD_ROWS)
    assert corpus["schema"] == "sf1"
    assert len(corpus["tables"]["tpch"]) == 8
    assert len(corpus["tables"]["tpcds"]) == 24
    assert os.path.getsize(tc.SF1_FILE) < 1 << 20


def test_order_by_rule_is_the_parity_tests():
    texts = list(TPCH.values()) + list(TPCDS.values())
    assert len(texts) == 121
    assert [tc.ends_in_order_by(t) for t in texts] == \
        [_ends_in_order_by(t) for t in texts]
    # both kinds occur
    assert len({tc.ends_in_order_by(t) for t in texts}) == 2


def test_canonical_rows_keep_order_and_bits():
    rows = [(2, 0.0), (1, -0.0), (1, 0.1 + 0.2)]
    assert tc.canonical_rows("SELECT a FROM t ORDER BY a", rows) == \
        ["(2, 0.0)", "(1, -0.0)", "(1, 0.30000000000000004)"]
    assert tc.canonical_rows("SELECT a FROM t", rows) == \
        ["(1, -0.0)", "(1, 0.30000000000000004)", "(2, 0.0)"]
    # -0.0 and 0.0 are different answers; list rows canonicalise as tuples
    assert tc.summary("SELECT 1", [(0.0,)])["sha256"] != \
        tc.summary("SELECT 1", [(-0.0,)])["sha256"]
    assert tc.summary("SELECT 1", [[1, "a"]]) == \
        tc.summary("SELECT 1", [(1, "a")])
    assert tc.first_difference("SELECT 1", [(1,), (3,)],
                               ["(1,)", "(2,)"]) == (1, "(3,)", "(2,)")
    assert tc.first_difference("SELECT 1", [(1,)], ["(1,)"]) is None


@pytest.mark.parametrize("suite,table", [("tpch", "nation"),
                                         ("tpch", "customer"),
                                         ("tpcds", "item"),
                                         ("tpcds", "customer")])
def test_table_digest_equal_across_packages(suite, table):
    """Both packages' generators give one digest (the card machine
    checks its tables against the reference's digests)."""
    if suite == "tpch":
        from trino_tpu.connectors.tpch.connector import TpchConnector as J
        from trino_tpu_torch.connectors.tpch.connector import \
            TpchConnector as P
    else:
        from trino_tpu.connectors.tpcds.connector import TpcdsConnector as J
        from trino_tpu_torch.connectors.tpcds.connector import \
            TpcdsConnector as P
    jt, pt = J().get_table("tiny", table), P().get_table("tiny", table)
    assert tc.table_digest(jt) == tc.table_digest(pt)
    # a flipped byte changes it
    pt.columns[0] = pt.columns[0].copy()
    pt.columns[0][0] += 1
    assert tc.table_digest(jt) != tc.table_digest(pt)


@pytest.fixture(scope="module")
def tiny_sessions():
    """(suite -> (JAX Session, port CPU Session)) at tiny over the same
    generated tables."""
    from test_torch_parity import TPCH_TABLES
    from trino_tpu.catalog import Catalog as JaxCatalog
    from trino_tpu.connectors.tpcds.connector import (TABLE_NAMES,
                                                      TpcdsConnector)
    from trino_tpu.connectors.tpch.connector import TpchConnector
    from trino_tpu.exec.session import Session as JaxSession
    from trino_tpu_torch.catalog import catalog_from_tables
    from trino_tpu_torch.exec.session import Session
    out = {}
    for suite, conn, names in (("tpch", TpchConnector(), TPCH_TABLES),
                               ("tpcds", TpcdsConnector(), TABLE_NAMES)):
        tables = {t: conn.get_table("tiny", t) for t in names}
        cat = JaxCatalog()
        cat.register(suite, conn)
        out[suite] = (JaxSession(cat, default_cat=suite,
                                 default_schema="tiny"),
                      Session(catalog_from_tables(tables, "tiny", suite),
                              default_cat=suite, default_schema="tiny",
                              device="cpu"))
    return out


@pytest.mark.parametrize("suite,q", [("tpch", 1), ("tpch", 3),
                                     ("tpcds", 3), ("tpcds", 86)])
def test_reference_and_port_digests_equal_at_tiny(tiny_sessions, suite, q):
    sql = tc.suite_queries(suite)[q]
    reference, port = tiny_sessions[suite]
    want = tc.summary(sql, reference.execute(sql).rows)
    got = tc.summary(sql, port.execute(sql).rows)
    assert got == want and want["rows"] > 0


def test_helper_imports_no_jax():
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path.insert(0, %r); import torch_corpus as tc; "
            "tc.summary('SELECT 1', [(1,)]); tc.load(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'trino_tpu')]; assert not bad, bad" % here)
    subprocess.run([sys.executable, "-c", code], check=True)
