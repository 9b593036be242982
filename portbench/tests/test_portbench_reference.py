"""Each plain reference against the program's CPU Session at a small
size: the program's rows, as the statement protocol sends them, are a
right answer by the benchmark's own comparison."""

import importlib
from decimal import ROUND_HALF_UP, Decimal

import pytest

from portbench import compare, port
from portbench.gen import tpch
from portbench.reference.common import EXACT
from portbench.traffic import Traffic, load_json

from .conftest import TINY_ROWS

TPCH = ["q03", "q05", "q10", "q12", "q19"]


def _session(config, gen):
    from trino_tpu_torch.server.coordinator import _rows_json
    cfg = {**load_json("configs", config + ".json"),
           "rows": TINY_ROWS[config]}
    tables = gen.generate(cfg, 2**31 + 3, "cpu")
    host = {n: {c: v.numpy() for c, v in t.columns.items()}
            for n, t in tables.items()}
    session, server = port.start(cfg, tables, host, "cpu")
    server.stop()
    return tables, session, _rows_json


@pytest.fixture(scope="module")
def tpch_session():
    return _session("tpch-sf10", tpch)


def _queries(cell, template, n=4):
    wl = {**load_json("workloads", cell + ".json"), "templates": [template]}
    t = Traffic(wl, 2**31 + 17)
    return t, [t.query("0", i) for i in range(n)]


def _agrees(session_tables, cell, bench, template):
    tables, session, rows_json = session_tables
    t, queries = _queries(cell, template)
    ref = importlib.import_module(f"portbench.reference.{bench}.{template}")
    for q in queries:
        got = rows_json(session.execute(q.sql).rows)
        want = ref.answer(tables, q.params, EXACT)
        assert compare.differs(t.templates[template][1], got, want) is None


@pytest.mark.parametrize("template", TPCH)
def test_tpch_reference_agrees_with_the_program(tpch_session, template):
    _agrees(tpch_session, "tpch-sf10.joins", "tpch", template)


def test_q14_agrees_in_value_but_the_program_sends_a_double(tpch_session):
    """q14 stays out of the mix: the program types promo_revenue double,
    where TPC-H and Trino give decimal(38,6); rounded to that scale its
    value is the reference's."""
    tables, session, rows_json = tpch_session
    t, queries = _queries("tpch-sf10.joins", "q14")
    ref = importlib.import_module("portbench.reference.tpch.q14")
    for q in queries:
        got = rows_json(session.execute(q.sql).rows)
        (want,), = ref.answer(tables, q.params, EXACT)
        assert isinstance(got[0][0], float)
        assert compare.differs(t.templates["q14"][1], got,
                               [(want,)]) is not None
        assert Decimal(got[0][0]).quantize(
            Decimal("0.000001"), ROUND_HALF_UP) == want
