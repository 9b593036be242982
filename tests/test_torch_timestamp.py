"""The port's TIMESTAMP type on the CPU (micros since epoch; Trino
timestamp(6) layout): the reference's file (tests/test_timestamp.py)
carried over to `trino_tpu_torch`, then a memory table over
tpch.tiny.lineitem with seeded times of day, rows moved before 1970 and
literal rows at day boundaries on both sides of the epoch, queried
through both packages (EXTRACT of each field, CAST to date, every
date_trunc unit, grouped min/max, comparisons against a DATE): the same
rows, and the same refusals of malformed literals."""

import numpy as np
import pytest
import torch

from torch_time_cases import TS_BAD_LITERALS, TS_QUERIES, ts_setup

from trino_tpu_torch.exec.session import Session

torch.set_num_threads(1)


@pytest.fixture()
def session():
    return Session(default_cat="memory", default_schema="default",
                   device="cpu")


def test_timestamp_ddl_literals_compare(session):
    session.execute("CREATE TABLE ev (name varchar, at timestamp)")
    session.execute("""
        INSERT INTO ev VALUES
          ('a', TIMESTAMP '2024-01-15 08:30:00'),
          ('b', TIMESTAMP '2024-01-15 19:45:30'),
          ('c', TIMESTAMP '2024-02-01 00:00:00'),
          ('d', NULL)""")
    rows = session.execute(
        "SELECT name, at FROM ev "
        "WHERE at >= TIMESTAMP '2024-01-15 12:00:00' ORDER BY at").rows
    assert [r[0] for r in rows] == ["b", "c"]
    assert rows[0][1] == "2024-01-15 19:45:30"


def test_timestamp_extract_and_functions(session):
    session.execute("CREATE TABLE t2 (at timestamp)")
    session.execute(
        "INSERT INTO t2 VALUES (TIMESTAMP '2023-07-04 13:05:59')")
    rows = session.execute("""
        SELECT EXTRACT(YEAR FROM at), EXTRACT(MONTH FROM at),
               EXTRACT(DAY FROM at), EXTRACT(HOUR FROM at),
               minute(at), second(at), CAST(at AS date)
        FROM t2""").rows
    assert rows == [(2023, 7, 4, 13, 5, 59, "2023-07-04")]


def test_date_to_timestamp_comparison(session):
    session.execute("CREATE TABLE t3 (d date, at timestamp)")
    session.execute("INSERT INTO t3 VALUES "
                    "(DATE '2024-03-01', TIMESTAMP '2024-03-01 10:00:00')")
    rows = session.execute(
        "SELECT count(*) FROM t3 WHERE at > d").rows
    assert rows == [(1,)]


def test_timestamp_aggregates_and_sort(session):
    session.execute("CREATE TABLE t4 (g bigint, at timestamp)")
    session.execute("""
        INSERT INTO t4 VALUES
          (1, TIMESTAMP '2024-01-01 01:00:00'),
          (1, TIMESTAMP '2024-01-02 02:00:00'),
          (2, TIMESTAMP '2024-01-03 03:00:00')""")
    rows = session.execute(
        "SELECT g, min(at), max(at) FROM t4 GROUP BY g ORDER BY g").rows
    assert rows[0] == (1, "2024-01-01 01:00:00", "2024-01-02 02:00:00")
    assert rows[1][0] == 2


# ---------------------------------------------------------------------------
# parity with the reference, pre-epoch instants included
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both():
    from trino_tpu.exec.session import Session as JaxSession
    out = []
    for sess in (Session(default_schema="tiny", device="cpu"),
                 JaxSession(default_schema="tiny")):
        for sql in ts_setup("tiny", np.random.default_rng(7)):
            sess.execute(sql)
        out.append(sess)
    return out


@pytest.mark.parametrize("i", range(len(TS_QUERIES)))
def test_timestamp_rows_equal_reference(both, i):
    port, ref = both
    got = port.execute(TS_QUERIES[i]).rows
    assert got, "every statement returns rows"
    assert got == ref.execute(TS_QUERIES[i]).rows


def test_pre_epoch_rows_present(both):
    port, _ = both
    n_before, = port.execute(
        "SELECT count(*) FROM memory.ts.events "
        "WHERE at < TIMESTAMP '1970-01-01 00:00:00'").rows[0]
    assert n_before > 15000          # every first line, and literals


@pytest.mark.parametrize("lit", TS_BAD_LITERALS)
def test_malformed_literal_refused_like_reference(both, lit):
    errors = []
    for sess in both:
        with pytest.raises(Exception) as ei:
            sess.execute(f"SELECT TIMESTAMP '{lit}'")
        errors.append((type(ei.value).__name__, str(ei.value)))
    assert errors[0] == errors[1]
