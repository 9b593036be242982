"""The harness's run, driven here without a card: no result where there
is no card, and `correct` false under each fault a cell can have."""

import json
import os
import subprocess
import sys
from decimal import Decimal

import pytest

from portbench import compare, run
from portbench.traffic import load_json

from .conftest import TINY_ROWS

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "tpch-sf10.joins"
CELLS = ["tpch-sf10.joins"]


def _cell_rows(cell=CELL):
    return TINY_ROWS[load_json("workloads", cell + ".json")["config"]]


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELL,
         "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _run(cell=CELL, trace=False):
    return run.run_cell(cell, 2**31 + 23, 1.0, trace, device="cpu",
                        rows=_cell_rows(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_reports_its_metrics(cell):
    out = _run(cell)
    assert out["correct"] and out["failed"] == 0
    assert set(out["metrics"]) == {"qps", "setup_s"}
    assert list(out)[-1] == "correctness"
    json.dumps(out)


def _faulty(monkeypatch, cell, alter):
    from trino_tpu_torch.exec.session import Session
    real = Session.execute_planned

    def broken(self, rel, root, t0):
        res = real(self, rel, root, t0)
        res.rows = alter(list(res.rows))
        return res

    monkeypatch.setattr(Session, "execute_planned", broken)
    return _run(cell)


def _bump_first_number(rows):
    if rows:
        r = list(rows[0])
        for i, v in enumerate(r):
            if isinstance(v, (int, float)) or hasattr(v, "as_tuple"):
                r[i] = v + 1
                break
        rows[0] = tuple(r)
    return rows


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault,alter", [
    ("an answer altered where it is produced", _bump_first_number),
    ("half of the rows left out", lambda rows: rows[::2] if len(rows) > 1
     else []),
])
def test_a_fault_makes_the_run_incorrect(monkeypatch, cell, fault, alter):
    out = _faulty(monkeypatch, cell, alter)
    assert out["correctness"]["wrong_answers"]["value"] > 0, fault
    assert out["correct"] is False


def test_a_failing_query_makes_the_run_incorrect(monkeypatch):
    from trino_tpu_torch.exec.session import Session
    real = Session.execute_planned
    calls = []

    def failing(self, rel, root, t0):
        calls.append(1)
        if len(calls) > 12:               # after the warm-up
            raise RuntimeError("planted fault")
        return real(self, rel, root, t0)

    monkeypatch.setattr(Session, "execute_planned", failing)
    out = _run()
    assert out["failed"] > 0
    assert out["correctness"]["failed_queries"]["value"] > 0
    assert out["correct"] is False


def test_a_query_that_breaks_the_client_is_recorded_as_failed(monkeypatch):
    """A malformed page (here a ValueError inside the client) is the
    query's failure, not a stream that stops without a record."""
    from portbench import client
    from portbench.traffic import Traffic

    def malformed(base, sql, span=None):
        raise ValueError("Expecting value: line 1 column 1 (char 0)")

    monkeypatch.setattr(client, "run", malformed)
    q = Traffic(load_json("workloads", CELL + ".json"), 5).query("0", 0)
    rec = run.send("http://127.0.0.1:1", q)
    assert not rec.ok and rec.error.startswith("ValueError")
    assert rec.t_done >= rec.t_submit


@pytest.mark.parametrize("cell", CELLS)
def test_the_float32_control_comes_out_wrong(cell):
    """The reference summing in float32, rounded to each column's scale
    and sent as decimal text, put in the program's place after the
    window, turns `correct` false on every seed; the program's own
    answers of the same runs are right."""
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        out = run.run_cell(cell, seed, 1.0, False, device="cpu",
                           rows=_cell_rows(cell),
                           controls=("float32", "float64"))
        assert out["correct"], out["correctness"]
        f32 = out["controls"]["float32"]
        assert f32["wrong_answers"] > 0 and f32["correct"] is False, out
        assert f32["compared"] == out["controls"]["float64"]["compared"]


def test_a_decimal_sent_as_a_double_is_wrong():
    """The comparison reads each value by its column's type: a decimal
    must come as decimal text, even when its digits are right."""
    spec = {"columns": [["k", "bigint"], ["revenue", "decimal(38,4)"]],
            "order_by": [["k", "asc"]]}
    want = [(1, Decimal("12.5000"))]
    assert compare.differs(spec, [[1, "12.5000"]], want) is None
    assert compare.differs(spec, [[1, "12.5"]], want) is None
    assert compare.differs(spec, [[1, 12.5]], want) is not None
    assert compare.differs(spec, [[1.0, "12.5"]], want) is not None


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_a_short_run_is_correct(card, cell):
    out = run.run_cell(cell, 2**31 + 29, 2.0, True, device=card,
                       rows=_cell_rows(cell))
    assert out["correct"], out
    assert out["device"]["busy_s"] > 0
