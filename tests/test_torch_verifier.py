"""The port's verifier (trino_tpu_torch/verifier.py) on the CPU at
tpch.tiny: a handful of TPC-H queries match the sqlite control, with the
same verdicts as the reference's verifier; a planted wrong result is
reported as a MISMATCH; the CLI runs on the card unless `--device`
names the CPU."""

import pytest
import torch

from tpch_full import QUERIES as TPCH
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu.verifier import Verifier as JaxVerifier
from trino_tpu_torch.connectors.tpch.connector import TABLE_NAMES
from trino_tpu_torch.exec.session import Session
from trino_tpu_torch import verifier as tverifier

torch.set_num_threads(1)

QUERIES = {q: TPCH[q] for q in (1, 3, 6, 12, 14)}


@pytest.fixture(scope="module")
def verifier():
    return tverifier.Verifier(Session(default_schema="tiny", device="cpu"),
                              list(TABLE_NAMES))


def test_suite_matches_control_like_reference(verifier):
    got = verifier.run_suite(QUERIES)
    assert [r.status for r in got] == ["MATCH"] * len(QUERIES), \
        [(r.name, r.detail) for r in got if r.status != "MATCH"]
    ref = JaxVerifier(JaxSession(default_schema="tiny"), list(TABLE_NAMES))
    want = ref.run_suite(QUERIES)
    assert [(r.name, r.status, r.test_rows, r.control_rows)
            for r in got] == [(r.name, r.status, r.test_rows,
                               r.control_rows) for r in want]


def test_planted_wrong_result_is_a_mismatch(verifier):
    r = verifier.verify("planted", "SELECT count(*) FROM orders",
                        control_sql="SELECT count(*) + 1 FROM orders")
    assert r.status == "MISMATCH"
    assert "15000" in r.detail and "15001" in r.detail
    r = verifier.verify("broken", "SELECT no_such_column FROM orders")
    assert r.status == "TEST_ERROR"


def test_cli_takes_the_device(monkeypatch, capsys):
    assert tverifier.main(["--device", "cpu", "-e",
                           "SELECT count(*) FROM nation"]) == 0
    assert capsys.readouterr().out.startswith("MATCH")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tverifier.main(["-e", "SELECT count(*) FROM nation"])
