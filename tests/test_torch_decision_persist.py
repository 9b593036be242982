"""The port's decision cache on disk (trino_tpu_torch/exec/executor.py
`_load_decisions`, `save_decisions`), against the reference's.

The three tests of tests/test_decision_persist.py run on the port: a
fresh Executor replays the decision file a previous one wrote, a corrupt
file is a cold start, and a mutable catalog never persists. The port
keeps its own file, `decisions_torch.pkl`, beside the reference's
`decisions.pkl` under the data cache's root, and never reads the
reference's. A replayed JOIN_Q reserves what the reference's replayed
run reserves, byte for byte, so the pool's peak is the reference's."""

import os
import pickle

import pytest
import torch

from test_memory_pressure import JOIN_Q
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu_torch.catalog import Catalog
from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.exec.session import Session

torch.set_num_threads(1)

Q = ("SELECT l_orderkey, sum(l_quantity) FROM lineitem "
     "GROUP BY l_orderkey ORDER BY l_orderkey LIMIT 7")


@pytest.fixture
def decision_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_DATA_CACHE", str(tmp_path))
    monkeypatch.setenv("TRINO_TPU_DECISION_CACHE", "1")
    return tmp_path


def _session():
    return Session(default_schema="tiny", device="cpu")


def test_decisions_persist_and_replay(decision_dir):
    s1 = _session()
    want = s1.execute(Q).rows
    ex1 = s1.executor
    path = os.path.join(str(decision_dir), "decisions_torch.pkl")
    assert os.path.isfile(path)                      # saved by execute()
    assert not os.path.exists(os.path.join(str(decision_dir),
                                           "decisions.pkl"))
    with open(path, "rb") as f:
        disk = pickle.load(f)
    assert disk                                      # something recorded
    for k, v in disk.items():
        assert ex1._decision_cache[k] == v

    # a fresh executor stands in for a fresh process: decisions replay
    s2 = _session()
    got = s2.execute(Q).rows
    assert got == want
    ex2 = s2.executor
    assert ex2._decision_loaded
    for k, v in disk.items():
        assert ex2._decision_cache.get(k) == v


def test_disk_corruption_is_cold_start(decision_dir):
    path = os.path.join(str(decision_dir), "decisions_torch.pkl")
    with open(path, "wb") as f:
        f.write(b"\x80garbage")
    s = _session()
    assert s.execute(Q).rows                          # no crash
    assert s.executor._decision_loaded


def test_mutable_catalog_never_persists(decision_dir):
    cat = Catalog()
    cat.register("m", MemoryConnector())
    s = Session(catalog=cat, default_cat="m", default_schema="s",
                device="cpu")
    s.execute("CREATE TABLE m.s.t (x bigint)")
    s.execute("INSERT INTO m.s.t VALUES (1), (2), (3)")
    s.execute("SELECT x, count(*) FROM m.s.t GROUP BY x")
    # memory-connector subtrees have no structure key -> nothing cached
    assert not s.executor._decision_cache
    assert not os.path.exists(os.path.join(str(decision_dir),
                                           "decisions_torch.pkl"))


def test_the_reference_decision_file_is_never_read(decision_dir):
    """A `decisions.pkl` the reference wrote (here: one that poisons
    every key the port would look up) leaves the port's run cold."""
    s1 = _session()
    s1.execute(Q)
    poisoned = {k: (1 << 40,) * len(v)
                for k, v in s1.executor._decision_cache.items()}
    os.remove(os.path.join(str(decision_dir), "decisions_torch.pkl"))
    with open(os.path.join(str(decision_dir), "decisions.pkl"), "wb") as f:
        pickle.dump(poisoned, f)
    s2 = _session()
    assert s2.execute(Q).rows == s1.execute(Q).rows
    assert s2.executor._decision_loaded
    assert all(s2.executor._decision_cache.get(k) != v
               for k, v in poisoned.items())


def test_replayed_join_peak_equals_reference(decision_dir):
    """A second session replays the first one's decisions from disk in
    both packages: its pool peak drops below the cold run's, and the
    port's replayed peak equals the reference's replayed peak."""
    peaks = {}
    rows = {}
    for name, make in (("jax", lambda: JaxSession(default_schema="tiny")),
                       ("port", _session)):
        cold = make()
        rows[name] = cold.execute(JOIN_Q).rows
        warm = make()
        assert warm.execute(JOIN_Q).rows == rows[name]
        assert warm.executor._decision_loaded
        peaks[name] = (cold.executor.pool.peak, warm.executor.pool.peak)
    assert rows["port"] == rows["jax"]
    assert peaks["port"] == peaks["jax"]
    assert peaks["port"][1] < peaks["port"][0]


def test_result_decisions_are_saved_with_the_statement(decision_dir):
    """The reference's `_decision_dirty is False` after execute: the
    decisions taken while the result comes to the host (`resultlive`)
    are saved too, in both packages, so the file holds every decision
    the statement recorded."""
    for make, name in ((lambda: JaxSession(default_schema="tiny"),
                        "decisions.pkl"), (_session, "decisions_torch.pkl")):
        s = make()
        s.execute(Q)
        ex = s.executor
        assert ex._decision_cache
        assert ex._decision_dirty is False
        tags = {k[0] for k in ex._decision_cache}
        assert "resultlive" in tags
        with open(os.path.join(str(decision_dir), name), "rb") as f:
            disk = pickle.load(f)
        assert set(disk) == set(ex._decision_cache)
