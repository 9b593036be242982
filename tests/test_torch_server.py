"""The port's coordinator over HTTP (tpch.tiny, on the CPU): the
statement protocol, query info, failures, cancel and deadlines,
admission, authentication, the CLI, the ledger across a restart, and
worker announces. Error names and rows are held to the
reference's coordinator, which gets the same statements."""

import io
import json
import time
import urllib.error
import urllib.request

import pytest
import torch

from trino_tpu.client.cli import render_table as jax_render_table
from trino_tpu.client.client import Client as JaxClient
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu.server.coordinator import CoordinatorServer as JaxServer
from trino_tpu.server.failureinjector import DELAY as JAX_DELAY
from trino_tpu.server.failureinjector import \
    FailureInjector as JaxInjector
from trino_tpu_torch.client.cli import LocalBackend, render_table
from trino_tpu_torch.client.client import Client
from trino_tpu_torch.exec.session import Session
from trino_tpu_torch.server.coordinator import CoordinatorServer
from trino_tpu_torch.server.failureinjector import DELAY, FailureInjector
from trino_tpu_torch.server.security import PasswordAuthenticator

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def servers(tmp_path_factory, monkeypatch_module):
    monkeypatch_module.setenv(
        "TRINO_TPU_HISTORY_PATH",
        str(tmp_path_factory.mktemp("hist") / "h.jsonl"))
    ref = JaxServer(JaxSession(default_schema="tiny")).start()
    port = CoordinatorServer(Session(default_schema="tiny",
                                     device="cpu")).start()
    yield ref, port
    ref.stop()
    port.stop()


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def client(servers):
    return Client(servers[1].uri, user="test", poll_interval_s=0.005)


def _http(method, url, body=None, headers=None):
    req = urllib.request.Request(url, data=body, method=method,
                                 headers=headers or {"X-Trino-User": "t"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        data = resp.read()
    return json.loads(data) if data else {}


def test_statement_protocol_roundtrip(client):
    r = client.execute("SELECT n_name, n_regionkey FROM nation "
                       "ORDER BY n_nationkey LIMIT 5")
    assert r.state == "FINISHED"
    assert r.columns == ["n_name", "n_regionkey"]
    assert r.rows == [["ALGERIA", 0], ["ARGENTINA", 1], ["BRAZIL", 1],
                      ["CANADA", 1], ["EGYPT", 4]]


def test_paging_equals_reference(servers, client):
    """15,000 rows arrive over 15 nextUri pages, equal to the
    reference's."""
    sql = ("SELECT o_orderkey, o_totalprice FROM orders "
           "ORDER BY o_orderkey")
    doc = _http("POST", servers[1].uri + "/v1/statement", sql.encode())
    pages = 0
    while "nextUri" in doc:
        doc = _http("GET", doc["nextUri"])
        pages += "data" in doc
    assert pages == 15
    ref = JaxClient(servers[0].uri, user="t").execute(sql).rows
    assert client.execute(sql).rows == ref and len(ref) == 15000


def test_server_info(client):
    info = client.server_info()
    assert info["coordinator"] is True
    assert info["nodeVersion"] == {"version": "trino-tpu-0.1"}


def test_query_info_and_listing(client):
    r = client.execute("SELECT 1")
    info = client.query_info(r.query_id)
    assert info["state"] == "FINISHED" and info["rows"] == 1
    assert info["fallbackReason"] == "no active workers"
    assert any(q["queryId"] == r.query_id for q in client.list_queries())


@pytest.mark.parametrize("sql", ["SELEC broken",
                                 "SELECT no_such_column FROM nation",
                                 "SELECT count(*) FROM no_such_table"])
def test_failure_error_name_equals_reference(servers, sql):
    names = []
    for cls, srv in ((JaxClient, servers[0]), (Client, servers[1])):
        with pytest.raises(Exception) as ei:
            cls(srv.uri, user="t").execute(sql)
        names.append((type(ei.value).__name__, ei.value.error_name))
    assert names[1] == names[0]
    assert names[1][0] == "QueryError"


def _delayed(srv, injector, delay, sql):
    """POST `sql` to `srv` with one `delay` fault (the injector module's
    DELAY) of 1 s scheduled at the dispatcher's EXECUTION point; returns
    the first page."""
    srv.state.dispatcher.failure_injector = injector
    injector.inject("EXECUTION", fault=delay, delay_s=1.0)
    return _http("POST", srv.uri + "/v1/statement", sql.encode())


def _final(doc):
    while "nextUri" in doc:
        doc = _http("GET", doc["nextUri"])
    return doc


def _wait_state(srv, qid, state, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if srv.state.tracker.get(qid).state == state:
            return
        time.sleep(0.01)
    raise AssertionError(f"{qid} never reached {state}")


def test_cancel_through_delete_equals_reference(servers):
    sql = "SELECT count(*) FROM lineitem"
    errors = []
    for srv, inj, delay in ((servers[0], JaxInjector(), JAX_DELAY),
                            (servers[1], FailureInjector(), DELAY)):
        try:
            doc = _delayed(srv, inj, delay, sql)
            _wait_state(srv, doc["id"], "RUNNING")
            req = urllib.request.Request(
                srv.uri + f"/v1/statement/executing/{doc['id']}/0",
                method="DELETE", headers={"X-Trino-User": "t"})
            urllib.request.urlopen(req, timeout=30).close()
            errors.append(_final(doc)["error"])
        finally:
            srv.state.dispatcher.failure_injector = None
    assert errors[1] == errors[0]
    assert errors[1]["errorName"] == "USER_CANCELED"
    assert Client(servers[1].uri).execute(sql).rows == [[60104]]


def test_deadline_equals_reference(servers):
    sql = "SELECT count(*) FROM orders"
    errors = []
    for srv, cls, inj, delay in (
            (servers[0], JaxClient, JaxInjector(), JAX_DELAY),
            (servers[1], Client, FailureInjector(), DELAY)):
        cl = cls(srv.uri, user="t")
        cl.execute("SET SESSION query_max_run_time_s = 0.2")
        try:
            errors.append(_final(_delayed(srv, inj, delay, sql))["error"])
        finally:
            srv.state.dispatcher.failure_injector = None
            cl.execute("SET SESSION query_max_run_time_s = 0")
    assert errors[1] == errors[0]
    assert errors[1]["errorName"] == "QUERY_EXCEEDED_RUN_TIME"
    assert Client(servers[1].uri).execute(sql).rows == [[15000]]


def test_max_concurrency_queues(monkeypatch, tmp_path):
    monkeypatch.setenv("TRINO_TPU_HISTORY_PATH", str(tmp_path / "h.jsonl"))
    srv = CoordinatorServer(Session(default_schema="tiny", device="cpu"),
                            max_concurrency=1).start()
    try:
        first = _delayed(srv, FailureInjector(), DELAY,
                         "SELECT count(*) FROM nation")
        _wait_state(srv, first["id"], "RUNNING")
        second = _http("POST", srv.uri + "/v1/statement",
                       b"SELECT count(*) FROM region")
        assert srv.state.tracker.get(second["id"]).state == "QUEUED"
        assert _final(second)["data"] == [[5]]
        assert _final(first)["data"] == [[25]]
    finally:
        srv.state.dispatcher.failure_injector = None
        srv.stop()


def test_password_authenticator(servers):
    srv = servers[1]
    srv.state.dispatcher.authenticator = PasswordAuthenticator(
        {"alice": "s3cret"})
    try:
        ok = Client(srv.uri, user="alice", password="s3cret")
        assert ok.execute("SELECT count(*) FROM region").rows == [[5]]
        for cl in (Client(srv.uri, user="alice", password="wrong"),
                   Client(srv.uri, user="mallory")):
            with pytest.raises(urllib.error.HTTPError) as e:
                cl.execute("SELECT 1")
            assert e.value.code == 401
    finally:
        srv.state.dispatcher.authenticator = None


def test_cli_render_and_local_backend():
    backend = LocalBackend(device="cpu")
    assert backend.session.device.type == "cpu"
    columns, rows = backend.execute(
        "SELECT n_name, n_regionkey FROM nation ORDER BY n_nationkey "
        "LIMIT 2")
    out, ref = io.StringIO(), io.StringIO()
    render_table(columns, rows, out)
    jax_render_table(columns, rows, ref)
    assert out.getvalue() == ref.getvalue()
    assert "ALGERIA" in out.getvalue() and "(2 rows)" in out.getvalue()


def test_ledger_restart_restores_finished_query(monkeypatch, tmp_path):
    """A ledger-backed coordinator is killed and a new one boots on the
    same ledger: the FINISHED query comes back with its state and row
    count, and a data poll re-executes it to the same rows."""
    monkeypatch.setenv("TRINO_TPU_HISTORY_PATH", str(tmp_path / "h.jsonl"))
    path = str(tmp_path / "q.ledger")
    sql = "SELECT n_name FROM nation WHERE n_regionkey = 1 " \
          "ORDER BY n_name"
    old = CoordinatorServer(Session(default_schema="tiny", device="cpu"),
                            ledger_path=path).start()
    try:
        r = Client(old.uri, user="alice").execute(sql)
    finally:
        old.kill()
        old.state.dispatcher.pool.shutdown(wait=False)
    new = CoordinatorServer(Session(default_schema="tiny", device="cpu"),
                            ledger_path=path).start()
    try:
        tq = new.state.tracker.get(r.query_id)
        assert tq.state == "FINISHED" and tq.resumed == "restored"
        assert tq.rows_returned == 5 and tq.result is None
        assert tq.session_user == "alice"
        doc = _final(_http(
            "GET", new.uri + f"/v1/statement/executing/{r.query_id}/0"))
        assert doc["data"] == r.rows
    finally:
        new.stop()


def test_announce_is_refused_naming_its_roadmap_item(servers):
    """Announces were refused (501) until the workers were ported; now
    both coordinators accept one (202), list the node, and drop it again
    on its LEFT announce. The node announces DRAINED, so no split of
    another test is ever placed on it."""
    for srv in servers:
        for state in ("DRAINED", "LEFT"):
            body = json.dumps({"nodeId": "w1", "uri": "http://127.0.0.1:1",
                               "state": state})
            req = urllib.request.Request(
                srv.uri + "/v1/announce", data=body.encode(),
                method="POST", headers={"X-Trino-User": "t"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                assert resp.status == 202
            if state == "DRAINED":
                assert srv.state.nodes["w1"].state == "DRAINED"
                assert srv.state.active_nodes() == []
        assert srv.state.nodes == {}