"""The port stands alone: importing trino_tpu_torch and running a query,
in process, on the port's mesh (MeshExecutor over eight CPU shards, a
partitioned join), on a port cluster (coordinator, stage scheduler,
worker, failure detector, verifier), through a soak, through the
end-to-end configurations (e2e.py) or through a cold-start child and
the micro-benchmarks (coldstart.py, micro.py, regressions.py), loads
neither jax nor the reference package (checked in fresh interpreters),
and no module of the port or chip_smoke.py imports them."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import trino_tpu_torch
from trino_tpu_torch.exec.session import Session
rows = Session(device="cpu").execute(
    "SELECT count(*) FROM lineitem WHERE l_quantity < 10").rows
assert rows and rows[0][0] > 0, rows
from trino_tpu_torch.parallel.dist_executor import MeshExecutor
from trino_tpu_torch.parallel.mesh import make_mesh
s = Session(device="cpu")
s.executor = MeshExecutor(s.catalog, make_mesh(8, "cpu"))
s.execute("SET SESSION join_distribution_type = 'partitioned'")
s.execute("SET SESSION enable_pallas_hash = true")
rows = s.execute("SELECT count(*) FROM lineitem, orders "
                 "WHERE l_orderkey = o_orderkey").rows
assert rows and rows[0][0] > 0, rows
assert s.executor.stats.mesh_partitioned_joins == 1
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "trino_tpu"))
print("LEAKED", bad)
"""


_CLUSTER_PROBE = """
import sys, time
from trino_tpu_torch import verifier
from trino_tpu_torch.client.client import Client
from trino_tpu_torch.exec.session import Session
from trino_tpu_torch.server.coordinator import CoordinatorServer
from trino_tpu_torch.server.failuredetector import HeartbeatFailureDetector
from trino_tpu_torch.server.worker import WorkerServer
coord = CoordinatorServer(Session(device="cpu")).start()
coord.state.scheduler.split_rows = 8192
worker = WorkerServer("w0", coord.uri, announce_interval_s=0.05,
                      device="cpu").start()
detector = HeartbeatFailureDetector(coord.state, interval_s=0.05).start()
deadline = time.time() + 20
while not coord.state.active_nodes() and time.time() < deadline:
    time.sleep(0.02)
client = Client(coord.uri, user="probe")
r = client.execute("SELECT count(*) FROM lineitem WHERE l_quantity < 10")
assert r.rows and r.rows[0][0] > 0, r.rows
assert client.query_info(r.query_id).get("fallbackReason") is None
assert worker.task_manager.tasks_run > 0
detector.stop(); worker.stop(graceful=False); coord.stop()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "trino_tpu"))
print("LEAKED", bad)
"""


_SOAK_PROBE = """
import sys
from trino_tpu_torch import soak
rec = soak.concurrency_soak(n_clients=4, queries_per_client=1,
                            device="cpu")
assert rec["wrong_answers"] == 0 and rec["failed_queries"] == 0, rec
assert rec["queries"] == 4, rec
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "trino_tpu"))
print("LEAKED", bad)
"""


_E2E_PROBE = """
import sys
from trino_tpu_torch import e2e
code = e2e.main(["--q5-scale", "0.01", "--chunk-rows", "16384",
                 "--q6-schema", "tiny", "--q3-schema", "tiny",
                 "--device", "cpu"])
assert code == 0, code
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "trino_tpu", "bench"))
print("LEAKED", bad)
"""


_COLD_PROBE = """
import sys
from trino_tpu_torch import coldstart, micro, regressions
rec = coldstart.cold_child("q6", "cpu")
assert rec["rows"] == 1 and rec["fresh_compiles"] == 0, rec
rec = micro.gather_micro(table_sizes=[1024], probe_rows=1024, runs=1,
                         device="cpu")
assert not micro.failures(rec), rec
assert regressions.parse_round({"metric": "cold_start", "records": [
    {"query": "q6", "cold_ms": 1.0, "ratio": 1.0}]}) == {
    "cold_q6": 1.0, "cold_q6_ratio": 1.0}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "trino_tpu", "bench"))
print("LEAKED", bad)
"""


def _run_probe(probe):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PYTHONSTARTUP")}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LEAKED []" in out.stdout, out.stdout[-2000:]


def test_fresh_interpreter_loads_no_jax_or_reference():
    _run_probe(_PROBE)


def test_fresh_interpreter_cluster_loads_no_jax_or_reference():
    _run_probe(_CLUSTER_PROBE)


def test_fresh_interpreter_soak_loads_no_jax_or_reference():
    _run_probe(_SOAK_PROBE)


def test_fresh_interpreter_e2e_loads_no_jax_or_reference():
    _run_probe(_E2E_PROBE)


def test_fresh_interpreter_cold_child_loads_no_jax_or_reference():
    _run_probe(_COLD_PROBE)


def test_cluster_modules_are_checked():
    paths = {os.path.relpath(p, REPO) for p in _port_sources()}
    for m in ("server/tasks.py", "server/worker.py", "server/scheduler.py",
              "server/failuredetector.py", "verifier.py", "soak.py",
              "e2e.py", "micro.py", "coldstart.py", "regressions.py"):
        assert os.path.join("trino_tpu_torch", m) in paths


def test_mesh_modules_are_checked():
    paths = {os.path.relpath(p, REPO) for p in _port_sources()}
    for m in ("mesh.py", "exchange.py", "stages.py", "dist_executor.py"):
        assert os.path.join("trino_tpu_torch", "parallel", m) in paths


def _port_sources():
    root = os.path.join(REPO, "trino_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_module_imports_jax_or_reference(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib",
                                              "trino_tpu", "bench"), \
                f"{path}:{node.lineno} imports {name}"


def test_chip_smoke_loads_no_jax_through_test_modules():
    """chip_smoke.py reads query texts and cases from tests/ modules; each
    it imports must itself import neither jax nor the reference package,
    or the script would load them on the card's machine."""
    tests_dir = os.path.join(REPO, "tests")
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    used = {node.module for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) and node.level == 0 and
            node.module and os.path.exists(
                os.path.join(tests_dir, node.module + ".py"))}
    assert used, "chip_smoke.py reads nothing from tests/"
    for mod in sorted(used):
        test_no_module_imports_jax_or_reference(
            os.path.join(tests_dir, mod + ".py"))
