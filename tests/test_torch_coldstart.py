"""The fresh-process cold start on the port (trino_tpu_torch/coldstart.py)
against the reference's (bench.py's --cold-start), on the CPU at
`tpch.tiny`:

- one q6 child in a fresh interpreter (`python -m
  trino_tpu_torch.coldstart --child q6 --device cpu`): its rows equal
  the JAX Session's, no kernel library built on the CPU, and its data
  root kept off the checkout;
- `cold_start(queries=["q6"], cold_runs=1, steady_runs=1,
  device="cpu")`: every child answers the steady session's rows, and
  the record parses into `cold_q6` and `cold_q6_ratio` in both
  packages' round parsers.

The walls of a CPU run mean nothing; the rows are compared exactly."""

import json
import os
import subprocess
import sys

import torch

import bench
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu_torch import coldstart, regressions

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_q6_child_in_a_fresh_interpreter_answers_as_jax(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PYTHONSTARTUP")}
    env.update(PYTHONPATH=REPO, TRINO_TPU_DATA_CACHE=str(tmp_path / "dc"),
               TRINO_TPU_PREWARM="0")
    out = subprocess.run([sys.executable, "-m", "trino_tpu_torch.coldstart",
                          "--child", "q6", "--device", "cpu"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    want = JaxSession(default_schema="tiny").execute(coldstart.COLD_QUERIES[
        "q6"]).rows
    assert rec["query"] == "q6" and rec["device"] == "cpu"
    assert rec["result"] == coldstart.result_rows(want)
    assert rec["rows"] == len(want) == 1
    assert rec["prewarmed"] is False and rec["fresh_compiles"] == 0
    assert rec["cold_ms"] > 0 and rec["startup_ms"] > 0


def test_cold_start_record_parses_as_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_DATA_CACHE", str(tmp_path / "dc"))
    monkeypatch.setenv("TRINO_TPU_CUDA_BUILD_DIR", str(tmp_path / "build"))
    path = tmp_path / "BENCH_cold_r01.json"
    rec = coldstart.cold_start(queries=["q6"], cold_runs=1, steady_runs=1,
                               device="cpu", out_path=str(path),
                               log=lambda msg: None)
    (r,) = rec["records"]
    assert r["query"] == "q6" and r["answers_steady"] is True
    assert r["rows"] == 1 and len(r["cold_runs"]) == 1
    assert r["seed_fresh_compiles"] == 0 and r["fresh_compiles"] == 0
    assert rec["build_dir"] == str(tmp_path / "build")
    assert not os.path.exists(tmp_path / "build")   # nothing built on CPU
    parsed = regressions.load_bench_round(str(path))
    assert parsed == {"cold_q6": r["cold_ms"], "cold_q6_ratio": r["ratio"]}
    assert bench.load_bench_round(str(path)) == parsed
