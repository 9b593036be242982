"""The fresh-process cold start: a new interpreter's first query against
the same query's steady wall in a warm process.

The JAX package's harness (``bench.py --cold-start``) times TPC-H q3, q5
and q6 in child processes. This module is that mode for the port, with
the reference's names, gate and record keys. A child
(``python -m trino_tpu_torch.coldstart --child Q``, run in a fresh
interpreter from the repository's root) pays what a new coordinator
pays: importing torch, the Session, the CUDA context, the kernel
libraries (built with nvcc when the build directory is empty), the
table upload and the first run. It prints one JSON line:
``startup_ms`` (the imports and the Session), ``cold_ms`` (the first
execute), and the kernel libraries it built (``fresh_compiles``,
``compile_s``: a "compile" is an nvcc build this process made, a "hit"
a library it found built; ``exec/profiler.RECORDER``).

Per query the parent runs one child with prewarm off (``seed_ms``, the
worst case; it also fills the shared build directory), then
`cold_runs` children with ``TRINO_TPU_PREWARM`` on, which warm the
statement first (``PrewarmEngine.warm_fingerprint``, off the measured
path) and then time the first query-path execution; then it times
`steady_runs` runs in its own warm Session. Gate: the median prewarmed
cold wall / the steady median < `ratio_gate` for every query.

The children share a kernel build directory,
``$TRINO_TPU_CUDA_BUILD_DIR`` if set, else ``<tempdir>/trino_tpu_cold_build``
(never the checkout's ``_build/``), and a data root for the decision
file (``$TRINO_TPU_DATA_CACHE`` if set, else a temporary directory the
run removes). The record is printed, and written only where
``out_path`` (``--out``) says.

    python -m trino_tpu_torch.coldstart [--queries q3,q5,q6]
        [--device cpu] [--out PATH]

exits 1 when a query fails the gate. Everything runs on the card unless
given ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import datetime
import decimal
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

from . import e2e

COLD_QUERIES = {"q3": e2e.Q3, "q5": e2e.Q5, "q6": e2e.Q6}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def schema() -> str:
    return os.environ.get("TRINO_TPU_COLD_SCHEMA", "tiny")


def result_rows(rows) -> list:
    """A result's rows as JSON values: dates, decimals and any other
    non-JSON value as their text."""
    def value(v):
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        if isinstance(v, (datetime.date, decimal.Decimal)):
            return str(v)
        return repr(v)
    return [[value(v) for v in r] for r in rows]


def cold_child(query: str, device="cuda") -> dict:
    """One fresh-process execution of `query`, timed from this function's
    start (the interpreter is already up): imports, the Session and,
    with TRINO_TPU_PREWARM on, the statement's warm off the measured
    path; then the first query-path execution. Returns the record the
    child prints."""
    t_start = time.monotonic()
    from .exec.prewarm import PrewarmEngine, prewarm_enabled_by_env
    from .exec.profiler import RECORDER
    from .exec.session import Session
    from .server.history import plan_fingerprint
    session = Session(default_schema=schema(),
                      device=None if device in (None, "cuda") else device)
    sql = COLD_QUERIES[query]
    prewarmed = False
    if prewarm_enabled_by_env():
        eng = PrewarmEngine(session=session, enabled=True)
        prewarmed = eng.warm_fingerprint(plan_fingerprint(sql), sql)
    before = RECORDER.totals()
    t0 = time.monotonic()
    res = session.execute(sql)
    cold_ms = (time.monotonic() - t0) * 1000
    tot = RECORDER.totals()
    return {"metric": "cold_child", "query": query,
            "device": str(session.device),
            "cold_ms": cold_ms,
            "startup_ms": (t0 - t_start) * 1000,
            "rows": len(res.rows), "result": result_rows(res.rows),
            "prewarmed": prewarmed,
            "fresh_compiles": tot["compiles"] - before["compiles"],
            "prewarm_hits": tot["prewarmHits"],
            "compiles": tot["compiles"], "hits": tot["hits"],
            "compile_s": tot["compileSeconds"]}


def run_child(query: str, prewarm: bool, env: dict, device="cuda",
              timeout_s: float = 600.0) -> dict:
    """`cold_child` in a fresh interpreter with `env`; its record."""
    cenv = dict(env)
    cenv["TRINO_TPU_PREWARM"] = "1" if prewarm else "0"
    cmd = [sys.executable, "-m", "trino_tpu_torch.coldstart", "--child",
           query]
    if device not in (None, "cuda"):
        cmd += ["--device", str(device)]
    p = subprocess.run(cmd, capture_output=True, text=True, env=cenv,
                       cwd=REPO, timeout=timeout_s)
    rec = None
    for line in p.stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                rec = json.loads(line)
            except ValueError:
                continue
    if rec is None or p.returncode != 0:
        raise RuntimeError(f"cold child {query} produced no record "
                           f"(rc={p.returncode}): {p.stderr[-2000:]}")
    return rec


def _child_env(data_root: str) -> dict:
    env = dict(os.environ)
    env.setdefault("TRINO_TPU_CUDA_BUILD_DIR",
                   os.path.join(tempfile.gettempdir(),
                                "trino_tpu_cold_build"))
    env["TRINO_TPU_DATA_CACHE"] = data_root
    # the package from this checkout, whatever the caller's path says
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def cold_start(queries=None, cold_runs=None, steady_runs=None,
               out_path=None, ratio_gate=3.0, device="cuda", log=None):
    """Per query: the prewarm-off seed child, `cold_runs` prewarmed
    children (``TRINO_TPU_COLD_RUNS``, default 2) and `steady_runs`
    (default 5) runs in this process's warm Session, each answer held
    against the steady one; the gate on cold / steady. Returns the
    record ``{"metric": "cold_start", ..., "records", "passed"}``."""
    from .exec.session import Session
    log = log or (lambda msg: print(f"[cold] {msg}", file=sys.stderr,
                                    flush=True))
    dev = e2e._resolve(device)
    queries = queries or list(COLD_QUERIES)
    cold_runs = int(cold_runs or os.environ.get("TRINO_TPU_COLD_RUNS", 2))
    steady_runs = int(steady_runs or 5)
    records, passed = [], True
    with e2e.data_cache_root() as root:
        env = _child_env(root)
        steady_session = Session(default_schema=schema(), device=dev)
        for q in queries:
            # the unwarmed worst case; it also fills the build directory
            seed = run_child(q, False, env, device)
            colds = [run_child(q, True, env, device)
                     for _ in range(cold_runs)]
            cold_ms = statistics.median(c["cold_ms"] for c in colds)
            steady_session.execute(COLD_QUERIES[q])     # in-process warm
            walls = []
            for _ in range(steady_runs):
                t0 = time.monotonic()
                res = steady_session.execute(COLD_QUERIES[q])
                walls.append((time.monotonic() - t0) * 1000)
            steady_ms = statistics.median(walls)
            ratio = cold_ms / max(steady_ms, 1e-6)
            ok = ratio < ratio_gate
            passed = passed and ok
            want = result_rows(res.rows)
            records.append({
                "query": q, "cold_ms": cold_ms,
                "cold_runs": [c["cold_ms"] for c in colds],
                "seed_ms": seed["cold_ms"],
                "seed_startup_ms": seed["startup_ms"],
                "seed_fresh_compiles": seed["fresh_compiles"],
                "seed_compile_s": seed["compile_s"],
                "startup_ms": statistics.median(
                    c["startup_ms"] for c in colds),
                "fresh_compiles": colds[-1]["fresh_compiles"],
                "compile_s": colds[-1]["compile_s"],
                "prewarm_hits": colds[-1].get("prewarm_hits", 0),
                "steady_ms": steady_ms,
                "ratio": ratio, "passed": ok,
                "rows": len(res.rows),
                "answers_steady": all(c["result"] == want
                                      for c in [seed] + colds)})
            log(json.dumps({"metric": "cold_start_progress",
                            **records[-1]}))
    rec = {"metric": "cold_start", "schema": schema(),
           "device": str(dev),
           **{k: v for k, v in e2e.card_facts(dev).items()
              if k in ("card", "power_limit")},
           "ratio_gate": ratio_gate, "cold_runs": cold_runs,
           "steady_runs": steady_runs,
           "build_dir": env["TRINO_TPU_CUDA_BUILD_DIR"],
           "records": records, "passed": passed}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m trino_tpu_torch.coldstart",
        description="fresh-process cold walls against in-process steady "
                    "walls; print one JSON record (exit 1 when a "
                    "cold/steady ratio reaches the gate)")
    p.add_argument("--queries", default=",".join(COLD_QUERIES),
                   help="of q3,q5,q6")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--out", default=None,
                   help="also write the record to this JSON file")
    p.add_argument("--child", metavar="QUERY", help=argparse.SUPPRESS)
    return p


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    if a.child:
        # a child run alone keeps its decision file off the checkout too
        with e2e.data_cache_root():
            rec = cold_child(a.child, a.device)
        print(json.dumps(rec), flush=True)
        return 0
    rec = cold_start(queries=[q.strip() for q in a.queries.split(",")
                              if q.strip()],
                     out_path=a.out, device=a.device)
    print(json.dumps(rec), flush=True)
    return 0 if rec["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
