"""The reference's rows for the whole SQL corpus at SF1: all 22 TPC-H
queries (tests/tpch_full.py) over tpch.sf1 and all 99 TPC-DS queries
(tests/tpcds_queries.py) over tpcds.sf1, each run once through the JAX
Session on the CPU at the session defaults, kept as
tests/torch_corpus_sf1.json (rows, digest and first rows of each query
in the canonical form of tests/torch_corpus.py, the reference's seconds,
and a digest of every generated table).

    JAX_PLATFORMS=cpu python tools/corpus_reference.py [--resume]
        [--only tpch:7,tpcds:95] [--timeout 600]

Each suite runs in a child process of its own (the two in parallel); a
query that raises, or that answers slower than --timeout seconds (the
child is then killed and started anew), is recorded with its error. The
file is rewritten after every query, so an interrupted run goes on with
--resume, which skips the queries already in the file.

    python tools/corpus_reference.py --engine port [--out FILE]

runs the same queries through the port's Session(device="cpu") instead
(no jax is imported then), writes its own summaries to FILE (default
_scratch/corpus_port_cpu.json) and prints, for each query, whether they
equal the reference's in tests/torch_corpus_sf1.json. With
--fill-unanswered it runs only the queries the reference did not answer
and keeps the port CPU Session's answer to each in the reference's file
(the entry's `port_cpu`), which the card is then held against."""

import argparse
import json
import multiprocessing as mp
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_corpus as tc  # noqa: E402

SCHEMA = "sf1"


def _tables(engine: str, suite: str):
    if engine == "reference":
        if suite == "tpch":
            from trino_tpu.connectors.tpch.connector import (TABLE_NAMES,
                                                             TpchConnector)
            return TpchConnector(), TABLE_NAMES
        from trino_tpu.connectors.tpcds.connector import (TABLE_NAMES,
                                                          TpcdsConnector)
        return TpcdsConnector(), TABLE_NAMES
    if suite == "tpch":
        from trino_tpu_torch.connectors.tpch.connector import (
            TABLE_NAMES, TpchConnector)
        return TpchConnector(), TABLE_NAMES
    from trino_tpu_torch.connectors.tpcds.connector import (TABLE_NAMES,
                                                            TpcdsConnector)
    return TpcdsConnector(), TABLE_NAMES


def _session(engine: str, suite: str, threads: int):
    """The engine's Session over `<suite>.sf1` and the digest of every
    table of the suite, generated through the same connector."""
    conn, names = _tables(engine, suite)
    digests = {n: tc.table_digest(conn.get_table(SCHEMA, n)) for n in names}
    if engine == "reference":
        from trino_tpu.catalog import Catalog
        from trino_tpu.exec.session import Session
        cat = Catalog()
        cat.register(suite, conn)
        return Session(cat, default_cat=suite,
                       default_schema=SCHEMA), digests
    import torch
    torch.set_num_threads(threads)
    from trino_tpu_torch.catalog import Catalog
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.exec.session import Session
    cat = Catalog()
    cat.register(suite, conn)
    cat.register("memory", MemoryConnector())
    return Session(cat, default_cat=suite, default_schema=SCHEMA,
                   device="cpu"), digests


def _child(engine: str, suite: str, schema: str, threads: int,
           max_gb: float, pipe) -> None:
    """Answers query numbers sent down `pipe` with their summaries."""
    global SCHEMA
    SCHEMA = schema
    if max_gb:
        # a query past the cap raises (recorded) instead of taking the
        # machine's memory
        import resource
        cap = int(max_gb * (1 << 30))
        resource.setrlimit(resource.RLIMIT_AS, (cap, cap))
    session, digests = _session(engine, suite, threads)
    pipe.send(("tables", digests))
    queries = tc.suite_queries(suite)
    while True:
        q = pipe.recv()
        if q is None:
            return
        t0 = time.monotonic()
        try:
            out = tc.summary(queries[q], session.execute(queries[q]).rows)
        except Exception as e:                      # recorded, not raised
            out = {"error": f"{type(e).__name__}: {e}"[:500]}
        out["seconds"] = time.monotonic() - t0
        pipe.send(("query", out))


class Runner:
    """One suite's child process, restarted after a timeout."""

    def __init__(self, engine, suite, threads, max_gb):
        self.engine, self.suite, self.threads = engine, suite, threads
        self.max_gb = max_gb
        self.proc = None

    def start(self):
        ctx = mp.get_context("spawn")
        self.pipe, theirs = ctx.Pipe()
        self.proc = ctx.Process(target=_child, args=(
            self.engine, self.suite, SCHEMA, self.threads, self.max_gb,
            theirs),
            daemon=True)
        self.proc.start()
        kind, digests = self.pipe.recv()
        assert kind == "tables"
        return digests

    def ask(self, q, timeout):
        if self.proc is None:
            self.start()
        self.pipe.send(q)
        t0 = time.monotonic()
        try:
            if self.pipe.poll(timeout):
                out = self.pipe.recv()[1]
                if "allocate" in out.get("error", ""):
                    # past the memory cap: a fresh process for the next
                    # query (this one keeps its heap)
                    self.stop()
                return out
        except EOFError:            # the child died under the query
            self.proc.join(60)
            code = self.proc.exitcode
            self.proc = None
            return {"error": f"the engine's process died (exit code "
                             f"{code})", "seconds": time.monotonic() - t0}
        self.stop(kill=True)
        return {"error": f"no answer within {timeout} s",
                "seconds": float(timeout)}

    def stop(self, kill=False):
        if self.proc is None:
            return
        if kill:
            self.proc.kill()
        else:
            self.pipe.send(None)
        self.proc.join(60)
        self.proc = None


def _write(path, doc, lock):
    with lock:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)


def _run_suite(engine, suite, todo, doc, path, lock, timeout, threads,
               max_gb):
    runner = Runner(engine, suite, threads, max_gb)
    digests = runner.start()
    with lock:
        doc["tables"][suite] = digests
    for q in todo:
        out = runner.ask(q, timeout)
        with lock:
            doc["queries"][tc.key(suite, q)] = out
        _write(path, doc, lock)
        what = out.get("error") or f"{out['rows']} rows"
        print(f"{tc.key(suite, q)}: {what} in {out['seconds']:.1f} s",
              flush=True)
    runner.stop()


def compare(doc, ref) -> int:
    """Prints each query as equal or different to the reference's; the
    number of differences."""
    diffs = 0
    for suite in tc.SUITES:
        for n, d in sorted(doc["tables"].get(suite, {}).items()):
            if ref["tables"][suite].get(n) != d:
                print(f"table {suite}.{n}: generated data differs")
                diffs += 1
    for k in sorted(doc["queries"], key=lambda k: (k.split(":")[0],
                                                  int(k.split(":")[1]))):
        got, want = doc["queries"][k], ref["queries"].get(k, {})
        if "error" in want:
            verdict = "reference did not answer"
        elif "error" in got:
            verdict = f"DIFFERENT (port raised {got['error']})"
        elif got["sha256"] == want["sha256"]:
            verdict = "equal"
        else:
            verdict = (f"DIFFERENT ({got['rows']} rows against "
                       f"{want['rows']}; head {got['head']} against "
                       f"{want['head']})")
        diffs += verdict.startswith("DIFFERENT")
        print(f"{k}: {verdict} ({got['seconds']:.2f} s)")
    return diffs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", choices=("reference", "port"),
                    default="reference")
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", default="",
                    help="comma-separated keys, e.g. tpch:7,tpcds:95")
    ap.add_argument("--resume", action="store_true",
                    help="skip queries already in the output file")
    ap.add_argument("--timeout", type=float,
                    default=tc.REFERENCE_TIMEOUT_S)
    ap.add_argument("--ref", default=tc.SF1_FILE,
                    help="the reference's file a port run is held against")
    ap.add_argument("--fill-unanswered", action="store_true",
                    help="with --engine port: run the queries the "
                         "reference did not answer (or --only) and keep "
                         "each answer in the reference's file as the "
                         "entry's `port_cpu`")
    ap.add_argument("--schema", default="sf1",
                    help="scale of both suites (sf1 for the kept file)")
    ap.add_argument("--max-memory-gb", type=float, default=0,
                    help="address-space cap of each child process (0: "
                         "none); a query past it is recorded as an error")
    ap.add_argument("--threads", type=int, default=4,
                    help="torch threads of each port child")
    args = ap.parse_args()
    global SCHEMA
    SCHEMA = args.schema
    path = args.out or (tc.SF1_FILE if args.engine == "reference" else
                        os.path.join(ROOT, "_scratch",
                                     "corpus_port_cpu.json"))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if args.engine == "reference":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
    doc = {"about": ("the rows of each corpus query at sf1 in the canonical "
                     "form of tests/torch_corpus.py, from "
                     "tools/corpus_reference.py"),
           "engine": ("the reference's JAX Session on the CPU at its session "
                      "defaults" if args.engine == "reference" else
                      "the port's Session(device='cpu') at its defaults"),
           "seconds_are": "wall seconds of one run on the CPU of the "
                          "machine that ran the tool, not card numbers",
           "schema": args.schema, "tables": {}, "queries": {}}
    if (args.resume or args.only) and os.path.exists(path):
        old = tc.load(path)
        doc["tables"].update(old.get("tables", {}))
        doc["queries"].update(old.get("queries", {}))
    only = {k for k in args.only.split(",") if k}
    if args.fill_unanswered and not only:
        only = {k for k, v in tc.load(args.ref)["queries"].items()
                if "error" in v}
    lock = threading.Lock()
    threads = []
    for suite in tc.SUITES:
        todo = [q for q in sorted(tc.suite_queries(suite))
                if (not only or tc.key(suite, q) in only)
                and not (args.resume and tc.key(suite, q) in doc["queries"])]
        if todo:
            threads.append(threading.Thread(target=_run_suite, args=(
                args.engine, suite, todo, doc, path, lock, args.timeout,
                args.threads, args.max_memory_gb)))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    _write(path, doc, lock)
    if args.engine == "port" and args.fill_unanswered:
        ref = tc.load(args.ref)
        for k in sorted(only):
            got = doc["queries"][k]
            if "error" in ref["queries"][k] and "error" not in got:
                ref["queries"][k]["port_cpu"] = got
                print(f"{k}: the port CPU Session's {got['rows']} rows "
                      f"kept in {args.ref}")
        _write(args.ref, ref, lock)
    if args.engine == "port":
        return 1 if compare(doc, tc.load(args.ref)) else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
