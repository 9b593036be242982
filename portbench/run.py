"""Run one cell of the port's benchmark once and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this
``portbench/`` and the program (``trino_tpu_torch/``). One run:

1. set-up: generates the cell's configuration on the card from the seed
   (``gen/``), hands host copies to the program (``port.py``), starts
   the program's coordinator on 127.0.0.1 with no workers, and sends
   each template twice through the statement protocol (the first run in
   a checkout builds the program's kernels then);
2. the window: the workload's streams send their queries in a closed
   loop for ``--seconds``; queries in flight at the close are waited for
   and counted, and the window ends with the last of them;
3. the check: the coordinator stops and the program's device memory is
   freed; a sample of the window's answers, drawn from the seed, is
   compared with the plain reference (``reference/``) on the card.

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics
in ``BENCHMARK.json``; with ``--trace 1`` the window runs under
torch.profiler and the metrics are the cell's per-layer metrics, each
read by ``metrics/<name>.py``. The last line of standard output is one
JSON object; the numbers compared, each beside its limit, are the last
lines of standard error and the result's last key. The exit code is 0
when the run is correct, 1 when it is not, 2 when it could not run.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import shutil
import statistics
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "trino_tpu")
# each number compared, with its limit (PERF.md gives the readings)
LIMITS = {"wrong_answers": 0, "failed_queries": 0}
WARM_PASSES = 2


def process_start() -> float:
    """This process's start on time.monotonic()'s clock (Linux), else
    the import of this module."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        age = up - ticks / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.monotonic()


@dataclass
class QueryRecord:
    stream: str
    index: int
    template: str
    params: dict
    t_submit: float
    t_done: float = 0.0
    elapsed_ms: int = 0
    rows: Optional[list] = None
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None

    @property
    def wall_s(self) -> float:
        return self.t_done - self.t_submit


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def metrics_for(bench: dict, cell: str, kind: str) -> List[dict]:
    return [m for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def load_reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile, linear between the closest ranks."""
    vs = sorted(values)
    if len(vs) == 1:
        return vs[0]
    pos = (len(vs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(vs) - 1)
    return vs[lo] + (vs[hi] - vs[lo]) * (pos - lo)


def send(base: str, q, span=None) -> QueryRecord:
    """One query to its last page. Whatever goes wrong on the way (a
    failed query, the connection, a malformed page) is the query's
    error, so every query of the window leaves a record."""
    from .client import run
    rec = QueryRecord(q.stream, q.index, q.template, q.params,
                      time.monotonic())
    try:
        ans = run(base, q.sql, span=span)
        rec.rows, rec.elapsed_ms = ans.rows, ans.elapsed_ms
    except Exception as e:
        rec.error = f"{type(e).__name__}: {e}"[:2000]
    rec.t_done = time.monotonic()
    return rec


def window(base: str, traffic, streams: int, seconds: float,
           span=None) -> List[QueryRecord]:
    """Closed loop: each stream sends its next query when the last one
    ends, until the close; the window's queries in submission order."""
    end = time.monotonic() + seconds
    out: List[List[QueryRecord]] = [[] for _ in range(streams)]

    def stream(s: int) -> None:
        i = 0
        while time.monotonic() < end:
            out[s].append(send(base, traffic.query(str(s), i), span))
            i += 1

    threads = [threading.Thread(target=stream, args=(s,),
                                name=f"portbench-stream-{s}")
               for s in range(streams)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return sorted((r for rs in out for r in rs), key=lambda r: r.t_submit)


def sample(records: List[QueryRecord], per_template: int, seed: int):
    """Per template, its slowest answered query and others drawn from the
    seed, up to `per_template`."""
    import numpy as np
    rng = np.random.default_rng([int(seed), 7])
    by_t: Dict[str, List[QueryRecord]] = {}
    for r in records:
        if r.ok:
            by_t.setdefault(r.template, []).append(r)
    picked = []
    for name in sorted(by_t):
        rs = by_t[name]
        slowest = max(range(len(rs)), key=lambda i: rs[i].wall_s)
        rest = [i for i in range(len(rs)) if i != slowest]
        extra = rng.permutation(len(rest))[:max(0, per_template - 1)]
        picked += [rs[slowest]] + [rs[rest[int(i)]] for i in extra]
    return picked


def check(records, picked, traffic, tables, device, control=None):
    """Each picked answer against the plain reference; returns the
    compared numbers and the first few differences. With `control` (an
    arithmetic of ``reference.common.ARITH``), the reference computed in
    it is put in the program's place: its rows, sent as the protocol
    sends them, are judged instead of the program's."""
    from . import compare
    from .reference.common import EXACT
    on_dev = {name: t.to(device) for name, t in tables.items()}
    wrong, notes = 0, []
    for r in picked:
        ref = importlib.import_module(
            f"portbench.reference.{traffic.bench}.{r.template}")
        spec = traffic.templates[r.template][1]
        want = ref.answer(on_dev, r.params, EXACT)
        got = r.rows if control is None else compare.as_sent(
            spec, ref.answer(on_dev, r.params, control))
        bad = compare.differs(spec, got, want)
        if bad is not None:
            wrong += 1
            if len(notes) < 5:
                notes.append(f"{r.template} stream {r.stream} query "
                             f"{r.index} {r.params}: {bad}")
    failed = sum(1 for r in records if not r.ok)
    for r in records:
        if not r.ok and len(notes) < 10:
            notes.append(f"{r.template} stream {r.stream} query {r.index} "
                         f"failed: {r.error[:300]}")
    return {"wrong_answers": wrong, "failed_queries": failed,
            "compared": len(picked)}, notes


def host_cpu() -> Dict[str, float]:
    """This process's CPU seconds so far, user and system."""
    t = os.times()
    return {"process_user": t.user, "process_system": t.system}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", rows: Optional[dict] = None,
             t_start: Optional[float] = None,
             controls: Sequence[str] = ()) -> dict:
    """One run of a cell; returns the result line as a dict. `rows`
    replaces the configuration's row counts (the tests' small sizes).
    Each of `controls` (``python -m portbench.control``) judges the same
    sample again with that control in the program's place, under the
    result's key "controls"."""
    import torch

    from . import port
    from .traffic import Traffic, load_json

    t_start = process_start() if t_start is None else t_start
    bench = load_benchmark()
    wl = load_json("workloads", workload + ".json")
    config = load_json("configs", wl["config"] + ".json")
    if rows is not None:
        config = {**config, "rows": rows}
    traffic = Traffic(wl, seed)
    # the program's data cache and decision file live in this run alone
    cache = tempfile.mkdtemp(prefix="portbench-datacache-")
    saved_cache = os.environ.get("TRINO_TPU_DATA_CACHE")
    os.environ["TRINO_TPU_DATA_CACHE"] = cache
    try:
        gen = importlib.import_module(f"portbench.gen.{config['generator']}")
        made = gen.generate(config, seed, device)
        if device != "cpu":
            torch.cuda.synchronize()
        tables = {name: t.to("cpu") for name, t in made.items()}
        del made
        host = {name: {c: v.numpy() for c, v in t.columns.items()}
                for name, t in tables.items()}
        log(f"generated {sum(t.num_rows for t in tables.values())} rows "
            f"in {time.monotonic() - t_start:.1f} s since start")
        if device != "cpu":
            torch.cuda.empty_cache()
        session, server = port.start(config, tables, host, device)
        spans = None
        if trace:
            from .trace import Spans
            spans = Spans()
            spans.install()
        try:
            warm = len(wl["templates"]) * WARM_PASSES
            for i in range(warm):
                r = send(server.uri, traffic.query("warm", i))
                log(f"warm-up {r.template}: {r.wall_s * 1e3:.1f} ms"
                    f"{'' if r.ok else ' FAILED ' + r.error[:300]}")
            if device != "cpu":
                torch.cuda.synchronize()
            setup_s = time.monotonic() - t_start
            log(f"set-up {setup_s:.3f} s; window of {seconds} s, "
                f"{wl['streams']} streams")
            reading = None
            cpu0 = host_cpu()
            if trace:
                from .trace import Reading, profiled, reduce
                spans.recording = True
                with profiled(device) as prof:
                    with spans.span("pb:window"):
                        records = window(server.uri, traffic, wl["streams"],
                                         seconds, span=spans.span)
                spans.recording = False
                reading = reduce(prof, spans, Reading(workload, records))
                del prof
            else:
                records = window(server.uri, traffic, wl["streams"], seconds)
            cpu = {k: v - cpu0[k] for k, v in host_cpu().items()}
            w0 = records[0].t_submit
            window_s = max(r.t_done for r in records) - w0
            peak = (int(torch.cuda.max_memory_allocated())
                    if device != "cpu" else 0)
        finally:
            if spans is not None:
                spans.uninstall()
            server.stop()
            session.executor.release_device_caches()
            del session, server
            gc.collect()
            if device != "cpu":
                torch.cuda.empty_cache()
        found = forbidden_modules()
        if found:
            raise ForbiddenImport(found)
        picked = sample(records, wl["sample_per_template"], seed)
        t_check = time.monotonic()
        numbers, notes = check(records, picked, traffic, tables, device)
        check_s = time.monotonic() - t_check
        if controls:
            from .reference.common import ARITH
            judged = {}
            for name in controls:
                c, _ = check(records, picked, traffic, tables, device,
                             control=ARITH[name])
                judged[name] = {**c, "correct": all(
                    c[k] <= LIMITS[k] for k in LIMITS)}
    finally:
        shutil.rmtree(cache, ignore_errors=True)
        if saved_cache is None:
            os.environ.pop("TRINO_TPU_DATA_CACHE", None)
        else:
            os.environ["TRINO_TPU_DATA_CACHE"] = saved_cache

    answered = [r for r in records if r.ok]
    metrics: Dict[str, dict] = {}
    if not trace:
        values = {"setup_s": setup_s, "qps": len(answered) / window_s}
        for m in metrics_for(bench, workload, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in metrics_for(bench, workload, "per_layer"):
            v = load_reader(m["name"])(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": all(numbers[k] <= LIMITS[k] for k in LIMITS),
           "attempted": len(records),
           "failed": len(records) - len(answered),
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = reading.busy_s
        dev["window_s"] = reading.window_s
        out["breakdown"] = {
            "device_ops": [[n[:120], s] for n, s in reading.device_ops],
            "idle_gaps": [[n, s] for n, s in reading.idle_gaps]}
    by_template: Dict[str, List[float]] = {}
    for r in answered:
        by_template.setdefault(r.template, []).append(r.wall_s * 1e3)
    log("window: " + json.dumps({
        "queries": len(records), "answered": len(answered),
        "window_s": window_s, "check_s": check_s,
        "median_ms_by_template": {k: statistics.median(v)
                                  for k, v in sorted(by_template.items())},
        "host_cpu_s": cpu,
        "launches": reading.launches if reading else None,
        "reduce_s": reading.span_s.get("reduce_s") if reading else None}))
    for n in notes:
        log("differs: " + n)
    log(f"compared {numbers['compared']} answers with the reference")
    if controls:
        out["controls"] = judged
    out["correctness"] = {k: {"value": numbers[k], "limit": LIMITS[k]}
                          for k in LIMITS}
    return out


class ForbiddenImport(RuntimeError):
    pass


def main(argv=None) -> int:
    t_start = process_start()
    p = argparse.ArgumentParser(prog="python -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    import torch
    bench = load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if a.workload not in cells:
        log(f"no workload {a.workload!r} in BENCHMARK.json")
        return 2
    need = cells[a.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"needs {need} CUDA device(s); "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}")
        return 2
    try:
        out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                       t_start=t_start)
    except ForbiddenImport as e:
        log(f"modules loaded that the benchmark forbids: {e}")
        return 2
    for name, v in out["correctness"].items():
        log(f"compared {name} = {v['value']} (limit {v['limit']})")
    print(json.dumps(out), flush=True)
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
