"""Interactive SQL CLI.

Port of ``trino_tpu/client/cli.py`` (client/trino-cli, Console.java:87):
a line-oriented REPL that submits statements and renders aligned result
tables. `python -m trino_tpu_torch.client.cli [--server URI]`; with no
--server it boots an in-process engine, ``Session()``, on the card.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


class ProgressLine:
    """Carriage-return progress line rendered from each polled page's
    stats: `[=====>      ]  52% RUNNING partitioned`. Monotonic — the
    shown ratio never moves backward even if a poll races a failover's
    progress re-derivation — and cleared before the result table so
    piped output never contains it."""

    WIDTH = 24

    def __init__(self, out=None):
        self.out = out if out is not None else sys.stderr
        self.ratio = 0.0
        self.visible = False

    def update(self, stats: dict) -> None:
        r = float(stats.get("progressRatio", 0.0) or 0.0)
        if stats.get("state") == "FINISHED":
            r = 1.0
        self.ratio = max(self.ratio, min(1.0, r))
        filled = int(self.ratio * self.WIDTH)
        bar = "=" * filled + (">" if filled < self.WIDTH else "")
        stage = stats.get("stage") or ""
        line = (f"[{bar:<{self.WIDTH}}] {100 * self.ratio:3.0f}% "
                f"{stats.get('state', '')} {stage}")
        self.out.write("\r" + line[:79].ljust(79))
        self.out.flush()
        self.visible = True

    def clear(self) -> None:
        if self.visible:
            self.out.write("\r" + " " * 79 + "\r")
            self.out.flush()
        self.visible = False
        self.ratio = 0.0


def progress_enabled(mode: str, out=None) -> bool:
    """Resolve --progress: 'always'/'never' are explicit; 'auto' turns
    the line on only for real interactive terminals — piped output and
    dumb terminals (no carriage-return rendering) stay clean."""
    if mode == "always":
        return True
    if mode == "never":
        return False
    out = out if out is not None else sys.stderr
    return bool(getattr(out, "isatty", lambda: False)()) and \
        os.environ.get("TERM", "") != "dumb"


def render_table(columns, rows, out=None) -> None:
    """Aligned ASCII table (the CLI's ALIGNED output format)."""
    out = out if out is not None else sys.stdout
    cells = [[("NULL" if v is None else str(v)) for v in r] for r in rows]
    widths = [len(c) for c in columns]
    for r in cells:
        for i, v in enumerate(r):
            widths[i] = max(widths[i], len(v))
    sep = "-+-".join("-" * w for w in widths)
    out.write(" | ".join(c.ljust(w) for c, w in zip(columns, widths))
              + "\n")
    out.write(sep + "\n")
    for r in cells:
        out.write(" | ".join(v.ljust(w) for v, w in zip(r, widths)) + "\n")
    out.write(f"({len(rows)} row{'s' if len(rows) != 1 else ''})\n")


class LocalBackend:
    """In-process engine (no server), on the card unless `device` names
    another torch device (the CPU tests pass "cpu")."""

    def __init__(self, schema: str = "tiny",
                 timeout_s: float = 0.0, device=None):
        from ..exec.session import Session
        self.session = Session(default_schema=schema, device=device)
        if timeout_s > 0:
            # --timeout maps onto the engine's own deadline property so
            # local and remote modes bound queries the same way
            self.session.execute(
                f"SET SESSION query_max_run_time_s = {timeout_s}")

    def execute(self, sql: str):
        r = self.session.execute(sql)
        return r.column_names, r.rows


class RemoteBackend:
    def __init__(self, uri: str, user: str, progress: bool = False,
                 timeout_s: float = 0.0):
        from .client import Client
        self.progress_line = ProgressLine() if progress else None
        # --server accepts a comma-separated coordinator list; polling
        # fails over across it (client.py)
        self.client = Client(
            uri, user=user,
            on_progress=(self.progress_line.update
                         if self.progress_line is not None else None))
        self.last_failovers = 0
        if timeout_s > 0:
            # server-side deadline: the coordinator stamps it at
            # admission and enforces it end-to-end (workers included) —
            # strictly stronger than a client-side poll timeout
            self.client.execute(
                f"SET SESSION query_max_run_time_s = {timeout_s}")

    def execute(self, sql: str):
        try:
            r = self.client.execute(sql)
        finally:
            # the line must be gone before the table (or the error)
            # renders, success or not
            if self.progress_line is not None:
                self.progress_line.clear()
        self.last_failovers = r.failovers
        return r.columns, r.rows


def repl(backend, inp=sys.stdin, out=sys.stdout) -> None:
    buf = []
    prompt = "trino-tpu> "
    cont = "        -> "
    while True:
        out.write(prompt if not buf else cont)
        out.flush()
        line = inp.readline()
        if not line:
            break
        line = line.rstrip("\n")
        if not buf and line.strip().lower() in ("quit", "exit", "quit;",
                                                "exit;"):
            break
        if not line.strip():
            continue
        buf.append(line)
        if not line.rstrip().endswith(";"):
            continue
        sql = "\n".join(buf).rstrip().rstrip(";")
        buf = []
        t0 = time.monotonic()
        try:
            columns, rows = backend.execute(sql)
        except KeyboardInterrupt:
            # the client already sent the server-side DELETE before
            # re-raising (client.py); keep the REPL alive
            out.write("Query canceled.\n")
            continue
        except Exception as e:           # noqa: BLE001 — REPL boundary
            out.write(f"Query failed: {e}\n")
            continue
        render_table(columns, rows, out)
        summary = f"Elapsed: {time.monotonic() - t0:.2f}s"
        fo = getattr(backend, "last_failovers", 0)
        if fo:
            # the query crossed coordinators mid-flight and still
            # finished — worth telling the operator at the prompt
            summary += f"  Failovers: {fo}"
        out.write(summary + "\n\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="trino-tpu-cli")
    ap.add_argument("--server", help="coordinator URI (default: in-process)")
    ap.add_argument("--user", default="cli")
    ap.add_argument("--schema", default="tiny",
                    help="tpch schema for in-process mode")
    ap.add_argument("--execute", "-e", help="run one statement and exit")
    ap.add_argument("--progress", choices=("auto", "always", "never"),
                    default="auto",
                    help="live progress line while a remote query runs "
                         "(auto: only on interactive terminals)")
    ap.add_argument("--timeout", type=float, default=0.0,
                    help="per-query run-time budget in seconds (maps to "
                         "SET SESSION query_max_run_time_s; the server "
                         "enforces it end-to-end)")
    args = ap.parse_args(argv)
    # local execution is synchronous — there is nothing to poll, so the
    # progress line only ever applies to --server mode
    backend = RemoteBackend(args.server, args.user,
                            progress=progress_enabled(args.progress),
                            timeout_s=args.timeout) \
        if args.server else LocalBackend(args.schema,
                                         timeout_s=args.timeout)
    if args.execute:
        try:
            columns, rows = backend.execute(args.execute.rstrip(";"))
        except KeyboardInterrupt:
            # client.py already DELETEd the server-side query
            sys.stderr.write("Query canceled.\n")
            return 130
        render_table(columns, rows)
        fo = getattr(backend, "last_failovers", 0)
        if fo:
            sys.stdout.write(f"Failovers: {fo}\n")
        return 0
    repl(backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
