"""The history-based regression gate over measurement rounds.

The JAX package's harness (``bench.py --check-regressions``) diffs the
newest round of each series of records against the earlier rounds of
the same series, with the rule the query-history detector applies
(``server/history.py``: past ``median * RATIO`` and outside the MAD
envelope). This module is that gate for the port's records, with the
reference's parser, report and series:

- ``BENCH_r*.json``: the end-to-end configurations (``e2e.py``), one
  series per configuration;
- ``BENCH_agg_micro*``, ``BENCH_star_micro*``, ``BENCH_scan_micro*``
  (``micro.py``), ``BENCH_soak*``, ``BENCH_write_chaos*``,
  ``BENCH_overload*``, ``BENCH_coordinator_chaos*`` (``soak.py``),
  ``BENCH_cold*`` (``coldstart.py``) and ``MULTICHIP_r*``, each gated as
  a series of its own.

A round file is either a runner's format (``{"n", "cmd", "rc",
"tail"}``, the last parseable JSON line of ``tail`` wins) or a record as
a mode prints it. The end-to-end series reads ``detail[cfg]["steady_ms"]``,
the key ``e2e.run_e2e`` writes (the reference's records say
``tpu_steady_ms``).

The rounds are read from a directory the caller names; nothing is read
from or written to the repository's root, whose rounds are the TPU's:

    python -m trino_tpu_torch.regressions --rounds-dir DIR
        [--rounds-glob 'BENCH_r*.json'] [--ratio R] [--mad-k K]

prints one JSON report and exits 1 when a series regressed, else 0.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from .server.history import MAD_K, RATIO, is_regressed, robust_baseline

# the series gated beside the main rounds, in the reference's order:
# (the report's key, the glob of its round files)
SERIES = (
    ("agg_micro", "BENCH_agg_micro*.json"),
    ("star_micro", "BENCH_star_micro*.json"),
    ("scan_micro", "BENCH_scan_micro*.json"),
    ("soak", "BENCH_soak*.json"),
    ("write_chaos", "BENCH_write_chaos*.json"),
    ("overload", "BENCH_overload*.json"),
    ("coordinator_chaos", "BENCH_coordinator_chaos*.json"),
    ("cold_start", "BENCH_cold*.json"),
    ("multichip", "MULTICHIP_r*.json"),
)


def _last_record(doc):
    """A runner's format carries the emitted lines in `tail`: the last
    line that parses is the round's record."""
    if isinstance(doc, dict) and "tail" in doc:
        recs = []
        for line in doc["tail"].splitlines():
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                recs.append(json.loads(line))
            except ValueError:
                continue              # torn tail line
        doc = recs[-1] if recs else None
    return doc if isinstance(doc, dict) else None


def _scan_micro(doc):
    # the pruned-scan walls per selectivity and the two prefetch walls
    out = {}
    for r in doc.get("records", ()):
        ms = r.get("prune_on_ms")
        if ms is not None:
            out[f"scan_micro_sel{r['selectivity']}"] = float(ms)
    for depth, d in (doc.get("prefetch") or {}).items():
        if isinstance(d, dict) and "wall_ms" in d:
            out[f"scan_micro_prefetch_{depth}"] = float(d["wall_ms"])
    return out


def _soak(doc):
    # per-tenant p99s, and the throughput inverted into a wall
    out = {}
    for tname, d in (doc.get("tenants") or {}).items():
        if isinstance(d, dict) and "p99_ms" in d:
            out[f"soak_{tname}_p99"] = float(d["p99_ms"])
    qps = doc.get("throughput_qps")
    if qps:
        out["soak_ms_per_query"] = 1000.0 / float(qps)
    return out


def _write_chaos(doc):
    # the commit walls per chaos point
    out = {}
    for point, d in (doc.get("points") or {}).items():
        if isinstance(d, dict) and "p50_ms" in d:
            out[f"write_chaos_{point.lower()}_p50"] = float(d["p50_ms"])
    return out


def _overload(doc):
    # the enforcement latencies
    out = {}
    for key, cfg in (("cancel_terminal_p50_ms", "overload_cancel_p50"),
                     ("cancel_terminal_max_ms", "overload_cancel_max"),
                     ("deadline_overshoot_p50_ms",
                      "overload_deadline_overshoot_p50")):
        if doc.get(key) is not None:
            out[cfg] = float(doc[key])
    return out


def _coordinator_chaos(doc):
    # the failover-to-first-result walls
    out = {}
    for pct in ("p50", "p99"):
        ms = doc.get(f"failover_to_result_{pct}_ms")
        if ms is not None:
            out[f"coordinator_chaos_failover_{pct}"] = float(ms)
    return out


def _cold_start(doc):
    # the fresh-process cold wall and the cold/steady ratio per query
    out = {}
    for r in doc.get("records", ()):
        if r.get("cold_ms") is not None:
            out[f"cold_{r['query']}"] = float(r["cold_ms"])
        if r.get("ratio") is not None:
            out[f"cold_{r['query']}_ratio"] = float(r["ratio"])
    return out


def _star_micro(doc):
    # both walls per star shape
    out = {}
    for r in doc.get("records", ()):
        tag = f"star_micro_k{r['dims']}_h{r['hit_rate']}"
        if r.get("fused_ms") is not None:
            out[f"{tag}_fused"] = float(r["fused_ms"])
        if r.get("pairwise_ms") is not None:
            out[f"{tag}_pairwise"] = float(r["pairwise_ms"])
    return out


def _agg_micro(doc):
    # the strategy the gate would pick: hash where present, else sort
    out = {}
    for r in doc.get("records", ()):
        ms = r.get("hash_ms", r.get("sort_ms"))
        if ms is not None:
            out[f"agg_micro_g{r['groups']}"] = float(ms)
    return out


# (how the record's metric is matched, the metric, its parser), in the
# reference's order of tests
_PARSERS = (
    (str.startswith, "scan_micro", _scan_micro),
    (str.__eq__, "soak", _soak),
    (str.__eq__, "write_chaos", _write_chaos),
    (str.__eq__, "overload", _overload),
    (str.__eq__, "coordinator_chaos", _coordinator_chaos),
    (str.__eq__, "cold_start", _cold_start),
    (str.startswith, "star_micro", _star_micro),
    (str.startswith, "agg_micro", _agg_micro),
)


def load_bench_round(path):
    """One round's per-config walls: ``{config: ms}``, or None when the
    file does not parse or holds no usable record (a round killed
    before its first line)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return parse_round(doc)


def parse_round(doc):
    """`load_bench_round` of a round already loaded from its JSON."""
    doc = _last_record(doc)
    if doc is None:
        return None
    metric = str(doc.get("metric", ""))
    for match, name, parse in _PARSERS:
        if match(metric, name):
            return parse(doc) or None
    detail = doc.get("detail", doc)
    out = {}
    for cfg, d in detail.items():
        if isinstance(d, dict) and "steady_ms" in d:
            out[cfg] = float(d["steady_ms"])
    return out or None


def check_regressions(paths, ratio=None, mad_k=None, min_prior=2):
    """Diff the last of `paths` (in order) against the earlier rounds'
    per-config baselines: a config regresses when its wall exceeds
    median * ratio AND the robust MAD envelope. Returns (ok, report);
    configs with fewer than `min_prior` baseline rounds are reported
    but never judged."""
    ratio = RATIO if ratio is None else ratio
    mad_k = MAD_K if mad_k is None else mad_k
    rounds = [(p, load_bench_round(p)) for p in paths]
    rounds = [(p, r) for p, r in rounds if r]
    report = {"metric": "bench_regression_check", "rounds": len(rounds),
              "configs": {}, "regressions": []}
    if len(rounds) < 2:
        report["note"] = "need at least 2 parseable rounds to compare"
        return True, report
    latest_path, latest = rounds[-1]
    report["latest"] = latest_path
    for cfg, cur in sorted(latest.items()):
        prior = [r[cfg] for _, r in rounds[:-1] if cfg in r]
        entry = {"steady_ms": cur, "baseline_rounds": len(prior)}
        if len(prior) < min_prior:
            entry["status"] = "insufficient-baseline"
        else:
            med, mad = robust_baseline(prior)
            entry["baseline_median_ms"] = round(med, 1)
            entry["baseline_mad_ms"] = round(mad, 1)
            if is_regressed(cur, med, mad, ratio=ratio, mad_k=mad_k):
                entry["status"] = "REGRESSED"
                report["regressions"].append(cfg)
            else:
                entry["status"] = "ok"
        report["configs"][cfg] = entry
    return not report["regressions"], report


def check_rounds_dir(rounds_dir, ratio=None, mad_k=None,
                     rounds_glob="BENCH_r*.json"):
    """The whole gate over one directory: the main rounds
    (`rounds_glob`), then each series of SERIES that has files there,
    its report under its key. Returns (ok, report)."""
    def paths(pattern):
        return sorted(glob.glob(os.path.join(rounds_dir, pattern)))

    ok, report = check_regressions(paths(rounds_glob), ratio=ratio,
                                   mad_k=mad_k)
    for key, pattern in SERIES:
        found = paths(pattern)
        if found:
            ok_s, report[key] = check_regressions(found, ratio=ratio,
                                                  mad_k=mad_k)
            ok = ok and ok_s
    return ok, report


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m trino_tpu_torch.regressions",
        description="gate the newest round of each series in a directory "
                    "against its earlier rounds (median + MAD); exit 1 on "
                    "a regression")
    p.add_argument("--rounds-dir", required=True,
                   help="directory holding the round files")
    p.add_argument("--rounds-glob", default="BENCH_r*.json",
                   help="the main rounds, inside --rounds-dir "
                        "(default: BENCH_r*.json)")
    p.add_argument("--ratio", type=float, default=None,
                   help=f"ratio gate (default: {RATIO})")
    p.add_argument("--mad-k", type=float, default=None,
                   help=f"MAD envelope multiplier (default: {MAD_K})")
    return p


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    ok, report = check_rounds_dir(a.rounds_dir, ratio=a.ratio,
                                  mad_k=a.mad_k, rounds_glob=a.rounds_glob)
    print(json.dumps(report), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
