"""The kernel micro-benchmarks: each kernel path at isolated shapes against
what it replaces.

The JAX package's harness (``bench.py``) has four micro modes; this
module is each of them for the port, with the reference's names,
defaults, shapes, seeds and record keys:

- ``gather_micro``: K1 (``ops/gather.gather_columns``) over 3 tables,
  and K2 (``gather_word_windowed``) on one table's word planes over the
  sorted probes, against ``torch.index_select`` once per table (the
  counterpart of the reference's ``jnp.take``), in ns per gathered
  element;
- ``agg_micro``: the sort (``ops/aggregate.sort_group_aggregate``),
  direct (``direct_group_aggregate``, 64 groups or fewer) and hash (K3,
  ``ops/hashtable.hash_group_aggregate``, timed only when nothing
  escaped and the table fits its cap) strategies across group counts;
- ``star_micro``: a synthetic star through the Session, the fused
  multiway probe (K4, ``enable_multiway_join = 'true'``) against the
  pairwise join ladder (``'false'``), across star widths and hit rates;
- ``scan_micro``: zone-map pruning on against off across selectivities,
  the read-level decode of the same table written as multi-stripe zlib
  ORC and multi-row-group Parquet, and the chunked path's prefetch at
  depth 0 against depth 2.

A wall is the minimum of `runs` calls after one warm call, each closed
by ``torch.cuda.synchronize()``. On the CPU (``device="cpu"``) the
kernels run their plain versions and the shapes drop to a smoke size:
the walls mean nothing there (``"smoke"`` says so), the counts and
equalities do. Each record also carries the card's name and power
limit, the kernel launches the mode made and whether each arm agreed
with the one it replaces.

A record is printed, and written only where ``out_path`` (``--out``)
says; the Session's decision file goes under ``$TRINO_TPU_DATA_CACHE``
if set, else a temporary directory removed at the end.

    python -m trino_tpu_torch.micro {gather,agg,star,scan,all}
        [--out DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from . import e2e

SCAN_SELECTIVITIES = (0.0001, 0.01, 0.5, 1.0)
MODES = ("gather", "agg", "star", "scan")


def _sync(dev) -> None:
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def _timed(fn, dev, runs):
    """One warm call, then the minimum of `runs` walls in seconds; returns
    (seconds, the last call's result)."""
    out = fn()
    _sync(dev)
    walls = []
    for _ in range(runs):
        t0 = time.monotonic()
        out = fn()
        _sync(dev)
        walls.append(time.monotonic() - t0)
    return min(walls), out


def _header(metric, dev, launches0) -> dict:
    after = e2e._launches()
    return {"metric": metric, "device": str(dev),
            "mode": "device" if dev.type == "cuda" else "cpu",
            "smoke": dev.type != "cuda",
            **{k: v for k, v in e2e.card_facts(dev).items()
               if k in ("card", "power_limit")},
            "launches": {k: after[k] - launches0[k] for k in after}}


def _finish(out: dict, out_path) -> dict:
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    return out


# ---------------------------------------------------------------------------
# gather: K1 and K2 against index_select
# ---------------------------------------------------------------------------

def gather_micro(table_sizes=None, probe_rows=None, n_tables=3, runs=3,
                 out_path=None, device="cuda"):
    """ns per gathered element of K1 (``kind: scan``, `n_tables` int64
    tables of each size) and of K2 (``kind: windowed``, the first table's
    word planes over the sorted probes), beside ``index_select`` once per
    table (``take_ns_per_elem``). Card: tables of 4,096, 16,384 and
    65,536 rows, 2^22 probes; CPU: 4,096 rows, 2^13 probes. Seed 7, the
    reference's draws in its order."""
    import torch

    from .ops import gather as k1
    dev = e2e._resolve(device)
    on_card = dev.type == "cuda"
    if table_sizes is None:
        table_sizes = [1 << 12, 1 << 14, 1 << 16] if on_card else [1 << 12]
    if probe_rows is None:
        probe_rows = (1 << 22) if on_card else (1 << 13)
    rng = np.random.default_rng(7)
    launches0 = e2e._launches()
    records = []
    for w in table_sizes:
        tables = [torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, w))
                  .to(dev) for _ in range(n_tables)]
        idx = torch.from_numpy(rng.integers(0, w, probe_rows)).to(dev)
        t_take, want = _timed(
            lambda: [torch.index_select(t, 0, idx) for t in tables], dev,
            runs)
        t_kernel, got = _timed(lambda: k1.gather_columns(tables, idx), dev,
                               runs)
        err = max(int((a - b).abs().max()) if a.numel() else 0
                  for a, b in zip(got, want))
        elems = probe_rows * n_tables
        records.append({
            "table_rows": w, "probe_rows": probe_rows, "n_tables": n_tables,
            "take_ns_per_elem": t_take * 1e9 / elems,
            "kernel_ns_per_elem": t_kernel * 1e9 / elems,
            "kind": "scan", "library": "index_select",
            "max_abs_err": err})

        # K2 on near-sorted indices (the chunked fact scan's shape)
        idx_s = torch.sort(idx).values
        planes = k1.prepare_word_planes(tables[0])
        t_win, (words, esc) = _timed(
            lambda: k1.gather_word_windowed(planes, idx_s, "int64"), dev,
            runs)
        p_words, p_esc = k1.gather_word_windowed_plain(planes, idx_s,
                                                       "int64")
        records.append({
            "table_rows": w, "probe_rows": probe_rows, "n_tables": 1,
            "take_ns_per_elem": t_take * 1e9 / elems,
            "kernel_ns_per_elem": t_win * 1e9 / probe_rows,
            "kind": "windowed", "library": "index_select",
            "escaped": int(esc),
            "equal_plain": bool(torch.equal(words, p_words)) and
            int(esc) == int(p_esc)})
        del tables, idx, idx_s, planes, got, want, words
        e2e._release(dev)
    out = {**_header("gather_micro_ns_per_elem", dev, launches0),
           "records": records}
    return _finish(out, out_path)


# ---------------------------------------------------------------------------
# agg: sort against direct against hash (K3)
# ---------------------------------------------------------------------------

def _group_arrays(batch):
    """An aggregate's live groups as host columns ordered by the key
    (keys are unique, so equal arrays mean equal multisets of groups)."""
    from .batch import batch_to_numpy
    arrays, valids = batch_to_numpy(batch)
    order = np.argsort(arrays[0], kind="stable")
    return [a[order] for a in arrays] + [v[order] for v in valids]


def _same_groups(a, b) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


def agg_micro(cardinalities=None, rows=None, runs=3, out_path=None,
              device="cuda"):
    """ms of each aggregation strategy over `rows` rows of (key, int64
    value), sum and count(*) per key, at each group count. Card: 10^2 to
    10^7 groups over 2^24 rows; CPU: 16 and 256 groups over 2^12 rows.
    Seed 11. ``arms_agree``: every arm that ran returned the sort arm's
    groups."""
    from .batch import batch_from_numpy
    from .ops import hashtable as ht
    from .ops.aggregate import (AggSpec, direct_group_aggregate,
                                key_pack_plan, sort_group_aggregate)
    dev = e2e._resolve(device)
    on_card = dev.type == "cuda"
    if cardinalities is None:
        cardinalities = [100, 1000, 10_000, 100_000, 1_000_000,
                         10_000_000] if on_card else [16, 256]
    if rows is None:
        rows = (1 << 24) if on_card else (1 << 12)
    rng = np.random.default_rng(11)
    launches0 = e2e._launches()
    records = []
    aggs = (AggSpec("sum", 1), AggSpec("count_star", None))
    for groups in cardinalities:
        keys = rng.integers(0, groups, rows)
        vals = rng.integers(-(1 << 40), 1 << 40, rows)
        batch = batch_from_numpy([keys, vals], device=dev)
        cap = 1 << max(10, int(1.3 * groups).bit_length())
        rec = {"groups": groups, "rows": rows}

        t, out = _timed(lambda: sort_group_aggregate(
            batch, (0,), aggs, min(cap, len(keys) or 1)), dev, runs)
        rec["sort_ms"] = t * 1000
        want = _group_arrays(out)
        agree = True
        if groups <= 64:
            t, out = _timed(lambda: direct_group_aggregate(
                batch, (0,), (groups,), aggs), dev, runs)
            rec["direct_ms"] = t * 1000
            agree = agree and _same_groups(want, _group_arrays(out))
        plan = key_pack_plan(batch, (0,))
        if plan is not None:
            kmins, bits = plan
            slots, fits = ht.pick_table_slots(groups, aggs)
            first = ht.hash_group_aggregate(batch, kmins, (0,), bits, aggs,
                                            slots)
            esc = int(first[1])
            rec["hash_table_slots"] = slots
            rec["hash_escapes"] = esc
            if esc == 0:
                agree = agree and _same_groups(want,
                                               _group_arrays(first[0]))
            del first
            if esc == 0 and fits:
                t, _ = _timed(lambda: ht.hash_group_aggregate(
                    batch, kmins, (0,), bits, aggs, slots), dev, runs)
                rec["hash_ms"] = t * 1000
                rec["hash_vs_sort"] = \
                    rec["sort_ms"] / max(rec["hash_ms"], 1e-6)
        rec["arms_agree"] = agree
        records.append(rec)
        del batch, out, want, keys, vals
        e2e._release(dev)
    out = {**_header("agg_micro_ms", dev, launches0), "records": records}
    return _finish(out, out_path)


# ---------------------------------------------------------------------------
# star: the fused multiway probe (K4) against the pairwise ladder
# ---------------------------------------------------------------------------

def _star_tables(k, fact_rows, dim_rows, hit_rate, seed=40231):
    """Synthetic star: one fact with k FK columns + a value, k unique-
    keyed dims each carrying one payload column. `hit_rate` sets the
    per-dim probe match fraction (fact keys drawn past the dim's key
    range miss, so the inner join drops 1-hit_rate of rows per hop).
    The reference's draws in its order: the same arrays for one seed."""
    from .batch import Field, Schema
    from .connectors.tpch.datagen import TableData
    from .types import BIGINT
    rng = np.random.default_rng(seed + k)
    t = {}
    span = max(1, int(dim_rows / max(hit_rate, 1e-9)))
    fact_cols = [rng.integers(0, span, fact_rows).astype(np.int64)
                 for _ in range(k)]
    fact_cols.append(rng.integers(0, 1 << 20, fact_rows).astype(np.int64))
    t["fact"] = TableData(
        "fact",
        Schema.of(*[Field(f"f_d{i}key", BIGINT) for i in range(k)],
                  Field("f_value", BIGINT)),
        fact_cols)
    for i in range(k):
        t[f"dim{i}"] = TableData(
            f"dim{i}",
            Schema.of(Field(f"d{i}_key", BIGINT),
                      Field(f"d{i}_attr", BIGINT)),
            [np.arange(dim_rows, dtype=np.int64),
             rng.integers(0, 1000, dim_rows).astype(np.int64)],
            primary_key=(f"d{i}_key",))
    return t


def star_sql(k: int) -> str:
    return ("SELECT sum(f_value"
            + "".join(f" + d{i}_attr" for i in range(k))
            + ") FROM fact "
            + " ".join(f"JOIN dim{i} ON f_d{i}key = d{i}_key"
                       for i in range(k)))


def star_micro(shapes=None, fact_rows=None, dim_rows=None, runs=3,
               out_path=None, device="cuda"):
    """ms of the star query fused (K4) and on the pairwise ladder at each
    (dims, hit rate); the steady median after one cold and one warm run
    (``e2e.run_config``). ``fused_engaged``: the fused runs probed
    through K4 (``fused_probes`` of them); ``degrade_reasons``: why the
    others' dimensions took the ladder (``escape``: K3's build of the
    dimension ran a key past MAX_PROBES, the reference's gate). Card:
    (2, 0.9), (3, 0.9), (3, 0.2), (5, 0.9) over 2^22 fact and 4,096
    dimension rows; CPU: (2, 0.9), (3, 0.5) over 2^12 and 256. Raises
    if the fused rows differ from the pairwise rows."""
    from .catalog import Catalog
    from .exec.session import Session
    from .metrics import MULTIJOIN_FUSED_PROBES
    dev = e2e._resolve(device)
    on_card = dev.type == "cuda"
    if shapes is None:
        shapes = [(2, 0.9), (3, 0.9), (3, 0.2), (5, 0.9)] if on_card \
            else [(2, 0.9), (3, 0.5)]
    if fact_rows is None:
        fact_rows = (1 << 22) if on_card else (1 << 12)
    if dim_rows is None:
        dim_rows = 4096 if on_card else 256
    launches0 = e2e._launches()
    records = []
    with e2e.data_cache_root():
        for k, hit_rate in shapes:
            tables = _star_tables(k, fact_rows, dim_rows, hit_rate)
            cat = Catalog()
            cat.register("bench", e2e.BenchConnector(tables, "star"))
            s = Session(catalog=cat, default_cat="bench",
                        default_schema="star", device=dev)
            sql = star_sql(k)
            rec = {"dims": k, "hit_rate": hit_rate,
                   "fact_rows": fact_rows, "dim_rows": dim_rows}
            s.execute("SET SESSION enable_multiway_join = 'true'")
            before = MULTIJOIN_FUSED_PROBES.value()
            reasons0 = dict(s.executor.stats.multijoin_degrade_reasons)
            fused_res, _, fused_ms, _ = e2e.run_config(s, sql, runs=runs,
                                                       prewarm=2)
            rec["fused_probes"] = int(MULTIJOIN_FUSED_PROBES.value() -
                                      before)
            rec["fused_engaged"] = rec["fused_probes"] > 0
            # why a fused run's dimensions took the ladder instead
            rec["degrade_reasons"] = {
                reason: n - reasons0.get(reason, 0) for reason, n in
                s.executor.stats.multijoin_degrade_reasons.items()
                if n > reasons0.get(reason, 0)}
            s.execute("SET SESSION enable_multiway_join = 'false'")
            pair_res, _, pair_ms, _ = e2e.run_config(s, sql, runs=runs,
                                                     prewarm=2)
            if fused_res.rows != pair_res.rows:
                raise AssertionError(f"star k={k} hit_rate={hit_rate}: "
                                     f"fused {fused_res.rows} != pairwise "
                                     f"{pair_res.rows}")
            rec["fused_ms"] = fused_ms
            rec["pairwise_ms"] = pair_ms
            rec["fused_vs_pairwise"] = pair_ms / max(fused_ms, 1e-6)
            rec["rows"] = [list(r) for r in fused_res.rows]
            records.append(rec)
            del s, cat, tables
            e2e._release(dev)
    out = {**_header("star_micro_ms", dev, launches0), "records": records}
    return _finish(out, out_path)


# ---------------------------------------------------------------------------
# scan: zone-map pruning, the read-level decode, the prefetch pipeline
# ---------------------------------------------------------------------------

def scan_table(rows: int):
    """The scan micro's table: a clustered BIGINT key `k` (tight zones)
    and a DOUBLE payload `v`, seed 14."""
    from .batch import Field, Schema
    from .connectors.tpch.datagen import TableData
    from .types import BIGINT, DOUBLE
    rng = np.random.default_rng(14)
    return TableData("scan_micro", Schema((
        Field("k", BIGINT), Field("v", DOUBLE))),
        [np.arange(rows, dtype=np.int64), rng.standard_normal(rows)])


def zone_rows_for(rows: int) -> int:
    return max(1024, rows // 64)                 # 64 zones / stripes


def decode_counts(data, zone_rows, selectivities=SCAN_SELECTIVITIES,
                  directory=None):
    """`data` written as multi-stripe zlib ORC and multi-row-group
    Parquet (one stripe / group per `zone_rows`), read back with the
    predicate ``k < rows * sel``: decoded rows and skipped stripes / row
    groups per selectivity. Host work only: the same counts on every
    device. The files go into `directory` and stay there, or into a
    temporary directory that is removed."""
    from .connectors.parquetdir import flatten_table
    from .formats.orc import read_orc_file, write_orc
    from .formats.parquet import read_parquet_file, write_parquet
    rows = data.num_rows
    tmp = directory or tempfile.mkdtemp(prefix="scan_micro_")
    try:
        flat = flatten_table(data, "bench")
        orc_path = os.path.join(tmp, "scan_micro.orc")
        pq_path = os.path.join(tmp, "scan_micro.parquet")
        write_orc(orc_path, *flat, stripe_rows=zone_rows,
                  compression="zlib")
        write_parquet(pq_path, *flat, row_group_rows=zone_rows)
        decode = []
        for sel in selectivities:
            lim = max(1, int(rows * sel))
            pred = {"k": (0, lim - 1)}
            of = read_orc_file(orc_path, predicates=pred)
            pf = read_parquet_file(pq_path, predicates=pred)
            decode.append({
                "selectivity": sel,
                "orc_decoded_rows": int(len(of.columns[0])),
                "orc_skipped_stripes": of.skipped_stripes,
                "orc_total_stripes": of.total_stripes,
                "parquet_decoded_rows": int(len(pf.columns[0])),
                "parquet_skipped_row_groups": pf.skipped_row_groups,
                "parquet_total_row_groups": pf.total_row_groups,
                "decode_reduction_x": round(
                    rows / max(1, len(of.columns[0])), 1)})
    finally:
        if directory is None:
            shutil.rmtree(tmp, ignore_errors=True)
    return decode


PREFETCH_SQL = ("SELECT l_returnflag, count(*) AS c, "
                "sum(l_extendedprice) AS s FROM tpch.tiny.lineitem "
                "GROUP BY l_returnflag ORDER BY l_returnflag")


def _zone_records(s, rows, zone_rows, runs):
    records = []
    for sel in SCAN_SELECTIVITIES:
        lim = max(1, int(rows * sel))
        q = (f"SELECT count(*) AS c, sum(v) AS sv FROM "
             f"memory.default.scan_micro WHERE k < {lim}")
        rec = {"selectivity": sel, "rows": rows, "zone_rows": zone_rows}
        results = {}
        for setting in ("true", "false"):
            s.execute(f"SET SESSION enable_zone_map_pruning = {setting}")
            s.execute(q)                         # warm (plan + upload)
            st = s.executor.stats
            zones0, rowsp0 = st.scan_zones_pruned, st.scan_rows_pruned
            walls = []
            for _ in range(runs):
                s.executor.invalidate_scan_cache()
                t0 = time.monotonic()
                results[setting] = s.execute(q).rows
                walls.append(time.monotonic() - t0)
            tag = "prune_on" if setting == "true" else "prune_off"
            rec[f"{tag}_ms"] = min(walls) * 1000
            if setting == "true":
                rec["zones_pruned_per_run"] = \
                    (st.scan_zones_pruned - zones0) // runs
                rec["rows_pruned_per_run"] = \
                    (st.scan_rows_pruned - rowsp0) // runs
        rec["identical"] = results["true"] == results["false"]
        records.append(rec)
    return records


def _prefetch(dev, runs):
    """A multi-chunk aggregation with the fact cache off (the chunked
    path decodes every chunk) at prefetch depth 0 and 2; the chunk
    loop's spans (``Executor.chunk_spans``) beside each wall."""
    from .exec.session import Session
    s2 = Session(device=dev)
    s2.executor.enable_fact_cache = False        # force per-chunk decode
    s2.execute("SET SESSION spill_chunk_rows = 8192")
    s2.execute("SET SESSION enable_zone_map_pruning = false")
    prefetch, results = {}, {}
    for depth in (0, 2):
        s2.execute(f"SET SESSION prefetch_depth = {depth}")
        s2.execute(PREFETCH_SQL)                 # warm
        walls, spans = [], None
        for _ in range(runs):
            t0 = time.monotonic()
            results[depth] = s2.execute(PREFETCH_SQL).rows
            walls.append(time.monotonic() - t0)
            spans = getattr(s2.executor, "chunk_spans", None)
        ent = {"wall_ms": min(walls) * 1000}
        if spans:
            for k, v in spans.items():
                ent[k] = v
        prefetch[f"depth{depth}"] = ent
    prefetch["identical"] = results.get(0) == results.get(2)
    d2 = prefetch["depth2"]
    if "decode_s" in d2 and "compute_s" in d2 and "wall_s" in d2:
        # the pipelined loop's own wall against the serial sum of its
        # decode and compute spans, from the same run
        prefetch["serialized_sum_ms"] = \
            (d2["decode_s"] + d2["compute_s"]) * 1000
        prefetch["overlap_win"] = \
            d2["wall_s"] * 1000 < prefetch["serialized_sum_ms"]
    return prefetch


def scan_micro(rows=None, runs=3, out_path=None, device="cuda"):
    """The scan path's three measurements in one record: `records`
    (zone-map pruning on against off per selectivity over the clustered
    table, the scan cache dropped before each timed run; zones and rows
    pruned; ``identical`` rows), `decode` (``decode_counts``) and
    `prefetch` (``_prefetch``). 2^24 rows on the card, 2^17 on the
    CPU."""
    from .exec.session import Session
    dev = e2e._resolve(device)
    if rows is None:
        rows = (1 << 24) if dev.type == "cuda" else (1 << 17)
    zone_rows = zone_rows_for(rows)
    data = scan_table(rows)
    launches0 = e2e._launches()
    with e2e.data_cache_root():
        s = Session(device=dev)
        s.catalog.connector("memory").create_table("default", "scan_micro",
                                                   data)
        s.execute(f"SET SESSION zone_map_rows = {zone_rows}")
        records = _zone_records(s, rows, zone_rows, runs)
        del s
        e2e._release(dev)
        decode = decode_counts(data, zone_rows)
        prefetch = _prefetch(dev, runs)
    out = {**_header("scan_micro_ms", dev, launches0), "records": records,
           "decode": decode, "prefetch": prefetch}
    return _finish(out, out_path)


# ---------------------------------------------------------------------------
# the checks a record carries, and the command line
# ---------------------------------------------------------------------------

def failures(rec: dict) -> list:
    """The checks of a micro record that did not hold: an arm that
    differed from the one it replaces, a star that did not fuse for
    another reason than K3's escape verdict, a scan whose pruned rows
    differed."""
    bad = []
    for r in rec.get("records", ()):
        reasons = set(r.get("degrade_reasons") or ())
        fused = r.get("fused_engaged", True) or \
            bool(reasons) and reasons <= {"escape"}
        for key, ok in (("max_abs_err", r.get("max_abs_err", 0) == 0),
                        ("equal_plain", r.get("equal_plain", True)),
                        ("arms_agree", r.get("arms_agree", True)),
                        ("fused_engaged", fused),
                        ("identical", r.get("identical", True))):
            if not ok:
                bad.append(f"{rec['metric']} {key}: {r}")
    if rec.get("prefetch", {}).get("identical") is False:
        bad.append(f"{rec['metric']} prefetch differs across depths")
    return bad


RUNNERS = {"gather": gather_micro, "agg": agg_micro, "star": star_micro,
           "scan": scan_micro}
# the reference's record names, each written under --out
FILES = {"gather": "BENCH_gather_micro.json",
         "agg": "BENCH_agg_micro.json",
         "star": "BENCH_star_micro.json",
         "scan": "BENCH_scan_micro.json"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m trino_tpu_torch.micro",
        description="kernel micro-benchmarks: print one JSON record per "
                    "mode (exit 1 when an arm disagreed)")
    p.add_argument("mode", choices=MODES + ("all",))
    p.add_argument("--out", default=None,
                   help="also write each record into this directory, "
                        "under the reference's file name")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    modes = MODES if a.mode == "all" else (a.mode,)
    if a.out:
        os.makedirs(a.out, exist_ok=True)
    bad = []
    for mode in modes:
        path = os.path.join(a.out, FILES[mode]) if a.out else None
        rec = RUNNERS[mode](out_path=path, device=a.device)
        print(json.dumps(rec), flush=True)
        bad += failures(rec)
    for b in bad:
        print(b, file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
