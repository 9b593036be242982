"""The kernel micro-benchmarks on the port (trino_tpu_torch/micro.py)
against the reference's harness (bench.py's --gather-micro, --agg-micro,
--star-micro and --scan-micro), on the CPU at smoke shapes.

- `_star_tables` equals `bench._star_tables` for k = 2 and 3, every
  column byte for byte and every schema by name and type;
- `gather_micro`: both kinds, positive ns, the record written only where
  asked, K1's (plain, on the CPU) outputs equal to `index_select`'s and
  K2's words and escapes equal to its plain version's;
- `agg_micro`: the sort, direct and hash arms return the same groups,
  `hash_table_slots` equals the reference's `pick_table_slots` and the
  reference's record for the same groups (escapes compared where both
  are 0: the plain K3's escapes depend on insertion order), and the
  record parses into the `agg_micro_g16` series;
- `star_micro` at (2, 0.9) over 2^11 fact rows: the fused probe engaged,
  the rows equal to the JAX Session's over `bench.BenchConnector`;
- `scan_micro`: zones pruned at 0.0001, identical rows at every
  selectivity and across prefetch depths, and the decode counts equal
  to what the reference's readers count on the same files.

The walls of a CPU run mean nothing (the record says `smoke`); every
comparison here is exact."""

import json
import os

import numpy as np
import pytest
import torch

import bench
from trino_tpu.catalog import Catalog as JaxCatalog
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu.ops import pallas_hash as jax_ph
from trino_tpu.ops.aggregate import AggSpec as JaxAggSpec
from trino_tpu_torch import micro, regressions

# pytest-xdist runs one process per core: one torch thread each keeps
# the CPU tests from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def private_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_DATA_CACHE", str(tmp_path / "dc"))


def _same_table(a, b):
    assert a.name == b.name
    assert [(f.name, f.dtype.kind.value) for f in a.schema.fields] == \
        [(f.name, f.dtype.kind.value) for f in b.schema.fields]
    assert tuple(a.primary_key) == tuple(b.primary_key)
    assert len(a.columns) == len(b.columns)
    for x, y in zip(a.columns, b.columns):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("k", [2, 3])
def test_star_tables_equal_reference(k):
    port = micro._star_tables(k, 4096, 256, 0.5)
    ref = bench._star_tables(k, 4096, 256, 0.5)
    assert sorted(port) == sorted(ref)
    for name in port:
        _same_table(port[name], ref[name])


def test_gather_micro_smoke(tmp_path):
    out = micro.gather_micro(table_sizes=[1024], probe_rows=2048,
                             n_tables=2, runs=1,
                             out_path=str(tmp_path / "gm.json"),
                             device="cpu")
    assert out["smoke"] is True and out["mode"] == "cpu"
    assert out["metric"] == "gather_micro_ns_per_elem"
    assert {r["kind"] for r in out["records"]} == {"scan", "windowed"}
    for r in out["records"]:
        assert r["kernel_ns_per_elem"] > 0 and r["take_ns_per_elem"] > 0
        assert r["library"] == "index_select"
    scan = next(r for r in out["records"] if r["kind"] == "scan")
    win = next(r for r in out["records"] if r["kind"] == "windowed")
    assert scan["max_abs_err"] == 0
    assert win["equal_plain"] is True and win["escaped"] == 0
    assert json.load(open(tmp_path / "gm.json")) == out
    assert micro.failures(out) == []
    # nothing written without out_path
    before = set(os.listdir(tmp_path))
    micro.gather_micro(table_sizes=[1024], probe_rows=1024, n_tables=1,
                       runs=1, device="cpu")
    assert set(os.listdir(tmp_path)) == before


def test_agg_micro_smoke_against_reference(tmp_path):
    out = micro.agg_micro(cardinalities=[16, 256], rows=1 << 11, runs=1,
                          out_path=str(tmp_path / "BENCH_agg_micro.json"),
                          device="cpu")
    ref = bench.agg_micro(cardinalities=[16], rows=1 << 11, runs=1,
                          out_path=str(tmp_path / "ref_agg.json"))
    aggs = (JaxAggSpec("sum", 1), JaxAggSpec("count_star", None))
    for r in out["records"]:
        assert r["arms_agree"] is True
        assert "sort_ms" in r and "hash_ms" in r
        assert ("direct_ms" in r) == (r["groups"] <= 64)
        assert r["hash_table_slots"] == \
            jax_ph.pick_table_slots(r["groups"], aggs)[0]
    mine, theirs = out["records"][0], ref["records"][0]
    assert set(theirs) <= set(mine)
    for key in ("groups", "rows", "hash_table_slots"):
        assert mine[key] == theirs[key]
    if mine["hash_escapes"] == 0 or theirs["hash_escapes"] == 0:
        assert mine["hash_escapes"] == theirs["hash_escapes"] == 0
    parsed = regressions.load_bench_round(str(tmp_path /
                                              "BENCH_agg_micro.json"))
    assert parsed["agg_micro_g16"] == mine["hash_ms"]
    assert set(parsed) == {"agg_micro_g16", "agg_micro_g256"}
    assert micro.failures(out) == []


def test_star_micro_smoke_rows_equal_jax_session():
    out = micro.star_micro(shapes=[(2, 0.9)], fact_rows=1 << 11,
                           dim_rows=128, runs=1, device="cpu")
    (rec,) = out["records"]
    assert rec["fused_engaged"] is True and rec["degrade_reasons"] == {}
    assert rec["fused_probes"] > 0
    assert rec["fused_ms"] > 0 and rec["pairwise_ms"] > 0
    cat = JaxCatalog()
    cat.register("bench", bench.BenchConnector(
        bench._star_tables(2, 1 << 11, 128, 0.9), "star"))
    s = JaxSession(catalog=cat, default_cat="bench", default_schema="star")
    want = s.execute(micro.star_sql(2)).rows
    assert rec["rows"] == [list(r) for r in want]
    assert micro.failures(out) == []
    assert set(regressions.parse_round(out)) == {
        "star_micro_k2_h0.9_fused", "star_micro_k2_h0.9_pairwise"}


def _reference_decode(directory, rows, selectivities):
    from trino_tpu.formats.orc import read_orc_file
    from trino_tpu.formats.parquet import read_parquet_file
    out = []
    for sel in selectivities:
        lim = max(1, int(rows * sel))
        pred = {"k": (0, lim - 1)}
        of = read_orc_file(os.path.join(directory, "scan_micro.orc"),
                           predicates=pred)
        pf = read_parquet_file(os.path.join(directory,
                                            "scan_micro.parquet"),
                               predicates=pred)
        out.append({
            "selectivity": sel,
            "orc_decoded_rows": int(len(of.columns[0])),
            "orc_skipped_stripes": of.skipped_stripes,
            "orc_total_stripes": of.total_stripes,
            "parquet_decoded_rows": int(len(pf.columns[0])),
            "parquet_skipped_row_groups": pf.skipped_row_groups,
            "parquet_total_row_groups": pf.total_row_groups,
            "decode_reduction_x": round(
                rows / max(1, len(of.columns[0])), 1)})
    return out


def test_scan_micro_smoke_against_reference_readers(tmp_path):
    rows = 1 << 15
    out = micro.scan_micro(rows=rows, runs=1, device="cpu")
    recs = {r["selectivity"]: r for r in out["records"]}
    assert set(recs) == set(micro.SCAN_SELECTIVITIES)
    assert all(r["identical"] for r in recs.values())
    assert recs[0.0001]["zones_pruned_per_run"] > 0
    assert recs[1.0]["zones_pruned_per_run"] == 0
    assert out["prefetch"]["identical"] is True
    assert out["prefetch"]["depth2"]["chunks"] > 1
    # the same files, read by the reference's readers
    files = tmp_path / "files"
    files.mkdir()
    mine = micro.decode_counts(micro.scan_table(rows),
                               micro.zone_rows_for(rows),
                               directory=str(files))
    assert mine == out["decode"]
    assert _reference_decode(str(files), rows,
                             micro.SCAN_SELECTIVITIES) == mine
    assert mine[0]["orc_skipped_stripes"] > 0
    assert micro.failures(out) == []


@pytest.mark.parametrize("engaged,reasons,ok", [
    (True, {}, True), (False, {"escape": 4}, True),
    (False, {}, False), (False, {"escape": 1, "vmem": 1}, False)],
    ids=["fused", "escaped", "no-reason", "vmem"])
def test_star_takes_the_ladder_only_for_k3_escapes(engaged, reasons, ok):
    """A star micro shape may run the ladder in its fused arm only where
    K3's build escaped: the reference's own K3 escapes one key of a
    4,096-key dimension at 8,192 slots, so its card shapes seldom fuse."""
    rec = {"metric": "star_micro_ms", "records": [
        {"dims": 2, "hit_rate": 0.9, "fused_engaged": engaged,
         "degrade_reasons": reasons}]}
    assert (micro.failures(rec) == []) is ok


def test_reference_k3_escapes_a_4096_key_dimension():
    """Why the star micro's card shapes take the ladder: the reference's
    sequential K3 (interpret mode) escapes one key of 0..4,095 at the
    8,192 slots `join_table_slots` gives, as the port's plain K3 does."""
    from trino_tpu.batch import batch_from_numpy as jax_batch
    from trino_tpu_torch.batch import batch_from_numpy
    from trino_tpu_torch.ops import hashtable as ht
    keys = np.arange(4096, dtype=np.int64)
    slots, fits = jax_ph.join_table_slots(4096)
    assert (slots, fits) == ht.join_table_slots(4096) == (8192, True)
    ref = jax_ph.build_join_table(jax_batch([keys]), (0,), slots,
                                  "interpret")
    mine = ht.build_join_table(batch_from_numpy([keys], device="cpu"),
                               (0,), slots)
    assert int(np.asarray(ref[-1])) == int(mine[3]) == 1
