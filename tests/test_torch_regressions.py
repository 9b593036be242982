"""The regression gate on the port (trino_tpu_torch/regressions.py)
against the reference's (bench.py's `load_bench_round`,
`check_regressions` and `--check-regressions`), on the same synthetic
round files, series by series:

- every series' record parses to the same configs and walls in both;
- three healthy rounds pass, an injected 3x round is flagged, with equal
  reports;
- unparseable rounds (not JSON, an empty runner tail, torn tail lines)
  are tolerated, and fewer than 2 rounds are never judged;
- the CLI over a directory exits 0, then 1 after the injected round,
  with the reference's report series by series;
- the end-to-end series reads `steady_ms`, the key `e2e.run_e2e` writes
  (the one kept difference: the reference reads `tpu_steady_ms`), here
  on a record that `e2e.run_e2e` made.

No test reads the repository's own round files."""

import json
import os

import pytest
import torch

import bench
from trino_tpu_torch import e2e, regressions

torch.set_num_threads(1)


def _e2e(key):
    def make(v):
        return {"metric": "tpch_e2e_sql_to_result_wall_ms", "value": v,
                "detail": {"q3_sf10": {key: v, "speedup": 1.0},
                           "q6_sf1": {key: v / 10, "speedup": 2.0},
                           "device": "cuda", "elapsed_s": 1.0}}
    return make


# series -> (file name of round i, the reference's record, the port's);
# the two records differ only where the port's e2e key does
SERIES = {
    "e2e": ("BENCH_r0{i}.json", _e2e("tpu_steady_ms"), _e2e("steady_ms")),
    "agg_micro": ("BENCH_agg_micro_r0{i}.json", lambda v: {
        "metric": "agg_micro_ms", "records": [
            {"groups": 16, "rows": 2048, "sort_ms": 9.0, "hash_ms": v},
            {"groups": 10_000_000, "rows": 2048, "sort_ms": 2 * v}]},
        None),
    "star_micro": ("BENCH_star_micro_r0{i}.json", lambda v: {
        "metric": "star_micro_ms", "records": [
            {"dims": 2, "hit_rate": 0.9, "fused_ms": v,
             "pairwise_ms": 9.0},
            {"dims": 5, "hit_rate": 0.2, "fused_ms": 2.0,
             "pairwise_ms": v}]}, None),
    "scan_micro": ("BENCH_scan_micro_r0{i}.json", lambda v: {
        "metric": "scan_micro_ms", "records": [
            {"selectivity": 0.0001, "prune_on_ms": v},
            {"selectivity": 1.0, "prune_on_ms": 4 * v}],
        "prefetch": {"depth0": {"wall_ms": 2 * v},
                     "depth2": {"wall_ms": v}, "identical": True}}, None),
    "soak": ("BENCH_soak_r0{i}.json", lambda v: {
        "metric": "soak", "tenants": {"alpha": {"p99_ms": v},
                                      "beta": {"p99_ms": 2 * v}},
        "throughput_qps": 1000.0 / v}, None),
    "write_chaos": ("BENCH_write_chaos_r0{i}.json", lambda v: {
        "metric": "write_chaos", "points": {
            "WRITE_STAGE": {"p50_ms": v}, "WRITE_COMMIT": {"p50_ms": 3}}},
        None),
    "overload": ("BENCH_overload_r0{i}.json", lambda v: {
        "metric": "overload", "cancel_terminal_p50_ms": v,
        "cancel_terminal_max_ms": 2 * v,
        "deadline_overshoot_p50_ms": None}, None),
    "coordinator_chaos": ("BENCH_coordinator_chaos_r0{i}.json", lambda v: {
        "metric": "coordinator_chaos", "failover_to_result_p50_ms": v,
        "failover_to_result_p99_ms": 3 * v}, None),
    "cold_start": ("BENCH_cold_r0{i}.json", lambda v: {
        "metric": "cold_start", "records": [
            {"query": q, "cold_ms": v, "steady_ms": 50.0,
             "ratio": round(v / 50.0, 2)} for q in ("q3", "q5", "q6")],
        "passed": True}, None),
    "multichip": ("MULTICHIP_r0{i}.json", _e2e("tpu_steady_ms"),
                  _e2e("steady_ms")),
}
HEALTHY = (100.0, 110.0, 95.0)


def _tailed(record):
    """A runner's format: the record as the last line of a noisy tail,
    after a torn line."""
    line = json.dumps(record)
    return {"n": 1, "cmd": "python bench.py", "rc": 0,
            "tail": "noise\n" + line[:20] + "\n" + line + "\n"}


def _write_rounds(root, series, values, tailed):
    """The same rounds in `root/ref` (the reference's records) and
    `root/port` (the port's); returns the two lists of paths."""
    name, ref_rec, port_rec = SERIES[series]
    port_rec = port_rec or ref_rec
    out = []
    for side, make in (("ref", ref_rec), ("port", port_rec)):
        d = root / side
        d.mkdir(exist_ok=True)
        paths = []
        for i, v in enumerate(values, 1):
            p = d / name.format(i=i)
            doc = make(v)
            p.write_text(json.dumps(_tailed(doc) if tailed else doc))
            paths.append(str(p))
        out.append(paths)
    return out


def _same_report(mine, theirs):
    """Equal reports, the latest round named by its file's name."""
    mine, theirs = dict(mine), dict(theirs)
    for r in (mine, theirs):
        if "latest" in r:
            r["latest"] = os.path.basename(r["latest"])
    assert mine == theirs


@pytest.mark.parametrize("tailed", [False, True], ids=["record", "tail"])
@pytest.mark.parametrize("series", sorted(SERIES))
def test_rounds_parse_as_the_reference(tmp_path, series, tailed):
    ref, port = _write_rounds(tmp_path, series, HEALTHY, tailed)
    for a, b in zip(ref, port):
        got = regressions.load_bench_round(b)
        assert got and got == bench.load_bench_round(a)


@pytest.mark.parametrize("series", sorted(SERIES))
def test_injected_3x_round_flagged_as_the_reference(tmp_path, series):
    ref, port = _write_rounds(tmp_path, series, HEALTHY + (330.0,), True)
    ok, report = regressions.check_regressions(port[:-1])
    ok_ref, report_ref = bench.check_regressions(ref[:-1])
    assert ok and ok_ref
    _same_report(report, report_ref)
    ok, report = regressions.check_regressions(port)
    ok_ref, report_ref = bench.check_regressions(ref)
    assert not ok and not ok_ref and report["regressions"]
    _same_report(report, report_ref)
    assert all(report["configs"][c]["status"] == "REGRESSED"
               for c in report["regressions"])


def test_unparseable_rounds_tolerated_as_the_reference(tmp_path):
    bad = tmp_path / "BENCH_r01.json"
    bad.write_text("not json")
    killed = tmp_path / "BENCH_r02.json"
    killed.write_text(json.dumps({"n": 2, "rc": 124, "tail": ""}))
    torn = tmp_path / "BENCH_r03.json"
    torn.write_text(json.dumps({"n": 3, "rc": 124,
                                "tail": 'noise\n{"metric": "tpch_'}))
    paths = [str(bad), str(killed), str(torn)]
    for p in paths:
        assert regressions.load_bench_round(p) is None
        assert bench.load_bench_round(p) is None
    ok, report = regressions.check_regressions(paths)
    ok_ref, report_ref = bench.check_regressions(paths)
    assert ok and ok_ref and report["rounds"] == 0
    assert report == report_ref


@pytest.mark.parametrize("values", [(), (100.0,), (100.0, 900.0)],
                         ids=["none", "one", "two"])
def test_fewer_than_two_baselines_never_judged(tmp_path, values):
    ref, port = _write_rounds(tmp_path, "e2e", values, False)
    ok, report = regressions.check_regressions(port)
    ok_ref, report_ref = bench.check_regressions(ref)
    assert ok and ok_ref
    _same_report(report, report_ref)
    if len(values) < 2:
        assert "note" in report
    else:
        assert {e["status"] for e in report["configs"].values()} == \
            {"insufficient-baseline"}


def test_cli_exit_codes_as_the_reference(tmp_path, monkeypatch, capsys):
    for series in sorted(SERIES):
        _write_rounds(tmp_path, series, HEALTHY, True)
    assert regressions.main(["--rounds-dir", str(tmp_path / "port")]) == 0
    mine = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.chdir(tmp_path / "ref")
    assert bench.main(["--check-regressions"]) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(mine) == set(theirs)
    assert {s for s, _ in regressions.SERIES} <= set(mine)
    for key in mine:
        if isinstance(mine[key], dict) and "configs" in mine[key]:
            _same_report(mine[key], theirs[key])
    # one series regresses in a new round: both gates fail
    _write_rounds(tmp_path, "cold_start", HEALTHY + (900.0,), True)
    assert regressions.main(["--rounds-dir", str(tmp_path / "port")]) == 1
    mine = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert bench.main(["--check-regressions"]) == 1
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _same_report(mine["cold_start"], theirs["cold_start"])
    assert "cold_q6" in mine["cold_start"]["regressions"]


def test_e2e_record_reads_steady_ms(tmp_path, monkeypatch):
    """A record of `e2e.run_e2e` parses to its steady medians; the
    reference's parser, which reads `tpu_steady_ms`, finds none."""
    monkeypatch.setenv("TRINO_TPU_DECISION_CACHE", "0")
    path = tmp_path / "BENCH_r01.json"
    rec = e2e.run_e2e(only="q6", q6_schema="tiny", runs=1, device="cpu",
                      out_path=str(path), data_cache=str(tmp_path / "dc"))
    assert rec["detail"]["verified"]
    assert regressions.load_bench_round(str(path)) == {
        "q6_tiny": rec["detail"]["q6_tiny"]["steady_ms"]}
    assert bench.load_bench_round(str(path)) is None
