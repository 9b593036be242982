"""Walls on the card of TPC-H q1, q6 and q3 at sf1 on an 8-shard mesh
(`make_mesh(8, "cuda")`, partitioned joins), beside the single card's,
through the port found in a checkout.

    python3 tools/mesh_walls.py [CHECKOUT] [RUNS]

CHECKOUT defaults to this repository and RUNS to 5. Each query runs once
cold and then RUNS times in one mesh session, then cold and RUNS times in
a single-card session. The script prints one JSON line: the card's name
and power limit, every wall in seconds, each query's all-gathers a run
(`ExecStats.mesh_gathers`, null in a checkout without it) and the bytes
each device holds in the mesh's cached scans after the queries. Run it
on two checkouts in turn (parent, change, change, parent) to compare two
commits on one card; they may share the data cache
(`$TRINO_TPU_DATA_CACHE`). A decision file left by an earlier process is
removed first, so every process starts cold.
"""

import json
import os
import statistics
import subprocess
import sys
import time

SHARDS = 8


def _scan_bytes(executor) -> dict:
    """Bytes of the executor's cached scans per device: a sharded scan's
    by the device of each shard, a whole one on its device."""
    from trino_tpu_torch.exec.memory import batch_bytes
    out = {}
    for b in executor._scan_cache.values():
        for s in getattr(b, "shards", [b]):
            out[str(s.device)] = out.get(str(s.device), 0) + batch_bytes(s)
    return out


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else here)
    runs = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import torch
    if not torch.cuda.is_available():
        print("mesh_walls: CUDA is not available", file=sys.stderr)
        return 1
    from tpch_full import QUERIES as H
    from trino_tpu_torch.connectors.diskcache import cache_root
    from trino_tpu_torch.exec.executor import Executor
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.parallel.dist_executor import MeshExecutor
    from trino_tpu_torch.parallel.mesh import make_mesh
    name = getattr(Executor, "_DECISION_CACHE_FILE", None)
    if name and os.path.exists(os.path.join(cache_root(), name)):
        os.remove(os.path.join(cache_root(), name))

    def walls(session, sql):
        out, rows = [], None
        for _ in range(runs + 1):
            t = time.monotonic()
            rows = session.execute(sql).rows
            torch.cuda.synchronize()
            out.append(time.monotonic() - t)
        return out, rows

    mesh = Session(default_schema="sf1")
    mesh.executor = MeshExecutor(mesh.catalog, make_mesh(SHARDS, "cuda"))
    mesh.execute("SET SESSION join_distribution_type = 'partitioned'")
    mesh.execute("SET SESSION enable_pallas_hash = true")
    single = Session(default_schema="sf1")
    stats = mesh.executor.stats
    rec = {"checkout": root, "shards": SHARDS, "queries": {}}
    for q in (1, 6, 3):
        g0 = getattr(stats, "mesh_gathers", None)
        mesh_walls, mesh_rows = walls(mesh, H[q])
        g1 = getattr(stats, "mesh_gathers", None)
        single_walls, single_rows = walls(single, H[q])
        rec["queries"][f"q{q}"] = {
            "mesh_walls_s": mesh_walls,
            "mesh_steady_median_s": statistics.median(mesh_walls[1:]),
            "single_walls_s": single_walls,
            "single_steady_median_s": statistics.median(single_walls[1:]),
            "rows_equal": mesh_rows == single_rows,
            "mesh_gathers_per_run": None if g0 is None else
            (g1 - g0) / (runs + 1)}
    rec["scan_bytes_by_device"] = _scan_bytes(mesh.executor)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    rec["card"] = card.stdout.strip()
    print(json.dumps(rec))
    return 0 if all(v["rows_equal"] for v in rec["queries"].values()) \
        else 1


if __name__ == "__main__":
    sys.exit(main())
