"""Steady walls on the card of TPC-H q1 and q3, TPC-DS q3, and TPC-H q1
and q12 through the chunked driver, at sf1, through the port found in a
checkout.

    python3 tools/steady_walls.py [CHECKOUT] [RUNS]

CHECKOUT defaults to this repository and RUNS to 10. Each query runs
once cold and then RUNS times in one session, and the script prints one
JSON line: the card's name and power limit and every wall in seconds.
Run it on two checkouts in turn, alternating which goes first, to
compare two commits on one card; they may share the data cache
(`$TRINO_TPU_DATA_CACHE`). A decision file left by an earlier process is
removed first, so every process starts cold.
"""

import json
import os
import subprocess
import sys
import time

CHUNK_ROWS = 1_048_576


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else here)
    runs = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import torch
    if not torch.cuda.is_available():
        print("steady_walls: CUDA is not available", file=sys.stderr)
        return 1
    from tpcds_queries import QUERIES as DS
    from tpch_full import QUERIES as H
    from trino_tpu_torch.connectors.diskcache import cache_root
    from trino_tpu_torch.exec.executor import Executor
    from trino_tpu_torch.exec.session import Session
    name = getattr(Executor, "_DECISION_CACHE_FILE", None)
    if name and os.path.exists(os.path.join(cache_root(), name)):
        os.remove(os.path.join(cache_root(), name))

    def walls(session, sql):
        out = []
        for _ in range(runs + 1):
            t = time.monotonic()
            session.execute(sql)
            torch.cuda.synchronize()
            out.append(time.monotonic() - t)
        return out

    tpch = Session(default_schema="sf1")
    tpcds = Session(default_cat="tpcds", default_schema="sf1")
    rec = {"q1": walls(tpch, H[1]), "q3": walls(tpch, H[3]),
           "ds q3": walls(tpcds, DS[3])}
    tpch.execute(f"SET SESSION spill_chunk_rows = {CHUNK_ROWS}")
    rec["chunked q1"] = walls(tpch, H[1])
    rec["chunked q12"] = walls(tpch, H[12])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"checkout": root, "card": card.strip(), "runs": runs,
                      "walls_s": rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
