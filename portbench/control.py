"""The control of the comparison: runs of the cell in which, after the
window, the plain reference computed in a lower precision is put in the
program's place and judged by ``run.py``'s own check.

    python -m portbench.control --workload <cell> --seeds 11,12,13
        [--seconds 25] [--forms float32,float64]

For each seed, in one process: a run of the cell at its own size and
load (``run.run_cell``, a window of ``--seconds``), whose sample of
answers is judged three ways: the program's rows, and for each form the
reference's rows in that arithmetic (``reference.common.ARITH``: the
values as floats, summed in the float, rounded half up to the column's
scale), sent as decimal text as the protocol sends a right answer. So
the program's readings and the controls' come from the same queries.

Prints one JSON line a seed. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=25.0)
    p.add_argument("--forms", default="float32,float64")
    a = p.parse_args(argv)
    forms = a.forms.split(",")
    for seed in [int(s) for s in a.seeds.split(",")]:
        out = run.run_cell(a.workload, seed, a.seconds, False,
                           t_start=time.monotonic(), controls=forms)
        print(json.dumps({
            "seed": seed, "attempted": out["attempted"],
            "program": {k: v["value"]
                        for k, v in out["correctness"].items()},
            "program_correct": out["correct"],
            "controls": out["controls"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
