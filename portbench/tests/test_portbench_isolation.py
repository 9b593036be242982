"""Nothing the benchmark runs loads JAX or the JAX package; the
generators and the references load nothing of the program either."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "trino_tpu"}

_LOADED = """
import importlib, json, pkgutil, sys
import portbench
mods = [m.name for m in pkgutil.walk_packages(portbench.__path__,
                                              "portbench.")
        if ".tests" not in m.name and (m.name.startswith(tuple({prefixes}))
                                       or not {prefixes})]
for m in mods:
    importlib.import_module(m)
{extra}
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""


def _loaded(prefixes=(), extra=""):
    code = _LOADED.format(prefixes=list(prefixes), extra=extra)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_every_module_and_a_run_load_no_jax():
    run = ("from portbench import run\n"
           "run.run_cell('tpch-sf10.joins', 5, 0.5, True, device='cpu', "
           "rows={'supplier': 100, 'customer': 1500, 'part': 2000, "
           "'orders': 15000})\n"
           "import portbench.run as r\n"
           "[r.load_reader(m['name']) for m in r.load_benchmark()"
           "['per_layer']]")
    loaded = _loaded(extra=run)
    assert "trino_tpu_torch" in loaded     # the run did drive the program
    assert not loaded & FORBIDDEN


def test_generators_and_references_load_nothing_of_the_program():
    loaded = _loaded(("portbench.gen", "portbench.reference",
                      "portbench.compare", "portbench.traffic"))
    assert not loaded & (FORBIDDEN | {"trino_tpu_torch"})
