"""The port stands alone: importing trino_tpu_torch and running a query
loads neither jax nor the reference package (checked in a fresh
interpreter), and no module of the port or chip_smoke.py imports them."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import trino_tpu_torch
from trino_tpu_torch.exec.session import Session
rows = Session(device="cpu").execute(
    "SELECT count(*) FROM lineitem WHERE l_quantity < 10").rows
assert rows and rows[0][0] > 0, rows
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "trino_tpu"))
print("LEAKED", bad)
"""


def test_fresh_interpreter_loads_no_jax_or_reference():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PYTHONSTARTUP")}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LEAKED []" in out.stdout, out.stdout[-2000:]


def _port_sources():
    root = os.path.join(REPO, "trino_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_module_imports_jax_or_reference(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib",
                                              "trino_tpu"), \
                f"{path}:{node.lineno} imports {name}"
