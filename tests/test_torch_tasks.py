"""The port's worker-task wire pieces (trino_tpu_torch/server/tasks.py)
against the reference's: the exchange's partition hash on seeded keys,
the fragment wire form of every TPC-H corpus plan (byte-equal, so a JAX
coordinator can drive port workers), and the task manager's refusal to
start on a machine without CUDA unless the caller names the CPU."""

import numpy as np
import pytest
import torch

from tpch_full import QUERIES as TPCH
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu.planner.fragmenter import fragment_plan as jax_fragment_plan
from trino_tpu.planner.optimizer import prune_plan as jax_prune_plan
from trino_tpu.server import tasks as jtasks
from trino_tpu.sql.parser import parse as jax_parse
from trino_tpu_torch.exec.session import Session
from trino_tpu_torch.planner.fragmenter import fragment_plan
from trino_tpu_torch.planner.optimizer import prune_plan
from trino_tpu_torch.server import tasks as ttasks
from trino_tpu_torch.sql.parser import parse

torch.set_num_threads(1)

SPLIT_ROWS = 8192


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_splitmix64_equals_reference(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2 ** 63, 10_000, dtype=np.int64).view(np.uint64)
    x[:3] = [0, 2 ** 64 - 1, 0x9E3779B97F4A7C15]
    with np.errstate(over="ignore"):
        assert np.array_equal(ttasks._splitmix64(x), jtasks._splitmix64(x))


@pytest.mark.parametrize("count", [1, 2, 7, 16])
@pytest.mark.parametrize("dtypes", [(np.int64,), (np.int32, np.int8),
                                    (np.int16, np.bool_, np.int64)],
                         ids=lambda d: "-".join(np.dtype(t).name for t in d))
def test_partition_assignment_equals_reference(dtypes, count):
    rng = np.random.default_rng(count * 31 + len(dtypes))
    n = 5_000
    arrays, valids = [], []
    for t in dtypes:
        if t is np.bool_:
            arrays.append(rng.integers(0, 2, n).astype(np.bool_))
        else:
            info = np.iinfo(t)
            arrays.append(rng.integers(info.min, info.max, n,
                                       dtype=np.int64).astype(t))
        valids.append(rng.random(n) > 0.1)           # NULL keys too
    keys = list(range(len(dtypes)))
    got = ttasks.partition_assignment(arrays, valids, keys, count)
    want = jtasks.partition_assignment(arrays, valids, keys, count)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.min() >= 0 and got.max() < count


def test_partition_assignment_refuses_float_keys_like_reference():
    a = [np.linspace(0, 1, 10)]
    v = [np.ones(10, np.bool_)]
    for mod in (ttasks, jtasks):
        with pytest.raises(ValueError, match="integer keys"):
            mod.partition_assignment(a, v, [0], 4)


@pytest.fixture(scope="module")
def sessions():
    """Both packages plan fused stars: the port's `auto` fuses them on
    every device (the TPU's rule), the reference's only on a TPU."""
    out = (JaxSession(default_schema="tiny"),
           Session(default_schema="tiny", device="cpu"))
    for s in out:
        s.execute("SET SESSION enable_multiway_join = 'true'")
    return out


def _fragment_blobs(session, parse_fn, prune, frag, encode, sql):
    rel = session.planner().plan_query(parse_fn(sql))
    root = prune(rel.node)
    blobs = [encode({"root": root})]
    for f in frag(root, session.catalog, min_build_rows=SPLIT_ROWS):
        blobs.append(encode({"root": f.root, "id": f.id}))
    return blobs


@pytest.mark.parametrize("qnum", sorted(TPCH))
def test_encode_fragment_equals_reference(sessions, qnum):
    """The pruned plan and every fragment the fragmenter cuts from it
    encode to the reference's bytes, and decode back to the same
    bytes."""
    js, ts = sessions
    want = _fragment_blobs(js, jax_parse, jax_prune_plan, jax_fragment_plan,
                           jtasks.encode_fragment, TPCH[qnum])
    got = _fragment_blobs(ts, parse, prune_plan, fragment_plan,
                          ttasks.encode_fragment, TPCH[qnum])
    assert got == want
    for blob in got:
        assert ttasks.encode_fragment(ttasks.decode_fragment(blob)) == blob


def test_task_manager_needs_the_card_unless_cpu_is_named(sessions,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttasks.TaskManager(sessions[1].catalog)
    tm = ttasks.TaskManager(sessions[1].catalog, device="cpu")
    assert tm.device.type == "cpu" and tm._executor.device.type == "cpu"
