"""K5 (trino_tpu_torch/ops/direct_agg.py) against the reference's
`pallas_agg.direct_group_aggregate_mxu` in interpret mode, on the same
numpy inputs, and the executor's `mxu` arm end to end.

Tolerances: exact. Live groups, their validity and their states equal the
reference's bit for bit (int64 sums, inputs inside the TPU kernel's exact
domain |value| < 2^59), and equal the port's plain direct aggregation on
every input (wrapping int64 sums). Reference runs stay within two of its
16,384-row blocks, because the interpreter is slow.

On the CPU the wrapper runs its plain masked sums; the CUDA kernel is held
against them on a card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpch_full import QUERIES
from trino_tpu.batch import batch_from_numpy as jax_batch
from trino_tpu.ops import pallas_agg as pa
from trino_tpu.ops.aggregate import AggSpec as JaxAggSpec
from trino_tpu_torch.batch import batch_from_numpy as torch_batch
from trino_tpu_torch.ops import direct_agg as k5
from trino_tpu_torch.ops.aggregate import AggSpec, direct_group_aggregate

# pytest-xdist runs one process per core: one torch thread each keeps
# the CPU tests from oversubscribing the cores
torch.set_num_threads(1)

AGGS = (("sum", 2), ("count", 2), ("sum", 3), ("count_star", None),
        ("count", 3))


def _inputs(n, seed, null_frac=0.1):
    rng = np.random.default_rng(seed)
    k0 = rng.integers(0, 4, n).astype(np.int32)
    k1 = rng.integers(0, 4, n).astype(np.int64)
    v1 = rng.integers(-(1 << 58), 1 << 58, n)
    v2 = rng.integers(-(1 << 30), 10, n)
    valids = [rng.random(n) >= 0.03, rng.random(n) >= 0.03,
              rng.random(n) >= null_frac, rng.random(n) >= null_frac]
    dead = rng.random(n) < 0.05
    return [k0, k1, v1, v2], valids, dead


def _both(arrays, valids, dead):
    n = len(arrays[0])
    jb = jax_batch(arrays, valids=valids)
    jb = jb.with_live(jb.live & jnp.asarray(
        np.pad(~dead, (0, jb.capacity - n))))
    tb = torch_batch(arrays, valids=valids, device="cpu")
    tb = tb.with_live(tb.live & torch.from_numpy(
        np.pad(~dead, (0, tb.capacity - n))))
    return jb, tb


def _live_cells(batch):
    live = np.asarray(batch.live)
    out = [live.tolist()]
    for c in batch.columns:
        valid = np.asarray(c.valid) & live
        out.append((valid.tolist(),
                    np.where(valid, np.asarray(c.data).astype(np.int64),
                             0).tolist()))
    return out


@pytest.mark.parametrize("n,domains,keys", [(30_000, (4, 4), (0, 1)),
                                            (5_000, (3,), (1,))])
def test_matches_reference_kernel(n, domains, keys):
    """NULL keys and values, dead rows, negative sums near 2^58 * n."""
    arrays, valids, dead = _inputs(n, seed=n)
    jb, tb = _both(arrays, valids, dead)
    jaggs = tuple(JaxAggSpec(f, a) for f, a in AGGS)
    taggs = tuple(AggSpec(f, a) for f, a in AGGS)
    assert k5.supports(taggs, domains) == pa.supports(jaggs, domains)
    want = pa.direct_group_aggregate_mxu(jb, keys, domains, jaggs,
                                         interpret=True)
    got = k5.direct_group_aggregate_mxu(tb, keys, domains, taggs)
    assert _live_cells(got) == _live_cells(want)
    assert _live_cells(got) == _live_cells(
        direct_group_aggregate(tb, keys, domains, taggs))


def test_supports_is_the_reference_gate():
    for aggs, domains in ((AGGS, (4, 4)), (AGGS, (17,)), (AGGS, (4, 5)),
                          ((("min", 2),), (3,)), (AGGS * 2, (2,))):
        assert k5.supports(tuple(AggSpec(f, a) for f, a in aggs),
                           domains) == \
            pa.supports(tuple(JaxAggSpec(f, a) for f, a in aggs), domains)


def test_group_sums_wrap_like_int64():
    """Sums past 2^63 wrap: the plain version equals numpy's wrapping
    sums (and so will the kernel, bit for bit)."""
    rng = np.random.default_rng(4)
    n, g = 50_000, 16
    gid = rng.integers(0, g + 1, n).astype(np.int32)     # g = miss group
    planes = rng.integers(-(1 << 62), 1 << 62, (17, n))
    got = k5.group_sums(torch.from_numpy(gid), torch.from_numpy(planes), g)
    want = np.stack([np.where(gid == i, planes, 0).sum(axis=1)
                     for i in range(g)])
    assert got.shape == (g, 17)
    assert np.array_equal(got.numpy(), want)


def test_group_sums_rejects_what_the_kernel_cannot_take():
    gid = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        k5.group_sums(gid, torch.zeros((18, 8), dtype=torch.int64), 4)
    with pytest.raises(ValueError):
        k5.group_sums(gid, torch.zeros((2, 8), dtype=torch.int64), 17)
    with pytest.raises(ValueError):
        k5.group_sums(gid.long(), torch.zeros((2, 8), dtype=torch.int64), 4)


@pytest.fixture(scope="module")
def session():
    from trino_tpu.connectors.tpch.connector import TpchConnector
    from trino_tpu_torch.catalog import catalog_from_tables
    from trino_tpu_torch.exec.session import Session
    conn = TpchConnector()
    tables = {t: conn.get_table("tiny", t) for t in ("orders", "lineitem")}
    return Session(catalog_from_tables(tables), default_schema="tiny",
                   device="cpu")


@pytest.mark.parametrize("setting,arm", [("true", "mxu"), ("auto", "direct"),
                                         ("false", "direct")])
def test_q12_mxu_arm(session, setting, arm):
    """q12's direct aggregate (7 groups, two integer sums): `true` takes
    K5, `auto` does not (7 < MXU_AGG_MIN_GROUPS), `false` never does;
    the rows are equal every way."""
    session.execute("SET SESSION mxu_agg = 'false'")
    want = session.execute(QUERIES[12]).rows
    session.execute(f"SET SESSION mxu_agg = '{setting}'")
    before = session.executor.stats.mxu_agg_calls
    got = session.execute(QUERIES[12]).rows
    assert got == want and len(got) == 2
    assert session.executor.strategy_decisions["AggregateNode"] == arm
    assert session.executor.stats.mxu_agg_calls == \
        before + (arm == "mxu")
