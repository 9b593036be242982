"""K5 (trino_tpu_torch/ops/direct_agg.py) against the reference's
`pallas_agg.direct_group_aggregate_mxu` in interpret mode, on the same
numpy inputs, and the executor's `mxu` arm end to end.

Tolerances: exact. Live groups, their validity and their states equal the
reference's bit for bit (int64 sums, inputs inside the TPU kernel's exact
domain |value| < 2^59), and equal the port's plain direct aggregation on
every input (wrapping int64 sums). Reference runs stay within two of its
16,384-row blocks, because the interpreter is slow.

On the CPU the entry runs its plain version; the CUDA kernel is held
against it on a card over the same grid of cases (K5_CASES in
tests/test_torch_k5_cases.py). What the wrapper adds on the card — the one
allocation the kernel writes the output columns into, viewed as the
Batch — is checked here by writing the plain result into that layout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_k5_cases import K5_CASES, k5_case, k5_case_id
from tpch_full import QUERIES
from trino_tpu.batch import Batch as JaxBatch
from trino_tpu.batch import Column as JaxColumn
from trino_tpu.batch import batch_from_numpy as jax_batch
from trino_tpu.ops import pallas_agg as pa
from trino_tpu.ops.aggregate import AggSpec as JaxAggSpec
from trino_tpu_torch.batch import Batch, Column
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


def _case_batches(case, seed):
    """One K5 case as a reference batch, a port batch (capacity = rows,
    no padding) and both aggregate tuples."""
    arrays, valids, live, keys, domains, aggs = k5_case(case, seed)
    jb = JaxBatch(tuple(JaxColumn(jnp.asarray(a), jnp.asarray(v))
                        for a, v in zip(arrays, valids)), jnp.asarray(live))
    tb = Batch(tuple(Column(torch.from_numpy(a), torch.from_numpy(v))
                     for a, v in zip(arrays, valids)),
               torch.from_numpy(live))
    return (jb, tb, keys, domains, tuple(JaxAggSpec(f, c) for f, c in aggs),
            tuple(AggSpec(f, c) for f, c in aggs))


def _all_cells(batch):
    """live, then per column its validity and data over every group."""
    return [np.asarray(batch.live).tolist()] + [
        (np.asarray(c.valid).tolist(), np.asarray(c.data).tolist())
        for c in batch.columns]


@pytest.mark.parametrize("case", [c for c in K5_CASES if c[0]],
                         ids=k5_case_id)
def test_plain_matches_reference_on_grid(case):
    """The new entry's plain version against the reference's interpreted
    kernel over the grid: every key dtype, one to three keys, G = 1, 4,
    7 and 16, NULL keys and values, dead rows, count_star, count and
    eight sums near +-2^58, row counts that are no multiple of a block;
    every group's live flag, validity and state equal."""
    jb, tb, keys, domains, jaggs, taggs = _case_batches(case, 3)
    want = pa.direct_group_aggregate_mxu(jb, keys, domains, jaggs,
                                         interpret=True)
    got = k5.direct_group_aggregate_mxu(tb, keys, domains, taggs)
    assert _all_cells(got) == _all_cells(want)
    assert [c.data.dtype for c in got.columns[:len(keys)]] == \
        [tb.columns[k].data.dtype for k in keys]


def test_plain_on_no_rows():
    """A batch of capacity 0: every group dead, states 0 (the reference
    pads to a whole block, so the port's direct arm is the yardstick)."""
    case = next(c for c in K5_CASES if c[0] == 0)
    _, tb, keys, domains, _, taggs = _case_batches(case, 3)
    got = k5.direct_group_aggregate_mxu(tb, keys, domains, taggs)
    assert not got.live.any() and got.live.shape == (7,)
    assert all(int(c.data.abs().sum()) == 0
               for c in got.columns[len(keys):])
    assert _live_cells(got) == _live_cells(
        direct_group_aggregate(tb, keys, domains, taggs))


@pytest.mark.parametrize("case", K5_CASES, ids=k5_case_id)
def test_output_layout_holds_the_batch(case):
    """K5 writes its output columns into one allocation at
    output_layout's offsets, and the wrapper views them as the Batch:
    the plain result written there the same way reads back equal."""
    _, tb, keys, domains, _, taggs = _case_batches(case, 4)
    want = k5.direct_group_aggregate_mxu_plain(tb, keys, domains, taggs)
    g = int(np.prod(domains))
    key_dtypes = [tb.columns[k].data.dtype for k in keys]
    layout = k5.output_layout(key_dtypes, [a.func for a in taggs], g)
    key_offs, state_offs, valid_offs, live_off, total = layout
    out = torch.full((total,), 0xAB, dtype=torch.uint8)

    def put(off, t):
        raw = torch.from_numpy(np.ascontiguousarray(t.numpy())
                               .view(np.uint8))
        out[off:off + raw.numel()] = raw
    put(live_off, want.live)
    for off, col in zip(key_offs, want.columns):
        put(off, col.data)
    for off, voff, col in zip(state_offs, valid_offs,
                              want.columns[len(keys):]):
        put(off, col.data)
        if voff is not None:
            put(voff, col.valid)
    got = k5.batch_from_output(out, key_dtypes, layout, g)
    assert _all_cells(got) == _all_cells(want)
    assert [c.data.dtype for c in got.columns] == \
        [c.data.dtype for c in want.columns]


def test_group_sums_wrap_like_int64():
    """Sums past 2^63 wrap: the plain masked sums equal numpy's wrapping
    sums (and so does the kernel, bit for bit, on the card)."""
    rng = np.random.default_rng(4)
    n, g = 50_000, 16
    gid = rng.integers(0, g + 1, n).astype(np.int32)     # g = miss group
    planes = rng.integers(-(1 << 62), 1 << 62, (17, n))
    got = k5.group_sums_plain(torch.from_numpy(gid),
                              torch.from_numpy(planes), g)
    want = np.stack([np.where(gid == i, planes, 0).sum(axis=1)
                     for i in range(g)])
    assert got.shape == (g, 17)
    assert np.array_equal(got.numpy(), want)


def test_group_sums_rejects_what_the_kernel_cannot_take():
    """The kernel's entry refuses, before any launch, what it cannot
    compute: more than MAX_GROUPS groups, more than MAX_AGGS aggregates,
    a key or a sum that is not an integer, a DISTINCT aggregate."""
    n = 1024
    ints = Column(torch.zeros(n, dtype=torch.int32),
                  torch.ones(n, dtype=torch.bool))
    floats = Column(torch.zeros(n, dtype=torch.float64),
                    torch.ones(n, dtype=torch.bool))
    batch = Batch((ints, floats), torch.ones(n, dtype=torch.bool))
    bad = [((0,), (17,), (AggSpec("count_star", None),)),
           ((0,), (4,), (AggSpec("count_star", None),) * 9),
           ((1,), (4,), (AggSpec("count_star", None),)),
           ((0,), (4,), (AggSpec("sum", 1),)),
           ((0,), (4,), (AggSpec("count", 0, distinct=True),))]
    for keys, domains, aggs in bad:
        with pytest.raises(ValueError):
            k5._launch(batch, keys, domains, aggs)


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
