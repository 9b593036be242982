"""Port ops (trino_tpu_torch/ops: project, aggregate, sort, join) against
the reference's ops on the same numpy inputs, at small sizes.

Tolerances: bit-exact everywhere (integers, decimals as scaled int64,
booleans, dates, and doubles produced by the same elementwise float
operations, the reference's as its jit compiles them). Where row order is undefined (join outputs) rows compare as
multisets; float sums compare with rel 1e-12 (summation order differs).
Covered edge cases: decimal .5 boundaries (HALF_UP, away from zero),
all-NULL columns, empty batches, zero-selectivity filters, division by
zero -> NULL, Kleene logic."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import trino_tpu.ir as jir
import trino_tpu.types as jtypes
import trino_tpu_torch.ir as tir
import trino_tpu_torch.types as ttypes
from trino_tpu.batch import batch_from_numpy as jax_batch
from trino_tpu.batch import batch_to_numpy as jax_to_numpy
from trino_tpu.ops import aggregate as jagg
from trino_tpu.ops import join as jjoin
from trino_tpu.ops import project as jproj
from trino_tpu.ops import sort as jsort
from trino_tpu_torch.batch import batch_from_numpy as torch_batch
from trino_tpu_torch.batch import batch_to_numpy as torch_to_numpy
from trino_tpu_torch.ops import aggregate as tagg
from trino_tpu_torch.ops import join as tjoin
from trino_tpu_torch.ops import project as tproj
from trino_tpu_torch.ops import sort as tsort

# pytest-xdist runs one process per core: one torch thread each keeps
# the CPU tests from oversubscribing the cores
torch.set_num_threads(1)

N = 37      # rows in the expression batch (deliberately not aligned)

D2 = [12345, -12345, 5, -5, 15, -15, 25, 0, 999999, -999999, 150, -150]
D4 = [12345, 12350, -12350, 5000, -5000, 15000, -15000, 5, 49999, 50000,
      -50000, 0]


def _expr_arrays():
    rng = np.random.default_rng(42)
    d2 = np.resize(np.asarray(D2, np.int64), N)
    d4 = np.resize(np.asarray(D4, np.int64), N)
    i64 = rng.integers(-50, 50, N)
    i32 = rng.integers(-3, 4, N).astype(np.int32)       # zeros included
    f64 = np.resize(np.array([2.5, -2.5, 0.125, 1e10, -0.0, 3.75, 1.005]),
                    N)
    b = rng.integers(0, 2, N).astype(bool)
    dt = rng.integers(-800, 20000, N).astype(np.int32)
    allnull = rng.integers(-9, 9, N)
    arrays = [d2, d4, i64, i32, f64, b, dt, allnull]
    valids = [rng.random(N) > 0.2 for _ in arrays]
    valids[7] = np.zeros(N, bool)
    return arrays, valids


def _exprs(ir, T):
    """The same expression list built from either package's IR."""
    D2t, D4t = T.decimal(12, 2), T.decimal(12, 4)
    c = [ir.ColumnRef(0, D2t), ir.ColumnRef(1, D4t), ir.ColumnRef(2,
         T.BIGINT), ir.ColumnRef(3, T.INTEGER), ir.ColumnRef(4, T.DOUBLE),
         ir.ColumnRef(5, T.BOOLEAN), ir.ColumnRef(6, T.DATE),
         ir.ColumnRef(7, T.BIGINT)]
    d2, d4, i64, i32, f64, b, dt, nul = c
    lit = ir.Literal
    zero = lit(0, T.BIGINT)
    return {
        "rescale_half_up": ir.Cast(d4, D2t),
        "rescale_to_int_scale": ir.Cast(d2, T.decimal(12, 0)),
        "double_to_decimal": ir.Cast(f64, D2t),
        "decimal_to_bigint": ir.Cast(d2, T.BIGINT),
        "decimal_to_double": ir.Cast(d4, T.DOUBLE),
        "decimal_add_mixed_scale": ir.Arith('+', d2, d4, T.decimal(13, 4)),
        "decimal_mul": ir.Arith('*', d2, d2, T.decimal(18, 4)),
        "int_div_trunc_and_zero": ir.Arith('/', i64, i32, T.BIGINT),
        "double_div_zero": ir.Arith('/', f64, ir.Cast(i32, T.DOUBLE),
                                    T.DOUBLE),
        "decimal_lt_mixed_scale": ir.Compare('<', d2, d4),
        "decimal_eq_mixed_scale": ir.Compare('=', d4, d2),
        "decimal_ge_literal": ir.Compare('>=', d4, lit(5, D2t)),
        "kleene_and": ir.Logical('and', (ir.Compare('>', i64, zero), b)),
        "kleene_or": ir.Logical('or', (ir.Compare('>', i64, zero), b,
                                       ir.IsNull(nul))),
        "not": ir.Not(b),
        "is_null_all_null": ir.IsNull(nul),
        "is_not_null": ir.IsNull(b, negated=True),
        "in_list": ir.InList(i32, (lit(0, T.INTEGER), lit(2, T.INTEGER))),
        "between": ir.Between(i64, lit(-5, T.BIGINT), lit(20, T.BIGINT)),
        "case": ir.Case(((ir.Compare('>', i64, zero), lit(1, T.BIGINT)),
                         (b, lit(2, T.BIGINT))), None, T.BIGINT),
        "year": ir.ExtractField('year', dt),
        "month": ir.ExtractField('month', dt),
        "day": ir.ExtractField('day', dt),
        "trunc_month": ir.ExtractField('trunc_month', dt, T.DATE),
        "trunc_quarter": ir.ExtractField('trunc_quarter', dt, T.DATE),
        "coalesce_all_null": ir.ScalarFunc('coalesce', (nul, i64),
                                           T.BIGINT),
        "round_decimal": ir.ScalarFunc('round', (d4,), D4t, (2,)),
        "round_double": ir.ScalarFunc('round', (f64,), T.DOUBLE, (1,)),
        "mod": ir.ScalarFunc('mod', (i64, ir.Cast(i32, T.BIGINT)),
                             T.BIGINT),
        "abs": ir.ScalarFunc('abs', (i64,), T.BIGINT),
        "limb_hi": ir.ScalarFunc('$limb_hi', (d2,), T.BIGINT),
        "limb_lo": ir.ScalarFunc('$limb_lo', (d2,), T.BIGINT),
        "null_plus": ir.Arith('+', nul, i64, T.BIGINT),
        "negate_decimal": ir.Negate(d4, D4t),
    }


EXPR_NAMES = sorted(_exprs(jir, jtypes))


@pytest.fixture(scope="module")
def expr_batches():
    arrays, valids = _expr_arrays()
    return (jax_batch(arrays, valids=valids),
            torch_batch(arrays, valids=valids, device="cpu"))


@pytest.mark.parametrize("name", EXPR_NAMES)
def test_eval_expr_matches_reference(expr_batches, name):
    """The reference evaluates under jit, as its queries run it: XLA's
    rewrites (a division by a constant becomes a multiplication by its
    reciprocal) are part of what the port must equal."""
    jb, tb = expr_batches
    expr = _exprs(jir, jtypes)[name]
    jd, jv = jax.jit(lambda b: jproj.eval_expr(expr, b))(jb)
    td, tv = tproj.eval_expr(_exprs(tir, ttypes)[name], tb)
    jd, jv = np.asarray(jd), np.asarray(jv)
    td, tv = td.numpy(), tv.numpy()
    assert np.array_equal(tv, jv)
    assert td.dtype == jd.dtype, (td.dtype, jd.dtype)
    # values only matter where valid (NULL slots hold don't-care data)
    assert np.array_equal(td[tv], jd[jv], equal_nan=True)


def test_half_up_boundaries_exact():
    """1.2345 -> 1.23, 1.2350 -> 1.24, -1.2350 -> -1.24, 0.0050 -> 0.01."""
    x = torch.tensor([12345, 12350, -12350, 50, -50, 49], dtype=torch.int64)
    assert tproj.rescale(x, 4, 2).tolist() == [123, 124, -124, 1, -1, 0]


def test_filter_zero_selectivity_and_project(expr_batches):
    jb, tb = expr_batches
    pred_j = jir.Compare('>', jir.ColumnRef(2, jtypes.BIGINT),
                         jir.Literal(10 ** 9, jtypes.BIGINT))
    pred_t = tir.Compare('>', tir.ColumnRef(2, ttypes.BIGINT),
                         tir.Literal(10 ** 9, ttypes.BIGINT))
    ex = _exprs(jir, jtypes)
    et = _exprs(tir, ttypes)
    names = ("rescale_half_up", "kleene_or", "year")
    jout = jproj.filter_project(jb, pred_j, tuple(ex[n] for n in names))
    tout = tproj.filter_project(tb, pred_t, tuple(et[n] for n in names))
    assert not tout.live.any()
    ja, _ = jax_to_numpy(jout)
    ta, _ = torch_to_numpy(tout)
    assert [len(a) for a in ta] == [len(a) for a in ja] == [0, 0, 0]
    # non-empty filter: same rows survive
    jout = jproj.apply_filter(jb, ex["kleene_and"])
    tout = tproj.apply_filter(tb, et["kleene_and"])
    assert np.array_equal(tout.live.numpy(), np.asarray(jout.live))


# --------------------------------------------------------------------------
# aggregation
# --------------------------------------------------------------------------

def _agg_data(n, seed, empty=False):
    rng = np.random.default_rng(seed)
    arrays = [rng.integers(0, 6, n), rng.integers(-20, 300, n),
              rng.integers(-(1 << 50), 1 << 50, n), rng.normal(size=n),
              rng.integers(-9, 9, n)]
    valids = [rng.random(n) > 0.1, rng.random(n) > 0.1,
              rng.random(n) > 0.1, rng.random(n) > 0.1, np.zeros(n, bool)]
    if empty:
        arrays = [a[:0] for a in arrays]
        valids = [v[:0] for v in valids]
    return arrays, valids


AGGS = (("sum", 2), ("count", 2), ("min", 2), ("max", 2),
        ("count_star", None), ("sum", 4), ("min", 4), ("max", 3),
        ("sum", 3))


def _specs(aggs, distinct=()):
    return (tuple(jagg.AggSpec(f, a, i in distinct)
                  for i, (f, a) in enumerate(aggs)),
            tuple(tagg.AggSpec(f, a, i in distinct)
                  for i, (f, a) in enumerate(aggs)))


def rows_of(arrays, valids):
    n = len(arrays[0]) if arrays else 0
    return [tuple(a[i].item() if v[i] else None
                  for a, v in zip(arrays, valids)) for i in range(n)]


def _close(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return math.isclose(a, b, rel_tol=1e-12, abs_tol=1e-9)
    return a == b


def assert_rows(got, want, ordered=True):
    if not ordered:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(map(_close, g, w)), (g, w)


@pytest.mark.parametrize("empty", [False, True])
def test_global_aggregate(empty):
    arrays, valids = _agg_data(500, 1, empty)
    jaggs, taggs = _specs(AGGS)
    jout = jagg.global_aggregate(jax_batch(arrays, valids=valids), jaggs)
    tout = tagg.global_aggregate(
        torch_batch(arrays, valids=valids, device="cpu"), taggs)
    assert_rows(rows_of(*torch_to_numpy(tout)),
                rows_of(*jax_to_numpy(jout)))


@pytest.mark.parametrize("empty", [False, True])
def test_direct_group_aggregate(empty):
    arrays, valids = _agg_data(500, 2, empty)
    jaggs, taggs = _specs(AGGS)
    jout = jagg.direct_group_aggregate(jax_batch(arrays, valids=valids),
                                       (0,), (6,), jaggs)
    tout = tagg.direct_group_aggregate(
        torch_batch(arrays, valids=valids, device="cpu"), (0,), (6,), taggs)
    assert_rows(rows_of(*torch_to_numpy(tout)),
                rows_of(*jax_to_numpy(jout)))


@pytest.mark.parametrize("gather_mode", ["off", "on"])
@pytest.mark.parametrize("keys", [(0,), (0, 1)])
def test_sort_group_aggregate(keys, gather_mode):
    arrays, valids = _agg_data(700, 3)
    jaggs, taggs = _specs(AGGS)
    jout = jagg.sort_group_aggregate(jax_batch(arrays, valids=valids), keys,
                                     jaggs, 2048)
    tout = tagg.sort_group_aggregate(
        torch_batch(arrays, valids=valids, device="cpu"), keys, taggs, 2048,
        gather_mode)
    # groups come out in key order on both sides
    assert_rows(rows_of(*torch_to_numpy(tout)),
                rows_of(*jax_to_numpy(jout)))


def test_sort_group_aggregate_distinct_and_overflow():
    arrays, valids = _agg_data(700, 4)
    aggs = (("count", 1), ("sum", 1), ("count_star", None))
    jaggs, taggs = _specs(aggs, distinct=(0, 1))
    for cap in (2048, 3):                 # 3: groups past it are dropped
        jout = jagg.sort_group_aggregate(jax_batch(arrays, valids=valids),
                                         (0,), jaggs, cap)
        tout = tagg.sort_group_aggregate(
            torch_batch(arrays, valids=valids, device="cpu"), (0,), taggs,
            cap)
        assert_rows(rows_of(*torch_to_numpy(tout)),
                    rows_of(*jax_to_numpy(jout)))


def test_packed_sort_group_aggregate_multiword():
    arrays, valids = _agg_data(900, 5)
    # keys of 3 + 9 + 52 bits: more than one 62-bit word
    keys = (0, 1, 2)
    jaggs, taggs = _specs((("sum", 3), ("count_star", None)))
    jb = jax_batch(arrays, valids=valids)
    tb = torch_batch(arrays, valids=valids, device="cpu")
    jk, jbits, jsplit = jagg.key_pack_plan_words(jb, keys)
    tk, tbits, tsplit = tagg.key_pack_plan_words(tb, keys)
    assert (list(tk), tbits, tsplit) == (list(jk), jbits, jsplit)
    assert len(tsplit) == 2
    jout = jagg.packed_sort_group_aggregate(jb, jnp.asarray(jk), keys,
                                            jbits, jaggs, 2048, jsplit)
    tout = tagg.packed_sort_group_aggregate(tb, tk, keys, tbits, taggs,
                                            2048, tsplit, "on")
    assert_rows(rows_of(*torch_to_numpy(tout)),
                rows_of(*jax_to_numpy(jout)))


def test_avg_decimal_finalize_half_up():
    sums = np.array([5, -5, 15, -15, 14, -14, 0, 7], np.int64)
    counts = np.array([2, 2, 10, 10, 10, 10, 3, 0], np.int64)
    want = jagg.avg_decimal_finalize(sums, counts)
    got = tagg.avg_decimal_finalize(torch.from_numpy(sums),
                                    torch.from_numpy(counts), xp=torch)
    assert got.tolist() == want.tolist() == [3, -3, 2, -2, 1, -1, 0, 7]


# --------------------------------------------------------------------------
# sort / limit
# --------------------------------------------------------------------------

def _sort_data():
    rng = np.random.default_rng(6)
    n = 300
    arrays = [rng.integers(0, 5, n), rng.normal(size=n),
              rng.permutation(n).astype(np.int64)]     # unique tiebreak
    valids = [rng.random(n) > 0.2, rng.random(n) > 0.2, None]
    return arrays, valids


@pytest.mark.parametrize("asc,nf", [(True, False), (False, True),
                                    (True, True), (False, False)])
def test_sort_batch(asc, nf):
    arrays, valids = _sort_data()
    keys = ((0, asc, nf), (1, not asc, nf), (2, True, False))
    jout = jsort.sort_batch(jax_batch(arrays, valids=valids), keys, None)
    tout = tsort.sort_batch(torch_batch(arrays, valids=valids,
                                        device="cpu"), keys, None)
    assert_rows(rows_of(*torch_to_numpy(tout)),
                rows_of(*jax_to_numpy(jout)))


def test_sort_packed_topn_and_limit():
    arrays, valids = _sort_data()
    keys = ((0, False, True), (2, True, False))
    jb = jax_batch(arrays, valids=valids)
    tb = torch_batch(arrays, valids=valids, device="cpu")
    jk, jbits = jsort.sort_pack_plan(jb, keys)
    tk, tbits = tsort.sort_pack_plan(tb, keys)
    jout = jsort.sort_batch_packed(jb, jnp.asarray(jk), keys, jbits, 17)
    tout = tsort.sort_batch_packed(tb, tk, keys, tbits, 17)
    assert_rows(rows_of(*torch_to_numpy(tout)),
                rows_of(*jax_to_numpy(jout)))
    jl = jsort.limit_batch(jb, jnp.asarray(5, dtype=jnp.int64))
    tl = tsort.limit_batch(tb, 5)
    assert np.array_equal(tl.live.numpy(), np.asarray(jl.live))


# --------------------------------------------------------------------------
# joins
# --------------------------------------------------------------------------

def _join_data(dup=False):
    rng = np.random.default_rng(8)
    nb, npr = 300, 900
    bkeys = rng.permutation(400)[:nb].astype(np.int64)
    if dup:
        bkeys[::5] = bkeys[1::5][:len(bkeys[::5])]
    build = ([bkeys, rng.integers(0, 99, nb), rng.normal(size=nb)],
             [rng.random(nb) > 0.05, rng.random(nb) > 0.1, None])
    probe = ([rng.integers(-5, 420, npr), rng.integers(0, 9, npr)],
             [rng.random(npr) > 0.05, None])
    return build, probe


def _pair(data):
    arrays, valids = data
    return (jax_batch(arrays, valids=valids),
            torch_batch(arrays, valids=valids, device="cpu"))


def _rows(batch, to_numpy):
    return rows_of(*to_numpy(batch))


@pytest.mark.parametrize("gather_mode", ["off", "on"])
@pytest.mark.parametrize("kind", ["inner", "left"])
def test_dense_join(kind, gather_mode):
    build, probe = _join_data()
    jb, tb = _pair(build)
    jp, tp = _pair(probe)
    jout, jdup, joob = jjoin.join_unique_build_dense(jp, jb, (0,), (0,),
                                                     kind, 512)
    tout, tdup, toob = tjoin.join_unique_build_dense(tp, tb, (0,), (0,),
                                                     kind, 512, gather_mode)
    assert (int(tdup), int(toob)) == (int(jdup), int(joob)) == (0, 0)
    assert_rows(_rows(tout, torch_to_numpy), _rows(jout, jax_to_numpy))


def test_dense_probe_and_compacted_phase_two():
    build, probe = _join_data()
    jb, tb = _pair(build)
    jp, tp = _pair(probe)
    jsrc, jm, jdup, joob, jlive = jjoin.dense_probe(jp, jb, (0,), (0,), 512)
    tsrc, tm, tdup, toob, tlive = tjoin.dense_probe(tp, tb, (0,), (0,), 512,
                                                    "on")
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert int(tlive) == int(jlive)
    cap = 1024
    jout = jjoin.dense_join_compacted(jp, jsrc, jm, jb, (0,), (0,), cap)
    tout = tjoin.dense_join_compacted(tp, tsrc, tm, tb, (0,), (0,), cap,
                                      "on")
    assert_rows(_rows(tout, torch_to_numpy), _rows(jout, jax_to_numpy))


def test_dense_lut_reports_duplicates_and_out_of_domain():
    build, probe = _join_data(dup=True)
    jb, tb = _pair(build)
    jp, tp = _pair(probe)
    for domain in (512, 100):                 # 100: keys escape the domain
        _, jdup, joob = jjoin.join_unique_build_dense(jp, jb, (0,), (0,),
                                                      "inner", domain)
        _, tdup, toob = tjoin.join_unique_build_dense(tp, tb, (0,), (0,),
                                                      "inner", domain)
        assert (int(tdup), int(toob)) == (int(jdup), int(joob))
        assert int(tdup) > 0


@pytest.mark.parametrize("kind", ["inner", "left"])
def test_merge_and_sorted_unique_joins(kind):
    build, probe = _join_data()
    jb, tb = _pair(build)
    jp, tp = _pair(probe)
    jout, jdup = jjoin.join_unique_build_merge(jp, jb, (0,), (0,), kind)
    tout, tdup = tjoin.join_unique_build_merge(tp, tb, (0,), (0,), kind)
    assert int(tdup) == int(jdup) == 0
    assert_rows(_rows(tout, torch_to_numpy), _rows(jout, jax_to_numpy),
                ordered=False)
    jout, jdup = jjoin.join_unique_build(jp, jb, (0,), (0,), kind)
    tout, tdup = tjoin.join_unique_build(tp, tb, (0,), (0,), kind)
    assert int(tdup) == int(jdup) == 0
    assert_rows(_rows(tout, torch_to_numpy), _rows(jout, jax_to_numpy))


@pytest.mark.parametrize("domain", [None, 512])
@pytest.mark.parametrize("kind", ["inner", "left"])
def test_join_expand_duplicate_build(kind, domain):
    build, probe = _join_data(dup=True)
    jb, tb = _pair(build)
    jp, tp = _pair(probe)
    jout, jtotal, joob = jjoin.join_expand(jp, jb, (0,), (0,), kind, 2048,
                                           domain)
    tout, ttotal, toob = tjoin.join_expand(tp, tb, (0,), (0,), kind, 2048,
                                           domain)
    assert (int(ttotal), int(toob)) == (int(jtotal), int(joob))
    assert_rows(_rows(tout, torch_to_numpy), _rows(jout, jax_to_numpy),
                ordered=False)


@pytest.mark.parametrize("cap", [1024, 2048])
def test_compact_live(cap):
    build, _ = _join_data()
    arrays, valids = build
    live = np.random.default_rng(12).random(len(arrays[0])) > 0.5
    jb, tb = _pair(build)
    jb = jb.with_live(jb.live & jnp.asarray(np.pad(live, (0, jb.capacity
                                                          - len(live)))))
    tb = tb.with_live(tb.live & torch.from_numpy(
        np.pad(live, (0, tb.capacity - len(live)))))
    jout, jover = jjoin.compact_live(jb, cap)
    tout, tover = tjoin.compact_live(tb, cap)
    assert int(tover) == int(jover) == 0
    assert np.array_equal(tout.live.numpy(), np.asarray(jout.live))
    assert_rows(_rows(tout, torch_to_numpy), _rows(jout, jax_to_numpy))
