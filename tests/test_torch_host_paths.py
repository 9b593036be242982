"""Three paths that TPC-DS at SF1 sent through host Python for seconds
to minutes a query, each against the reference on the same inputs:

- the hybrid hash join's escape path (`Executor._partitioned_hash_join`,
  on the device through exec/spill.partitioned_equi_join) against the
  reference's host path (radix partitions joined one by one through
  numpy): the whole output batch, capacity, live mask and every
  column's data and validity byte for byte (row order included, since
  the rows feed float sums downstream);
- the fold of `x IN (subquery)` to an InList (`Executor.
  fold_in_subquery`, vectorised for integer columns) against the
  reference's loop: the literal values, their order and Python types,
  and the Kleene NULL;
- an IN list's evaluation (one `torch.isin` pass) against the
  reference's filter on the same batch.

Tolerance: none."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from trino_tpu.batch import batch_from_numpy as jax_batch
from trino_tpu import ir as jir
from trino_tpu.catalog import default_catalog as jax_catalog
from trino_tpu.exec.executor import Executor as JaxExecutor
from trino_tpu.planner import logical as JL
from trino_tpu import types as jtypes
from trino_tpu.types import BIGINT as JBIGINT
from trino_tpu_torch.batch import batch_from_numpy as torch_batch
from trino_tpu_torch import ir
from trino_tpu_torch.catalog import default_catalog
from trino_tpu_torch.exec.executor import Executor
from trino_tpu_torch.planner import logical as L
from trino_tpu_torch import types as ttypes
from trino_tpu_torch.types import BIGINT

torch.set_num_threads(1)


def _side(rng, n, keys, domain, dead):
    """n rows: `keys` key columns over [0, domain) (some NULL), an int64
    payload, a double payload; a `dead` share of rows not live."""
    arrays = [rng.integers(0, domain, n) for _ in range(keys)]
    arrays += [rng.integers(-(1 << 40), 1 << 40, n), rng.standard_normal(n)]
    valids = [rng.random(n) > 0.05 for _ in range(keys)] + \
        [rng.random(n) > 0.1, None]
    live = rng.random(n) >= dead
    return arrays, valids, live


def _both(arrays, valids, live):
    jb, tb = jax_batch(arrays, valids=valids), \
        torch_batch(arrays, valids=valids, device="cpu")
    pad = jb.capacity - len(live)
    lv = np.concatenate([live, np.zeros(pad, np.bool_)])
    return jb.with_live(jnp.asarray(lv)), tb.with_live(torch.from_numpy(lv))


def _node(mod, bt, kind, keys, width):
    cols = tuple((f"c{i}", bt) for i in range(width))
    vals = mod.ValuesNode(arrays=(), valids=(), num_rows=0, fields=(),
                          output=cols)
    return mod.JoinNode(kind=kind, left=vals, right=vals,
                        left_keys=tuple(range(keys)),
                        right_keys=tuple(range(keys)), residual=None,
                        build_unique=False, output=cols)


CASES = [(kind, keys, nb, expand) for kind in ("inner", "left", "semi",
                                               "anti")
         for keys in (1, 2) for nb in (3000, 150_000)
         for expand in ((None, 4096) if kind in ("inner", "left")
                        else (None,))]


@pytest.mark.parametrize("kind,keys,nb,expand", CASES)
def test_escape_join_equals_reference_batch(kind, keys, nb, expand,
                                            monkeypatch):
    """nb = 150,000 live-ish build rows take 4 partitions (the load cap
    is 65,536 rows); duplicate build keys expand; NULL keys never match;
    dead rows on both sides are dropped; `expand` writes the output 4,096
    rows a slice (on the card a slice is 2^25 rows)."""
    from trino_tpu_torch.exec import spill
    if expand:
        monkeypatch.setattr(spill, "EXPAND_ROWS", expand)
    rng = np.random.default_rng(nb + 10 * keys + len(kind))
    domain = nb // 2 if keys == 1 else 400
    parr, pval, plive = _side(rng, 20_000, keys, domain, 0.1)
    barr, bval, blive = _side(rng, nb, keys, domain, 0.05)
    jp, tp = _both(parr, pval, plive)
    jb, tb = _both(barr, bval, blive)
    jex, tex = JaxExecutor(jax_catalog()), Executor(default_catalog(), "cpu")
    want = jex._partitioned_hash_join(_node(JL, JBIGINT, kind, keys, 8),
                                      jp, jb)
    got = tex._partitioned_hash_join(_node(L, BIGINT, kind, keys, 8),
                                     tp, tb)
    assert got.capacity == want.capacity
    assert np.asarray(want.live).tobytes() == got.live.numpy().tobytes()
    assert len(got.columns) == len(want.columns)
    for w, g in zip(want.columns, got.columns):
        wd = np.asarray(w.data)
        assert wd.dtype == g.data.numpy().dtype
        assert wd.tobytes() == g.data.numpy().tobytes()
        assert np.asarray(w.valid).tobytes() == g.valid.numpy().tobytes()
    assert int(np.asarray(want.live).sum()) > 0


class _Ref:
    """An IN subquery's reference as the fold reads it (hashes by
    identity, like ir.InSubqueryRef)."""

    def __init__(self, arg, arg_field=None, sub_field=None):
        self.arg, self.plan = arg, None
        self.arg_field, self.sub_field = arg_field, sub_field


def _folded(ex, batch, ref):
    ex.run = lambda plan: batch
    out = ex.fold_in_subquery(ref)
    null = not hasattr(out, "values")
    inlist = out.args[0] if null else out
    return [(type(v.value), v.value) for v in inlist.values], null


@pytest.mark.parametrize("kind", ["bigint", "integer", "boolean", "double",
                                  "varchar"])
def test_in_subquery_fold_equals_reference(kind):
    rng = np.random.default_rng(len(kind))
    n = 5000
    col = {"bigint": rng.integers(-(1 << 40), 1 << 40, n) // 7 * 7,
           "integer": rng.integers(0, 300, n).astype(np.int32),
           "boolean": rng.random(n) < 0.3,
           "double": np.round(rng.standard_normal(n), 1),
           "varchar": rng.integers(0, 6, n).astype(np.int32)}[kind]
    valid = rng.random(n) > 0.02
    names = {"bigint": "BIGINT", "integer": "INTEGER",
             "boolean": "BOOLEAN", "double": "DOUBLE",
             "varchar": "VARCHAR"}
    jt, tt = getattr(jtypes, names[kind]), getattr(ttypes, names[kind])
    fields = []
    from trino_tpu import batch as jbatch
    from trino_tpu_torch import batch as tbatch
    for mod, t in ((jbatch, jt), (tbatch, tt)):
        if kind == "varchar":
            # the subquery's pool and the probe's differ; "zz" is absent
            fields.append((mod.Field("a", t, ("b", "c", "x", "a")),
                           mod.Field("s", t, ("a", "b", "c", "d", "e",
                                              "zz"))))
        else:
            fields.append((None, None))
    want = _folded(JaxExecutor(jax_catalog()),
                   jax_batch([col], valids=[valid]),
                   _Ref(jir.ColumnRef(0, jt), *fields[0]))
    got = _folded(Executor(default_catalog(), "cpu"),
                  torch_batch([col], valids=[valid], device="cpu"),
                  _Ref(ir.ColumnRef(0, tt), *fields[1]))
    assert got == want and len(want[0]) > 1 and want[1]


@pytest.mark.parametrize("size", [200, 5])
@pytest.mark.parametrize("dtype", ["int64", "int32", "float64"])
def test_in_list_equals_reference(dtype, size):
    """An IN list (one isin pass in the port) over a column with NULLs,
    -0.0 and 0.0 among the doubles."""
    from trino_tpu.ops.project import apply_filter as japply
    from trino_tpu_torch.ops.project import apply_filter as tapply
    rng = np.random.default_rng(3)
    n = 20_000
    col = rng.integers(-300, 300, n).astype(dtype)
    if dtype == "float64":
        col = col / 4
        col[:10] = -0.0
    valid = rng.random(n) > 0.05
    lits = sorted(set(rng.integers(-300, 300, size).tolist()))
    if dtype == "float64":
        lits = [v / 4 for v in lits] + [0.0]
    jt = {"int64": jtypes.BIGINT, "int32": jtypes.INTEGER,
          "float64": jtypes.DOUBLE}[dtype]
    tt = {"int64": ttypes.BIGINT, "int32": ttypes.INTEGER,
          "float64": ttypes.DOUBLE}[dtype]
    jpred = jir.InList(jir.ColumnRef(0, jt),
                       tuple(jir.Literal(v, jt) for v in lits))
    tpred = ir.InList(ir.ColumnRef(0, tt),
                      tuple(ir.Literal(v, tt) for v in lits))
    want = np.asarray(japply(jax_batch([col], valids=[valid]), jpred).live)
    got = tapply(torch_batch([col], valids=[valid], device="cpu"),
                 tpred).live.numpy()
    assert want.tobytes() == got.tobytes() and 0 < want.sum() < n


def test_boolean_in_list_equals_reference():
    from trino_tpu.ops.project import apply_filter as japply
    from trino_tpu_torch.ops.project import apply_filter as tapply
    rng = np.random.default_rng(5)
    col, valid = rng.random(1000) < 0.3, rng.random(1000) > 0.1
    for lits in ((True,), (False,), (True, False)):
        jpred = jir.InList(jir.ColumnRef(0, jtypes.BOOLEAN), tuple(
            jir.Literal(v, jtypes.BOOLEAN) for v in lits))
        tpred = ir.InList(ir.ColumnRef(0, ttypes.BOOLEAN), tuple(
            ir.Literal(v, ttypes.BOOLEAN) for v in lits))
        want = japply(jax_batch([col], valids=[valid]), jpred).live
        got = tapply(torch_batch([col], valids=[valid], device="cpu"),
                     tpred).live.numpy()
        assert np.asarray(want).tobytes() == got.tobytes()
