"""The reference's float summation orders in the port.

XLA's CPU backend computes the reference's ``jnp.cumsum`` as a blocked
scan (blocks of 16, recursive, carry added as ``inner + carry``) and its
``jnp.sum`` as recursive reduce-windows of 32; the port's
``cumsum_like_reference`` and ``sum_like_reference`` follow those orders,
so the sort strategy's segment sums, the window sums and the direct and
global sums over DOUBLE carry the reference's bits.

Tolerance: none. The helpers equal ``jax.jit(jnp.cumsum)`` and
``jax.jit(jnp.sum)`` bit for bit on seeded float64 arrays, and the SQL
probes equal the JAX Session's rows exactly."""

import numpy as np
import pytest
import torch

import trino_tpu  # noqa: F401  (jax_enable_x64 before any array)
import jax
import jax.numpy as jnp

from trino_tpu.catalog import Catalog as JaxCatalog
from trino_tpu.connectors.tpch.connector import TpchConnector
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu_torch.catalog import catalog_from_tables
from trino_tpu_torch.exec.session import Session
from trino_tpu_torch.ops.aggregate import (cumsum_like_reference,
                                           sum_like_reference)

# pytest-xdist runs one process per core: one torch thread each keeps
# the CPU tests from oversubscribing the cores
torch.set_num_threads(1)


def _doubles(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) * rng.integers(1, 10 ** 6, n)


def _bits(a):
    return np.asarray(a, dtype=np.float64).view(np.int64)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 257, 100_003])
def test_cumsum_equals_reference_bits(n):
    x = _doubles(n, n)
    want = jax.jit(jnp.cumsum)(jnp.asarray(x))
    got = cumsum_like_reference(torch.from_numpy(x))
    assert np.array_equal(_bits(got.numpy()), _bits(want))


def test_cumsum_of_integers_is_exact():
    x = np.random.default_rng(3).integers(-(1 << 40), 1 << 40, 5000)
    got = cumsum_like_reference(torch.from_numpy(x))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), np.cumsum(x))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1003, 3072, 100_352])
def test_sum_equals_reference_bits(n):
    x = _doubles(n, 7 * n)
    mask = np.random.default_rng(n).random(n) < 0.7
    want = jax.jit(lambda m, v: jnp.where(m, v, 0).sum())(
        jnp.asarray(mask), jnp.asarray(x))
    got = sum_like_reference(torch.where(torch.from_numpy(mask),
                                         torch.from_numpy(x), 0))
    assert _bits(got.item()) == _bits(float(want))


@pytest.fixture(scope="module")
def sessions():
    conn = TpchConnector()
    tables = {"lineitem": conn.get_table("tiny", "lineitem")}
    cat = JaxCatalog()
    cat.register("tpch", conn)
    return (JaxSession(cat, default_schema="tiny"),
            Session(catalog_from_tables(tables), default_schema="tiny",
                    device="cpu"))


# the sort strategy (segment cumsums), then the direct and global
# strategies (sums)
PROBES = [
    "SELECT l_suppkey, sum(CAST(l_extendedprice AS double) * l_discount) "
    "FROM lineitem GROUP BY l_suppkey",
    "SELECT l_partkey, avg(CAST(l_quantity AS double) * 1.1) "
    "FROM lineitem GROUP BY l_partkey",
    "SELECT l_returnflag, sum(CAST(l_extendedprice AS double) * l_discount) "
    "FROM lineitem GROUP BY l_returnflag",
    "SELECT sum(CAST(l_extendedprice AS double) * l_tax) FROM lineitem",
]


@pytest.mark.parametrize("sql", PROBES)
def test_double_sums_equal_reference(sessions, sql):
    reference, port = sessions
    want = sorted(reference.execute(sql).rows, key=repr)
    got = sorted(port.execute(sql).rows, key=repr)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:-1] == w[:-1]
        assert _bits(g[-1]) == _bits(w[-1])
