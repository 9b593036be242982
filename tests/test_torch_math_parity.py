"""sqrt, exp, ln and power on the port (trino_tpu_torch/ops/project.py)
against the reference's compiled code, bit for bit, on the CPU.

XLA's CPU backend lowers sqrt to the correctly rounded instruction, ln and
power to glibc's `log` and `pow`, and exp to its own `xla.exp.f64`, whose
adds LLVM contracts into fused multiply-adds; the compiled code flushes
subnormals to zero. Seeded float64 arrays with edge values (zeros,
subnormals, infinities, NaN, exp's overflow and underflow edges, negative
power bases) go through `jax.jit` of each `jnp` function and through the
port's replay; SQL over `tpch.tiny` goes through both Sessions. The fused
multiply-add the replays use is held to glibc's `fma`."""

import ctypes
import ctypes.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trino_tpu.exec.session import Session as JaxSession
from trino_tpu_torch.exec.session import Session
from trino_tpu_torch.ops import project as P

torch.set_num_threads(1)

EDGES = np.array([
    0.0, -0.0, 5e-324, -5e-324, 1e-310, -1e-310, 2.2250738585072014e-308,
    -2.2250738585072014e-308, 1e-300, np.inf, -np.inf, np.nan, 1.0, -1.0,
    0.5, 2.0, 1e300, -1e300, 1e-16, 709.782712893384, 709.7827128933841,
    709.78271289338397, 710.0, 800.0, -708.3964185322641,
    -708.3964185322642, -708.396418532264, -708.5, -745.1332191019411,
    -745.2, -800.0, 7.0e2, -7.0e2])


def _values(seed: int, n: int = 60_000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([
        EDGES, rng.uniform(-750, 750, n), rng.normal(0, 1, n),
        rng.uniform(-1e-3, 1e-3, n // 10),
        rng.normal(0, 1, n) * 10.0 ** rng.integers(-300, 300, n)])


def _same_bits(got: np.ndarray, want: np.ndarray) -> int:
    """Values whose bits differ (NaNs of any payload count as equal)."""
    both_nan = np.isnan(got) & np.isnan(want)
    return int((~both_nan & (got.view(np.int64) !=
                             want.view(np.int64))).sum())


@pytest.fixture(scope="module", autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


@pytest.mark.parametrize("seed", [0, 1])
def test_exp_equals_xla_bits(seed):
    x = _values(seed)
    want = np.asarray(jax.jit(jnp.exp)(x))
    got = P.exp_like_reference(torch.from_numpy(x)).numpy()
    assert _same_bits(got, want) == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_sqrt_equals_xla_bits(seed):
    x = np.abs(_values(seed))
    want = np.asarray(jax.jit(jnp.sqrt)(x))
    got = P.sqrt_like_reference(torch.from_numpy(x)).numpy()
    assert _same_bits(got, want) == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_log_equals_xla_bits(seed):
    x = _values(seed)
    x = np.where(x > 0, x, 1.0)        # the SQL branch's domain mask
    want = np.asarray(jax.jit(jnp.log)(x))
    got = P.log_like_reference(torch.from_numpy(x)).numpy()
    assert _same_bits(got, want) == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_power_equals_xla_bits(seed):
    rng = np.random.default_rng(seed + 10)
    x = _values(seed)
    for y in (rng.uniform(-50, 50, x.size),            # negative bases
              np.round(rng.uniform(-6, 6, x.size)),      # integral powers
              np.full(x.size, 1.5),
              rng.choice(EDGES, x.size)):
        want = np.asarray(jax.jit(jnp.power)(x, y))
        got = P.pow_like_reference(torch.from_numpy(x),
                                   torch.from_numpy(y)).numpy()
        assert _same_bits(got, want) == 0


def test_fma_equals_glibc():
    libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    libm.fma.restype = ctypes.c_double
    libm.fma.argtypes = [ctypes.c_double] * 3
    fma = np.frompyfunc(libm.fma, 3, 1)
    rng = np.random.default_rng(3)
    n = 50_000
    a = rng.normal(0, 1, n) * 10.0 ** rng.integers(-40, 40, n)
    b = rng.normal(0, 1, n) * 10.0 ** rng.integers(-40, 40, n)
    cases = [(rng.integers(-10 ** 9, 10 ** 9, n).astype(np.float64),
              rng.choice([0.01, 0.07, 1 / 3, 0.011000000000000001], n),
              rng.integers(0, 10 ** 7, n) * 0.01),
             (a, b, rng.normal(0, 1, n) * 10.0 ** rng.integers(-80, 80, n)),
             (a, b, -(a * b)),                                 # cancellation
             (a, b, -(a * b) * (1 + rng.normal(0, 1e-15, n)))]
    for x, y, z in cases:
        want = fma(x, y, z).astype(np.float64)
        got = P.fma_like_reference(*(torch.from_numpy(np.ascontiguousarray(v))
                                     for v in (x, y, z))).numpy()
        assert _same_bits(got, want) == 0


@pytest.fixture(scope="module")
def sessions():
    return (JaxSession(default_schema="tiny"),
            Session(default_schema="tiny", device="cpu"))


@pytest.mark.parametrize("sql", [
    "SELECT exp(l_discount) FROM lineitem",
    "SELECT sqrt(l_quantity) FROM lineitem",
    "SELECT sqrt(CAST(l_extendedprice AS double)) FROM lineitem",
    "SELECT ln(l_extendedprice) FROM lineitem",
    "SELECT power(CAST(l_quantity AS double), 1.5) FROM lineitem",
    "SELECT exp(CAST(l_discount AS double) * 10) FROM lineitem",
    "SELECT l_partkey, stddev(l_extendedprice) FROM lineitem "
    "GROUP BY l_partkey ORDER BY l_partkey",
])
def test_sql_math_equals_reference(sessions, sql):
    js, ts = sessions
    want, got = js.execute(sql).rows, ts.execute(sql).rows
    assert len(got) == len(want)
    assert np.array([r[-1] for r in got], np.float64).tobytes() == \
        np.array([r[-1] for r in want], np.float64).tobytes()
    assert [r[:-1] for r in got] == [r[:-1] for r in want]
