"""K1 (trino_tpu_torch/ops/gather.py) against the reference's
`pallas_gather.gather_columns` in interpret mode, on the same numpy
inputs. Tolerance: bit-exact (integer equality of the raw bytes; NaN
payloads compare equal) for every dtype, fill and miss case.

On the CPU the wrapper runs its plain torch version; the kernel itself
runs only on a card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trino_tpu.ops import pallas_gather as pg
from trino_tpu_torch.ops import gather as k1


def _tables(rng, w):
    return [rng.integers(-(1 << 62), 1 << 62, w),
            rng.integers(-100, 100, w).astype(np.int8),
            rng.integers(0, 2, w).astype(bool),
            rng.normal(size=w),
            rng.normal(size=w).astype(np.float32),
            rng.integers(-(1 << 30), 1 << 30, w).astype(np.int32)]


def _same_bytes(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _both(tables, idx, fills):
    want = pg.gather_columns([jnp.asarray(t) for t in tables],
                             jnp.asarray(idx), fills, mode="interpret")
    got = k1.gather_columns([torch.from_numpy(t) for t in tables],
                            torch.from_numpy(idx), fills)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("n,w", [(3000, 5000), (17, 129)])
def test_gather_matches_reference(n, w):
    rng = np.random.default_rng(n + w)
    tables = _tables(rng, w)
    idx = rng.integers(0, w, n)
    got, want = _both(tables, idx, [0, -1, False, 0.0, 0.0, 7])
    for g, wv in zip(got, want):
        assert _same_bytes(g, wv)


def test_gather_misses_and_wild_indices_fill():
    fills = [-5, 3, True, 2.5, -1.5, -7]
    rng = np.random.default_rng(5)
    w, n = 2048, 1500
    tables = _tables(rng, w)
    idx = rng.integers(0, w, n)
    idx[::7] = -1                                # miss sentinel
    idx[::11] = w + 3                            # past the end
    idx[::13] = -(1 << 62)                       # wild negative
    idx[::17] = 1 << 62                          # wild positive
    got, want = _both(tables, idx, fills)
    for g, wv in zip(got, want):
        assert _same_bytes(g, wv)
    miss = (idx < 0) | (idx >= w)
    assert (got[0][miss] == fills[0]).all()


def test_gather_many_tables():
    """More tables than one kernel launch carries: exact per table
    (against numpy's take; the launch grouping itself runs on a card)."""
    rng = np.random.default_rng(1)
    w, n = 1000, 900
    tables = [rng.integers(-(1 << 50), 1 << 50, w)
              for _ in range(k1.MAX_TABLES + 3)]
    idx = rng.integers(0, w, n)
    got = k1.gather_columns([torch.from_numpy(t) for t in tables],
                            torch.from_numpy(idx))
    for g, t in zip(got, tables):
        assert np.array_equal(g.numpy(), t[idx])


def test_dtype_gate_and_no_fallback_off_cpu():
    t = torch.arange(10)
    assert k1.supports_tables([t, t.to(torch.float32), t > 3])
    assert not k1.supports_tables([t.to(torch.complex64)])
    assert not k1.supports_tables([t.reshape(2, 5)])
    assert not k1.supports_tables([])
    with pytest.raises(ValueError):
        k1.gather_columns([t.to(torch.complex64)], t)
    # a tensor that is neither on the CPU nor on a card gets no plain
    # fallback: the wrapper raises
    meta = torch.empty(10, dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError):
        k1.gather_columns([meta], meta)


@pytest.mark.parametrize("setting,mode", [("auto", "on"), ("true", "on"),
                                          ("1", "on"), ("false", "off"),
                                          ("0", "off")])
def test_resolve_mode(setting, mode):
    assert k1.resolve_mode(setting) == mode

