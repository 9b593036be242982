"""The fact-column cache (trino_tpu_torch/exec/device_cache.py) against the
reference's (trino_tpu/exec/device_cache.py), on the same numpy columns:
the transfer encodings (encoded bytes equal, decoded on a torch device
to the original column and to the reference's decode), the narrowing
rule, what a load puts on the device, and the disk tier's fingerprint
check. Tolerance: exact equality of bytes, dtypes and values."""

import numpy as np
import pytest
import torch

import jax

from trino_tpu.batch import Field, Schema
from trino_tpu.exec import device_cache as jdc
from trino_tpu.types import BIGINT, INTEGER
from trino_tpu_torch.exec import device_cache as tdc

# pytest-xdist runs one process per core: one torch thread each keeps
# the CPU tests from oversubscribing the cores
torch.set_num_threads(1)


def _cases():
    rng = np.random.default_rng(3)
    return [
        np.sort(rng.integers(0, 1 << 30, 100_000)).astype(np.int32),
        rng.integers(-1 << 40, 1 << 40, 50_000).astype(np.int64),
        rng.integers(0, 120, 10_000).astype(np.int8),
        rng.integers(-(1 << 15), 1 << 15, 30_000).astype(np.int16),
        rng.integers(-(1 << 31), (1 << 31) - 1, 20_000).astype(np.int32),
        rng.integers(-(1 << 62), 1 << 62, 20_000),
        np.arange(100_000, dtype=np.int32) * 3,          # pure delta
        np.sort(rng.integers(-(1 << 62), 1 << 62, 5000)),
        rng.normal(size=1000),                           # float: raw
        np.asarray([7], dtype=np.int32),                 # size < 2: raw
    ]


@pytest.mark.parametrize("case", range(len(_cases())))
def test_transfer_encodings_round_trip(case):
    arr = _cases()[case]
    enc, payload, meta = tdc.encode_transfer(arr)
    jenc, jpayload, jmeta = jdc.encode_transfer(arr)
    assert (enc, meta) == (jenc, jmeta)
    assert payload.dtype == jpayload.dtype and \
        payload.tobytes() == jpayload.tobytes()
    meta = dict(meta, enc=enc, dtype=str(arr.dtype))
    got = tdc.decode_transfer(enc, torch.from_numpy(
        np.ascontiguousarray(payload)), meta).numpy()
    want = np.asarray(jdc.decode_transfer(enc, jax.device_put(
        np.ascontiguousarray(jpayload)), meta))
    assert got.dtype == arr.dtype == want.dtype
    assert np.array_equal(got, arr) and np.array_equal(got, want)


def test_narrow_dtype_equals_reference():
    rng = np.random.default_rng(5)
    cols = [np.arange(100, dtype=np.int64),
            np.asarray([-129, 5], dtype=np.int64),
            np.asarray([0, 40_000], dtype=np.int64),
            np.asarray([0, 1 << 40], dtype=np.int64),
            np.asarray([-(1 << 31), (1 << 31) - 1], dtype=np.int64),
            np.zeros(0, dtype=np.int64),
            rng.normal(size=10),
            np.asarray([True, False])]
    for arr in cols:
        for valid in (None, np.arange(len(arr)) % 2 == 0):
            assert tdc._narrow_dtype(arr, valid) == \
                jdc._narrow_dtype(arr, valid)
    # invalid slots do not widen the choice
    arr = np.asarray([1, 1 << 40, 3], dtype=np.int64)
    valid = np.asarray([True, False, True])
    assert tdc._narrow_dtype(arr, valid) == np.int8


class _Table:
    def __init__(self, cols, valids=None):
        self.columns = [np.asarray(c) for c in cols]
        self.valids = valids
        self.num_rows = len(self.columns[0])
        self.schema = Schema.of(*[Field(f"c{i}", BIGINT if
                                        c.dtype == np.int64 else INTEGER)
                                  for i, c in enumerate(self.columns)])


def test_load_puts_the_reference_columns_on_the_device(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("TRINO_TPU_DATA_CACHE", str(tmp_path))
    rng = np.random.default_rng(8)
    n = 20_000
    t = _Table([np.sort(rng.integers(0, 1 << 24, n)),
                rng.integers(-500, 500, n),
                rng.integers(0, 1 << 40, n),
                rng.integers(0, 100, n).astype(np.int32)],
               valids=[None, rng.random(n) > 0.1, None, None])
    key = ("bench", "s", "t", (0, 1, 2, 3))
    want = jdc.FactTableCache().load(key, t, [0, 1, 2, 3])
    fc = tdc.FactTableCache()
    got = fc.load(key, t, [0, 1, 2, 3], "cpu")
    assert fc.misses == 1 and fc.load(key, t, [0, 1, 2, 3], "cpu") is got
    assert fc.hits == 1
    for g, w in zip(got, want):
        assert str(g.data.dtype).replace("torch.", "") == str(w.data.dtype)
        assert np.array_equal(g.data.numpy(), np.asarray(w.data))
        assert (g.valid is None) == (w.valid is None)
        if g.valid is not None:
            assert np.array_equal(g.valid.numpy(), np.asarray(w.valid))
        assert np.dtype(g.wide_dtype) == np.dtype(w.wide_dtype)
    assert fc.total_bytes() == sum(c.nbytes for c in got)


def test_fact_cache_disk_tier_detects_changed_table(tmp_path, monkeypatch):
    """A regenerated table (same name, new contents) must not serve the
    stale narrowed columns (fingerprint check); an unchanged one loads
    from the disk tier."""
    monkeypatch.setenv("TRINO_TPU_DATA_CACHE", str(tmp_path))
    key = ("bench", "s", "t", (0,))
    fc = tdc.FactTableCache()
    t1 = _Table([np.arange(10_000)])
    c1 = fc.load(key, t1, [0], "cpu", persist_ok=True)
    assert int(c1[0].data[5]) == 5
    assert any(p.name.startswith("narrow_torch_") for p in tmp_path.iterdir())
    fc.invalidate()
    t2 = _Table([np.arange(10_000) * 7])       # regenerated, same shape
    c2 = fc.load(key, t2, [0], "cpu", persist_ok=True)
    assert int(c2[0].data[5]) == 35
    # same contents again: served from the disk tier, same values
    fc.invalidate()
    loaded = []
    real = fc._load_narrow_disk

    def spy(*a):
        out = real(*a)
        loaded.append(out is not None)
        return out
    monkeypatch.setattr(fc, "_load_narrow_disk", spy)
    c3 = fc.load(key, t2, [0], "cpu", persist_ok=True)
    assert loaded == [True]
    assert np.array_equal(c3[0].data.numpy(), c2[0].data.numpy())


def test_budget_rejects_and_evicts(tmp_path, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_DATA_CACHE", str(tmp_path))
    t = _Table([np.arange(10_000) * 100_000])        # int32 narrow: 40 kB
    fc = tdc.FactTableCache(max_bytes=30_000)
    assert fc.load(("bench", "s", "a", (0,)), t, [0], "cpu") is None
    fc = tdc.FactTableCache(max_bytes=90_000)
    fc.load(("bench", "s", "a", (0,)), t, [0], "cpu")
    fc.load(("bench", "s", "b", (0,)), t, [0], "cpu")
    fc.load(("bench", "s", "c", (0,)), t, [0], "cpu")   # evicts "a"
    assert fc.get(("bench", "s", "a", (0,))) is None
    assert fc.get(("bench", "s", "c", (0,))) is not None
    assert fc.total_bytes() <= 90_000
