"""The port's page frames and exchange spool (trino_tpu_torch/server/
pageserde.py, exchange_spool.py) against the reference's: the same
arrays give the same TPG2 frame, byte for byte, for every lane dtype
with NULLs, compressed or not; the spool round-trips a work unit's pages
and answers a corrupt container with a miss."""

import numpy as np
import pytest

from trino_tpu.server import pageserde as jpage
from trino_tpu_torch.metrics import PAGE_CRC_FAILURES, SPOOL_MISSES
from trino_tpu_torch.server import pageserde as tpage
from trino_tpu_torch.server.exchange_spool import ExchangeSpool
from trino_tpu_torch.server.failureinjector import FailureInjector

LANES = [np.int8, np.int16, np.int32, np.int64, np.uint8, np.float32,
         np.float64, np.bool_]


def _page(dtype, rows: int, seed: int):
    rng = np.random.default_rng(seed)
    if dtype is np.bool_:
        data = rng.integers(0, 2, rows).astype(np.bool_)
    elif np.issubdtype(dtype, np.floating):
        data = rng.standard_normal(rows).astype(dtype)
    else:
        info = np.iinfo(dtype)
        data = rng.integers(info.min, info.max, rows,
                            dtype=np.int64).astype(dtype)
    valid = rng.random(rows) > 0.2                       # NULLs
    return data, valid


@pytest.mark.parametrize("rows", [0, 7, 3000])
@pytest.mark.parametrize("dtype", LANES, ids=lambda d: np.dtype(d).name)
def test_encode_page_bytes_equal_reference(dtype, rows):
    data, valid = _page(dtype, rows, seed=rows)
    key = np.arange(rows, dtype=np.int64)
    arrays, valids = [key, data], [np.ones(rows, np.bool_), valid]
    frame = tpage.encode_page(arrays, valids)
    assert frame == jpage.encode_page(arrays, valids)
    got_a, got_v = tpage.decode_page(frame)
    for a, b in zip(got_a, arrays):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for a, b in zip(got_v, valids):
        assert np.array_equal(a, b)


def test_spool_round_trip_and_corrupt_container_is_a_miss(tmp_path):
    spool = ExchangeSpool(root=str(tmp_path))
    pages = [tpage.encode_page([a], [v]) for a, v in
             (_page(np.int64, 500, 1), _page(np.float64, 900, 2))]
    spool.put("w1", pages)
    assert spool.get("w1") == pages
    # flip one byte inside the second frame's body
    path = tmp_path / "w1.spool"
    blob = bytearray(path.read_bytes())
    blob[-5] ^= 0x40
    path.write_bytes(bytes(blob))
    c0, m0 = PAGE_CRC_FAILURES.value(), SPOOL_MISSES.value()
    assert spool.get("w1") is None
    assert spool.checksum_rejects == 1
    assert PAGE_CRC_FAILURES.value() - c0 == 1
    assert SPOOL_MISSES.value() - m0 == 1
    assert not path.exists()                 # dropped for the retry


def test_spool_write_faults_are_skips_not_errors(tmp_path):
    inj = FailureInjector()
    inj.inject("SPOOL_WRITE", times=1, fault="RAISE")
    inj.inject("SPOOL_WRITE", times=1, fault="CORRUPT")
    spool = ExchangeSpool(root=str(tmp_path), injector=inj)
    data, valid = _page(np.int32, 64, 3)
    page = tpage.encode_page([data], [valid])
    spool.put("a", [page])                   # RAISE: skipped
    assert spool.write_skips == 1 and spool.get("a") is None
    spool.put("b", [page])                   # CORRUPT: caught on read
    assert spool.get("b") is None and spool.checksum_rejects == 1
    spool.put("c", [page])
    assert spool.get("c") == [page]
    assert inj.injected_count == 2
