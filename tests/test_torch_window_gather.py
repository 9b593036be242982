"""K2 (trino_tpu_torch/ops/gather.py, `gather_word_windowed`) against the
reference's `pallas_gather.gather_word_windowed` in interpret mode, and the
chunked driver's join sites (trino_tpu_torch/ops/join.py) against the
reference's (trino_tpu/ops/join.py), on the same numpy inputs.

Tolerance: bit-exact — words, escape totals, LUT contents, validation
counts, and every column of the join outputs.

On the CPU the K2 wrapper runs its plain torch version; the kernel itself
runs only on a card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trino_tpu.batch import batch_from_numpy as jax_batch
from trino_tpu.ops import join as jjoin
from trino_tpu.ops import pallas_gather as pg
from trino_tpu_torch.batch import batch_from_numpy
from trino_tpu_torch.ops import gather as k2
from trino_tpu_torch.ops import join as tjoin

# pytest-xdist runs one process per core: one torch thread each keeps
# the CPU tests from oversubscribing the cores
torch.set_num_threads(1)

WORDS = ("int8", "int16", "int32", "int64")


def _lut(rng, w, word):
    info = np.iinfo(word)
    return rng.integers(info.min, info.max, w, dtype=np.int64).astype(word)


def _both(lut, idx, word):
    want_w, want_e = pg.gather_word_windowed(
        pg.prepare_word_planes(jnp.asarray(lut)), jnp.asarray(idx), word,
        mode="interpret")
    planes = k2.prepare_word_planes(torch.from_numpy(lut))
    got_w, got_e = k2.gather_word_windowed(planes, torch.from_numpy(idx),
                                           word)
    return (got_w.numpy(), int(got_e)), (np.asarray(want_w), int(want_e))


def _near_sorted(rng, n, w):
    """Ascending keys with small local jitter, as a fact table's
    l_orderkey streams: every 1024-index tile spans well under WIN."""
    base = np.sort(rng.integers(0, w, n))
    return np.clip(base + rng.integers(-3, 4, n), 0, w - 1)


@pytest.mark.parametrize("word", WORDS)
def test_near_sorted_each_word_dtype(word):
    rng = np.random.default_rng(len(word))
    w, n = 40_000, 5000
    lut = _lut(rng, w, word)
    idx = _near_sorted(rng, n, w)
    (gw, ge), (ww, we) = _both(lut, idx, word)
    assert gw.dtype == ww.dtype == np.int64
    assert np.array_equal(gw, ww) and ge == we == 0
    assert np.array_equal(gw, lut[idx].astype(np.int64))


def test_random_indices_escape():
    rng = np.random.default_rng(7)
    w, n = 100_000, 4100                   # a ragged last tile
    lut = _lut(rng, w, "int16")
    idx = rng.integers(0, w, n)
    (gw, ge), (ww, we) = _both(lut, idx, "int16")
    assert np.array_equal(gw, ww)
    assert ge == we > 0
    # an escaped row reads 0; a resolved one reads its word
    assert ((gw == 0) | (gw == lut[idx])).all()


def test_misses_and_out_of_range():
    """-1, negative, past-the-LUT and past-the-padding indices: anything
    outside [0, padded length) is a miss (never an escape); indices in
    the padding read the pad word 0."""
    rng = np.random.default_rng(3)
    w, n = 20_000, 3072
    lut = _lut(rng, w, "int32")
    idx = _near_sorted(rng, n, w)
    idx[::9] = -1
    idx[5::17] = -(1 << 40)
    idx[7::23] = 1 << 40
    padded = k2.prepare_word_planes(torch.from_numpy(lut)).shape[0]
    idx[11::29] = padded + 5
    (gw, ge), (ww, we) = _both(lut, idx, "int32")
    assert np.array_equal(gw, ww) and ge == we
    miss = (idx < 0) | (idx >= padded)
    assert (gw[miss] == 0).all()


@pytest.mark.parametrize("w", [100, 9000])
def test_lut_shorter_than_two_windows(w):
    rng = np.random.default_rng(w)
    lut = _lut(rng, w, "int64")
    idx = rng.integers(-5, w + 5, 2500)
    (gw, ge), (ww, we) = _both(lut, idx, "int64")
    assert np.array_equal(gw, ww) and ge == we == 0


@pytest.mark.parametrize("w", [0, 1, 8191, 8192, 8193, 16384, 16385,
                               40_000, 81_920])
def test_prepare_word_planes_lengths(w):
    lut = np.arange(w, dtype=np.int16)
    want = pg.prepare_word_planes(jnp.asarray(lut))
    got = k2.prepare_word_planes(torch.from_numpy(lut))
    assert got.shape[0] == want.shape[1]
    assert got.dtype == torch.int16
    assert np.array_equal(got.numpy()[:w], lut)
    assert not got.numpy()[w:].any()


def test_window_base_blocks_matches_reference():
    rng = np.random.default_rng(11)
    idx32 = rng.integers(-1, 200_000, 8 * 1024).astype(np.int32)
    idx32[:1024] = -1                      # a tile with no in-range index
    for n_blocks in (2, 5, 30):
        want = pg.window_base_blocks(jnp.asarray(idx32), n_blocks)
        got = k2.window_base_blocks(torch.from_numpy(idx32), n_blocks)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_wrapper_checks_and_no_fallback_off_cpu():
    planes = k2.prepare_word_planes(torch.zeros(10, dtype=torch.int8))
    with pytest.raises(ValueError):        # planes of another word type
        k2.gather_word_windowed(planes, torch.zeros(4, dtype=torch.int64),
                                "int32")
    with pytest.raises(ValueError):        # planes not prepared
        k2.gather_word_windowed(torch.zeros(10, dtype=torch.int8),
                                torch.zeros(4, dtype=torch.int64), "int8")
    meta = torch.empty(2 * k2.WIN, dtype=torch.int8, device="meta")
    with pytest.raises(RuntimeError):
        k2.gather_word_windowed(meta, torch.empty(4, dtype=torch.int64,
                                                  device="meta"), "int8")


# --------------------------------------------------------------------------
# join sites
# --------------------------------------------------------------------------

def _batches(arrays, valids, capacity=None):
    """The same numpy columns as a reference batch and a port batch."""
    jb = jax_batch(arrays, valids=valids, capacity=capacity)
    tb = batch_from_numpy(arrays, valids=valids, capacity=capacity,
                          device="cpu")
    return jb, tb


def _assert_batches_equal(jb, tb):
    assert np.array_equal(np.asarray(jb.live), tb.live.numpy())
    assert len(jb.columns) == len(tb.columns)
    live = tb.live.numpy()
    for jc, tc in zip(jb.columns, tb.columns):
        jv, tv = np.asarray(jc.valid), tc.valid.numpy()
        assert np.array_equal(jv[live], tv[live])
        m = live & tv
        jd, td = np.asarray(jc.data), tc.data.numpy()
        assert jd.dtype == td.dtype
        assert np.array_equal(jd[m], td[m])


def _dim(rng, domain, rows):
    """A unique-key build side: key, two small ints (one with NULLs)."""
    keys = rng.permutation(domain)[:rows].astype(np.int64)
    a = rng.integers(-50, 50, rows).astype(np.int32)
    b = rng.integers(0, 7, rows).astype(np.int64)
    bv = rng.random(rows) > 0.2
    return [keys, a, b], [None, None, bv]


def _probe(rng, domain, n, sorted_keys=True):
    k = np.sort(rng.integers(-3, domain + 3, n)) if sorted_keys else \
        rng.integers(-3, domain + 3, n)
    kv = rng.random(n) > 0.05
    x = rng.integers(0, 1000, n)
    return [k, x], [kv, None]


def test_dense_build_lut_and_join_with_lut():
    rng = np.random.default_rng(21)
    domain = 5000
    (ba, bv) = _dim(rng, domain, 3000)
    jb, tb = _batches(ba, bv)
    jl, jd, jo = jjoin.dense_build_lut(jb, (0,), domain)
    tl, td, to = tjoin.dense_build_lut(tb, (0,), domain)
    assert np.array_equal(np.asarray(jl), tl.numpy())
    assert int(jd) == int(td) == 0 and int(jo) == int(to) == 0
    pa, pv = _probe(rng, domain, 7000, sorted_keys=False)
    jp, tp = _batches(pa, pv)
    for kind in ("inner", "left", "semi", "anti"):
        want = jjoin.dense_join_with_lut(jp, jb, jl, (0,), (0,), kind,
                                         "interpret")
        got = tjoin.dense_join_with_lut(tp, tb, tl, (0,), (0,), kind, "on")
        _assert_batches_equal(want, got)


def test_build_lut_chunk_streams_like_reference():
    rng = np.random.default_rng(22)
    domain = 4000
    keys = rng.permutation(domain + 200)[:3500] - 100     # some oob keys
    kv = rng.random(3500) > 0.1
    jl = jnp.full(domain + 1, -1, dtype=jnp.int32)
    tl = torch.full((domain + 1,), -1, dtype=torch.int32)
    totals = [0, 0, 0, 0]
    for start in range(0, 3500, 1000):
        jc, tc = _batches([keys[start:start + 1000]],
                          [kv[start:start + 1000]], capacity=1024)
        jl, jn, jo = jjoin.build_lut_chunk(jl, jc, 0, domain, start)
        tl, tn, to = tjoin.build_lut_chunk(tl, tc, 0, domain, start)
        totals[0] += int(jn)
        totals[1] += int(tn)
        totals[2] += int(jo)
        totals[3] += int(to)
    assert np.array_equal(np.asarray(jl), tl.numpy())
    assert totals[0] == totals[1] and totals[2] == totals[3] > 0


def _packing(ba, bv):
    """A packing layout for _dim's payload columns (1 and 2)."""
    meta, off = [], 1
    for i in (1, 2):
        v = ba[i] if bv[i] is None else ba[i][bv[i]]
        lo, hi = int(v.min()), int(v.max())
        width = max(1, int(hi - lo + 1).bit_length())
        meta.append((i, lo, width, off, off + width))
        off += width + 1
    word = "int8" if off <= 7 else "int16" if off <= 15 else "int32"
    return tuple(meta), word


def test_dense_build_packed_lut():
    rng = np.random.default_rng(23)
    domain = 6000
    ba, bv = _dim(rng, domain, 2500)
    meta, word = _packing(ba, bv)
    jb, tb = _batches(ba, bv)
    want = jjoin.dense_build_packed_lut(jb, (0,), domain, meta, word)
    got = tjoin.dense_build_packed_lut(tb, (0,), domain, meta, word)
    assert np.array_equal(np.asarray(want[0]), got[0].numpy())
    assert got[0].dtype == getattr(torch, word)
    assert [int(x) for x in want[1:]] == [int(x) for x in got[1:]]
    # a duplicated key shows as occupied < expected on both sides
    ba[0][1] = ba[0][0]
    jb, tb = _batches(ba, bv)
    want = jjoin.dense_build_packed_lut(jb, (0,), domain, meta, word)
    got = tjoin.dense_build_packed_lut(tb, (0,), domain, meta, word)
    assert [int(x) for x in want[1:]] == [int(x) for x in got[1:]]
    assert int(got[1]) - int(got[3]) == 1


@pytest.mark.parametrize("kind", ["inner", "left", "semi", "anti"])
def test_dense_join_packed(kind):
    rng = np.random.default_rng(24)
    domain = 6000
    ba, bv = _dim(rng, domain, 2500)
    meta, word = _packing(ba, bv)
    jb, tb = _batches(ba, bv)
    jl = jjoin.dense_build_packed_lut(jb, (0,), domain, meta, word)[0]
    tl = tjoin.dense_build_packed_lut(tb, (0,), domain, meta, word)[0]
    out_dtypes = ("int64", "int32", "int64")
    pa, pv = _probe(rng, domain, 9000, sorted_keys=False)
    jp, tp = _batches(pa, pv)
    want = jjoin.dense_join_packed(jp, jl, (0,), meta, 0, out_dtypes, kind,
                                   "interpret")
    got = tjoin.dense_join_packed(tp, tl, (0,), meta, 0, out_dtypes, kind,
                                  "on")
    _assert_batches_equal(want, got)


@pytest.mark.parametrize("through_k2,window,sorted_keys", [
    (True, 4096, True),       # K2, near-sorted: no escapes
    (True, 4096, False),      # K2, random keys: escapes
    (False, 4096, True),      # the window slice
    (False, 1024, False),     # the window slice, escapes
])
def test_dense_join_packed_windowed(through_k2, window, sorted_keys):
    rng = np.random.default_rng(25 + window)
    domain = 60_000
    ba, bv = _dim(rng, domain, 20_000)
    meta, word = _packing(ba, bv)
    jb, tb = _batches(ba, bv)
    jl = jjoin.dense_build_packed_lut(jb, (0,), domain, meta, word)[0]
    tl = tjoin.dense_build_packed_lut(tb, (0,), domain, meta, word)[0]
    out_dtypes = ("int64", "int32", "int64")
    # a chunk of near-sorted keys spanning ~3000 of the domain, or random
    # keys over all of it (wider than any window: escapes)
    if sorted_keys:
        pa, pv = _probe(rng, 3000, 6000)
        pa[0] = pa[0] + 20_000
    else:
        pa, pv = _probe(rng, domain, 6000, sorted_keys=False)
    jp, tp = _batches(pa, pv)
    jplanes = pg.prepare_word_planes(jl) if through_k2 else None
    tplanes = k2.prepare_word_planes(tl) if through_k2 else None
    want, we, ws = jjoin.dense_join_packed_windowed(
        jp, jl, (0,), meta, 0, out_dtypes, "inner", window,
        word_dtype=word, gather_mode="interpret" if through_k2 else "off",
        lut_planes=jplanes)
    got, ge, gs = tjoin.dense_join_packed_windowed(
        tp, tl, (0,), meta, 0, out_dtypes, "inner", window,
        word_dtype=word, gather_mode="on" if through_k2 else "off",
        lut_planes=tplanes)
    _assert_batches_equal(want, got)
    assert int(we) == int(ge) and int(ws) == int(gs)
    assert (int(ge) == 0) == sorted_keys


def test_compact_live_sized_form():
    rng = np.random.default_rng(26)
    n = 4096
    live = rng.random(n) > 0.7
    arrays = [rng.integers(0, 100, n)]
    jb = jax_batch(arrays)
    tb = batch_from_numpy(arrays, device="cpu")
    jb = jb.with_live(jnp.asarray(live))
    tb = tb.with_live(torch.from_numpy(live))
    for cap in (1024, 2048, 8192):
        want, wover = jjoin.compact_live(jb, cap)
        got, gover = tjoin.compact_live(tb, cap)
        _assert_batches_equal(want, got)
        assert int(wover) == int(gover)
