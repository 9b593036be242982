"""Port copy of ``trino_tpu/server/pageserde.py`` (no edits): the same frames,
byte for byte, for the same arrays.

Binary page serde for the data plane.

Reference: Trino ships exchange pages as length-prefixed binary frames
with optional LZ4/ZSTD compression
(core/trino-main/.../execution/buffer/CompressingEncryptingPageSerializer.java:60,
PagesSerdeUtil). Round-3 shipped base64-in-JSON — fine for correctness,
hopeless for SF100 shuffles — this module is the binary replacement.

Frame layout (little-endian):

    magic  b"TPG2"
    crc    u32     CRC32C (Castagnoli) of everything after this field
    flags  u8      bit0: body zstd-compressed, bit1: zlib-compressed
    rawlen u64     uncompressed body length
    body   bytes   (compressed per flags)

The checksum covers flags + rawlen + body, so a bit flip anywhere past
the magic — in transit, in a spool file, in a worker's output buffer —
is detected at decode/verify time and surfaces as PageChecksumError,
which the exchange layers convert into a retryable task failure instead
of silently wrong results (the reference's
CompressingEncryptingPageSerializer checksum word plays the same role).
Legacy b"TPG1" frames (round-5, no checksum) still decode — rolling
upgrade, same policy as the base64-dict fallback in tasks.py.

Body:

    ncols  u16
    rows   u64
    per column:
        dlen   u8   dtype string length
        dtype  ascii
        nbytes u64  data byte length
        data   bytes
        vbytes u64  validity byte length (bool_, rows entries)
        valid  bytes

Decoding attacker-controlled bytes can at worst produce malformed numpy
arrays — no object deserialization (same data-only property as
server/serde.py).
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Tuple

import numpy as np

MAGIC = b"TPG2"
MAGIC_V1 = b"TPG1"        # legacy checksum-free frames (round 5)
_F_ZSTD = 1
_F_ZLIB = 2


class PageChecksumError(ValueError):
    """Frame failed its CRC32C integrity check (or is truncated/garbled).
    Retryable: the holder of the frame re-fetches or re-runs the work.

    Every raise is counted in the process metrics registry
    (trino_tpu_pageserde_crc_failures_total) so corruption seen at any
    verify site — coordinator drain, spool read, worker<->worker pull —
    is visible on /v1/metrics without log spelunking."""

    def __init__(self, *args):
        super().__init__(*args)
        from ..metrics import PAGE_CRC_FAILURES
        PAGE_CRC_FAILURES.inc()


try:
    import google_crc32c as _gcrc

    def _crc32c(*chunks) -> int:
        c = 0
        for ch in chunks:
            c = _gcrc.extend(c, bytes(ch))
        return c
except Exception:                    # pragma: no cover — lib absent
    # zlib's CRC-32 (0x04C11DB7) as a stand-in: same 32-bit guarantees
    # (all 1-2 bit errors, bursts <= 32), just not the Castagnoli
    # polynomial. Frames never cross processes with mismatched builds
    # (one container image), so the choice only needs to be consistent.
    def _crc32c(*chunks) -> int:
        c = 0
        for ch in chunks:
            c = zlib.crc32(ch, c)
        return c & 0xFFFFFFFF

try:
    import zstandard as _zstd
except Exception:                        # pragma: no cover — zstd absent
    _zstd = None

# zstd (de)compression CONTEXTS are not thread-safe, and pages flow on
# many threads at once (worker task threads, exchange-consumer pulls,
# coordinator drains) — sharing one context corrupts frames under
# concurrency (observed: intermittent ZstdError in the partitioned
# exchange). Keep one context per thread.
import threading as _threading

_tls = _threading.local()


def _zc():
    if _zstd is None:
        return None
    c = getattr(_tls, "zc", None)
    if c is None:
        c = _tls.zc = _zstd.ZstdCompressor(level=3)
    return c


def _zd():
    if _zstd is None:
        return None
    d = getattr(_tls, "zd", None)
    if d is None:
        d = _tls.zd = _zstd.ZstdDecompressor()
    return d

# frames smaller than this ship uncompressed (header cost dominates)
MIN_COMPRESS = 512


def encode_page(arrays: List[np.ndarray],
                valids: List[np.ndarray]) -> bytes:
    rows = len(arrays[0]) if arrays else 0
    parts = [struct.pack("<HQ", len(arrays), rows)]
    for a, v in zip(arrays, valids):
        a = np.ascontiguousarray(a)
        v = np.ascontiguousarray(np.asarray(v, dtype=np.bool_))
        dt = str(a.dtype).encode("ascii")
        parts.append(struct.pack("<B", len(dt)))
        parts.append(dt)
        ab = a.tobytes()
        parts.append(struct.pack("<Q", len(ab)))
        parts.append(ab)
        vb = v.tobytes()
        parts.append(struct.pack("<Q", len(vb)))
        parts.append(vb)
    body = b"".join(parts)
    flags = 0
    if len(body) >= MIN_COMPRESS:
        zc = _zc()
        if zc is not None:
            comp = zc.compress(body)
            if len(comp) < len(body):
                body, flags = comp, _F_ZSTD
        else:
            comp = zlib.compress(body, 1)
            if len(comp) < len(body):
                body, flags = comp, _F_ZLIB
    meta = struct.pack("<BQ", flags, len(body))
    return MAGIC + struct.pack("<I", _crc32c(meta, body)) + meta + body


def verify_page(buf: bytes) -> None:
    """Integrity-check a frame without decompressing or decoding it.

    Raises PageChecksumError on CRC mismatch, truncation, or an
    unrecognizable magic (a flipped magic byte is corruption too).
    Legacy TPG1 frames carry no checksum and pass unverified."""
    if buf[:4] == MAGIC_V1:
        return
    if buf[:4] != MAGIC:
        raise PageChecksumError("bad page frame magic")
    if len(buf) < 17:
        raise PageChecksumError("truncated page frame header")
    (crc,) = struct.unpack_from("<I", buf, 4)
    (_, blen) = struct.unpack_from("<BQ", buf, 8)
    if len(buf) < 17 + blen:
        raise PageChecksumError("truncated page frame body")
    if _crc32c(buf[8:17 + blen]) != crc:
        raise PageChecksumError("page frame CRC32C mismatch")


def decode_page(buf: bytes) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    if buf[:4] == MAGIC:
        verify_page(buf)
        flags, rawlen = struct.unpack_from("<BQ", buf, 8)
        body = buf[17:17 + rawlen]
    elif buf[:4] == MAGIC_V1:
        flags, rawlen = struct.unpack_from("<BQ", buf, 4)
        body = buf[13:13 + rawlen]
    else:
        raise ValueError("bad page frame magic")
    if flags & _F_ZSTD:
        zd = _zd()
        if zd is None:
            raise ValueError("zstd page but zstandard unavailable")
        body = zd.decompress(body)
    elif flags & _F_ZLIB:
        body = zlib.decompress(body)
    off = 0
    ncols, rows = struct.unpack_from("<HQ", body, off)
    off += 10
    arrays, valids = [], []
    for _ in range(ncols):
        (dlen,) = struct.unpack_from("<B", body, off)
        off += 1
        dt = np.dtype(body[off:off + dlen].decode("ascii"))
        off += dlen
        (nbytes,) = struct.unpack_from("<Q", body, off)
        off += 8
        arrays.append(np.frombuffer(body, dtype=dt,
                                    count=nbytes // dt.itemsize,
                                    offset=off) if nbytes else
                      np.empty(0, dt))
        off += nbytes
        (vbytes,) = struct.unpack_from("<Q", body, off)
        off += 8
        valids.append(np.frombuffer(body, dtype=np.bool_, count=vbytes,
                                    offset=off) if vbytes else
                      np.empty(0, np.bool_))
        off += vbytes
    return arrays, valids
