"""Port copy of ``trino_tpu/formats/orc.py`` (numpy only; the one edit
is the atomicio import, now this package's).

ORC reader + writer — from scratch (numpy; zstandard only for the
optional ZSTD codec).

Reference: lib/trino-orc (reader/OrcRecordReader.java:83 and
OrcWriter.java, the stripe / stream / RLE stack). Coverage, built from
the ORC v1 spec:

- protobuf wire decoding/encoding for PostScript / Footer /
  StripeFooter metadata (ORC metadata is plain proto2)
- compression kinds NONE / ZLIB (raw deflate) / SNAPPY / LZ4 / ZSTD,
  applied per ORC's 3-byte chunk framing (header = len << 1|isOriginal)
- column types BOOLEAN / BYTE / SHORT / INT / LONG / FLOAT / DOUBLE /
  STRING / VARCHAR / CHAR / DATE / DECIMAL (<=18 digits) / TIMESTAMP
  inside a top-level STRUCT; LIST/MAP/UNION are rejected loudly
- integer RLE v1 and v2 (SHORT_REPEAT / DIRECT / PATCHED_BASE / DELTA),
  boolean/byte RLE for presence bits, string DIRECT_V2 and
  DICTIONARY_V2 encodings
- multiple stripes; NULLs via PRESENT streams
- writer: RLE v1 / DIRECT encodings, NONE compression, multi-stripe —
  the simplest spec-legal choices, readable by any conforming reader
  (pyarrow-verified)
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .parquet import (_zstd_decompress, lz4_raw_decompress,
                      snappy_decompress)

# compression kinds (PostScript field 2)
C_NONE, C_ZLIB, C_SNAPPY, C_LZO, C_LZ4, C_ZSTD = 0, 1, 2, 3, 4, 5

# type kinds (Footer Type field 1)
(K_BOOLEAN, K_BYTE, K_SHORT, K_INT, K_LONG, K_FLOAT, K_DOUBLE, K_STRING,
 K_BINARY, K_TIMESTAMP, K_LIST, K_MAP, K_STRUCT, K_UNION, K_DECIMAL,
 K_DATE, K_VARCHAR, K_CHAR) = range(18)

# stream kinds (StripeFooter Stream field 2)
S_PRESENT, S_DATA, S_LENGTH, S_DICTIONARY_DATA, S_DICTIONARY_COUNT, \
    S_SECONDARY = 0, 1, 2, 3, 4, 5

# column encodings
E_DIRECT, E_DICTIONARY, E_DIRECT_V2, E_DICTIONARY_V2 = 0, 1, 2, 3


# --------------------------------------------------------------------------
# protobuf wire format
# --------------------------------------------------------------------------

def _pb_varint(b: bytes, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        x = b[pos]
        pos += 1
        out |= (x & 0x7F) << shift
        if not x & 0x80:
            return out, pos
        shift += 7


def pb_decode(b: bytes) -> Dict[int, list]:
    """Generic proto2 message -> {field: [raw values]} (varints stay
    ints, length-delimited stay bytes; callers interpret)."""
    fields: Dict[int, list] = {}
    pos = 0
    n = len(b)
    while pos < n:
        key, pos = _pb_varint(b, pos)
        fid, wire = key >> 3, key & 7
        if wire == 0:
            v, pos = _pb_varint(b, pos)
        elif wire == 1:
            v = struct.unpack_from("<q", b, pos)[0]
            pos += 8
        elif wire == 2:
            ln, pos = _pb_varint(b, pos)
            v = b[pos:pos + ln]
            pos += ln
        elif wire == 5:
            v = struct.unpack_from("<i", b, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        fields.setdefault(fid, []).append(v)
    return fields


def _zz(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _pb_double(v: int) -> float:
    """Reinterpret a pb_decode wire-type-1 value (read as int64) as the
    IEEE double it actually is (DoubleStatistics min/max)."""
    return struct.unpack("<d", struct.pack("<q", v))[0]


def pb_ints(msg: Dict[int, list], fid: int) -> List[int]:
    """Repeated integer field, handling proto2 packed encoding (the
    values arrive as one length-delimited blob of varints)."""
    out: List[int] = []
    for v in msg.get(fid, []):
        if isinstance(v, bytes):
            pos = 0
            while pos < len(v):
                x, pos = _pb_varint(v, pos)
                out.append(x)
        else:
            out.append(v)
    return out


# --------------------------------------------------------------------------
# compression chunk framing
# --------------------------------------------------------------------------

def _decompress_stream(kind: int, data: bytes) -> bytes:
    if kind == C_NONE:
        return data
    out = bytearray()
    pos = 0
    n = len(data)
    while pos < n:
        header = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        length = header >> 1
        chunk = data[pos:pos + length]
        pos += length
        if header & 1:                   # isOriginal
            out += chunk
        elif kind == C_ZLIB:
            out += zlib.decompress(chunk, wbits=-15)
        elif kind == C_SNAPPY:
            out += snappy_decompress(chunk)
        elif kind == C_LZ4:
            out += lz4_raw_decompress(chunk, -1)
        elif kind == C_ZSTD:
            out += _zstd_decompress(chunk, 1 << 26)
        else:
            raise ValueError(f"unsupported ORC compression kind {kind}")
    return bytes(out)


# --------------------------------------------------------------------------
# RLE decoders
# --------------------------------------------------------------------------

def _bool_rle(data: bytes, count: int) -> np.ndarray:
    """Byte-RLE then bit expansion, MSB first."""
    by = _byte_rle(data, (count + 7) // 8)
    bits = np.unpackbits(np.frombuffer(by, dtype=np.uint8),
                         bitorder="big")
    return bits[:count].astype(np.bool_)


def _byte_rle(data: bytes, count: int) -> bytes:
    out = bytearray()
    pos = 0
    while len(out) < count and pos < len(data):
        h = data[pos]
        pos += 1
        if h < 128:                      # run of h+3 repeats
            out += bytes([data[pos]]) * (h + 3)
            pos += 1
        else:                            # 256-h literals
            n = 256 - h
            out += data[pos:pos + n]
            pos += n
    return bytes(out[:count])


def _unpack_bits_be(data: bytes, width: int, count: int,
                    pos: int) -> Tuple[np.ndarray, int]:
    """Big-endian bit-packed integers (RLEv2 DIRECT/PATCHED payloads)."""
    nbits = width * count
    nbytes = (nbits + 7) // 8
    raw = np.frombuffer(data, dtype=np.uint8, count=nbytes, offset=pos)
    bits = np.unpackbits(raw, bitorder="big")[:nbits]
    vals = np.zeros(count, dtype=np.int64)
    bm = bits.reshape(count, width).astype(np.int64)
    for i in range(width):
        vals = (vals << 1) | bm[:, i]
    return vals, pos + nbytes


# RLEv2 5-bit width encoding -> actual bit width
_W5 = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
       19, 20, 21, 22, 23, 24, 26, 28, 30, 32, 40, 48, 56, 64]


def _varint(data: bytes, pos: int) -> Tuple[int, int]:
    return _pb_varint(data, pos)


def int_rle_v2(data: bytes, count: int, signed: bool) -> np.ndarray:
    out = np.empty(count, dtype=np.int64)
    filled = 0
    pos = 0
    while filled < count:
        h = data[pos]
        enc = h >> 6
        if enc == 0:                     # SHORT_REPEAT
            width = ((h >> 3) & 0x7) + 1
            run = (h & 0x7) + 3
            v = int.from_bytes(data[pos + 1:pos + 1 + width], "big")
            pos += 1 + width
            if signed:
                v = _zz(v)
            out[filled:filled + run] = v
            filled += run
        elif enc == 1:                   # DIRECT
            width = _W5[(h >> 1) & 0x1F]
            run = (((h & 1) << 8) | data[pos + 1]) + 1
            pos += 2
            vals, pos = _unpack_bits_be(data, width, run, pos)
            if signed:
                vals = (vals >> 1) ^ -(vals & 1)
            out[filled:filled + run] = vals
            filled += run
        elif enc == 2:                   # PATCHED_BASE
            width = _W5[(h >> 1) & 0x1F]
            run = (((h & 1) << 8) | data[pos + 1]) + 1
            b3, b4 = data[pos + 2], data[pos + 3]
            bw = (b3 >> 5) + 1           # base value width, bytes
            pw = _W5[b3 & 0x1F]          # patch value width, bits
            pgw = (b4 >> 5) + 1          # patch gap width, bits
            pll = b4 & 0x1F              # patch list length
            pos += 4
            base = int.from_bytes(data[pos:pos + bw], "big")
            sign = base >> (bw * 8 - 1)
            if sign:
                base = -(base & ((1 << (bw * 8 - 1)) - 1))
            pos += bw
            vals, pos = _unpack_bits_be(data, width, run, pos)
            patch_width = pgw + pw
            patches, pos = _unpack_bits_be(
                data, ((patch_width + 7) // 8) * 8, pll, pos)
            gap_acc = 0
            for p in patches.tolist():
                gap = p >> pw
                patch = p & ((1 << pw) - 1)
                gap_acc += gap
                vals[gap_acc] |= patch << width
            out[filled:filled + run] = base + vals
            filled += run
        else:                            # DELTA
            width_code = (h >> 1) & 0x1F
            width = _W5[width_code] if width_code else 0
            run = (((h & 1) << 8) | data[pos + 1]) + 1
            pos += 2
            v0, pos = _varint(data, pos)
            base = _zz(v0) if signed else v0
            delta0, pos = _varint(data, pos)
            delta0 = _zz(delta0)
            seq = [base]
            if run > 1:
                seq.append(base + delta0)
            if run > 2:
                if width:
                    deltas, pos = _unpack_bits_be(data, width, run - 2,
                                                  pos)
                    sgn = 1 if delta0 >= 0 else -1
                    for d in deltas.tolist():
                        seq.append(seq[-1] + sgn * d)
                else:
                    for _ in range(run - 2):
                        seq.append(seq[-1] + delta0)
            out[filled:filled + run] = seq
            filled += run
    return out


def int_rle_v1(data: bytes, count: int, signed: bool) -> np.ndarray:
    out = np.empty(count, dtype=np.int64)
    filled = 0
    pos = 0
    while filled < count:
        h = data[pos]
        pos += 1
        if h < 128:                      # run
            run = h + 3
            delta = struct.unpack_from("<b", data, pos)[0]
            pos += 1
            v, pos = _varint(data, pos)
            if signed:
                v = _zz(v)
            out[filled:filled + run] = v + delta * np.arange(run)
            filled += run
        else:                            # literals
            n = 256 - h
            for i in range(n):
                v, pos = _varint(data, pos)
                out[filled + i] = _zz(v) if signed else v
            filled += n
    return out


# --------------------------------------------------------------------------
# reader
# --------------------------------------------------------------------------

class OrcFile:
    def __init__(self, names, columns, valids, logicals,
                 skipped_stripes: int = 0, total_stripes: int = 0):
        self.names = names
        self.columns = columns
        self.valids = valids
        self.logicals = logicals
        self.skipped_stripes = skipped_stripes
        self.total_stripes = total_stripes


def read_orc(path: str, predicates: Optional[dict] = None):
    """Read an ORC file -> (names, columns, valids, logicals).

    `predicates` maps column name -> (lo, hi) inclusive bounds in the
    engine's physical representation (dates as epoch days, decimals as
    scaled integers); stripes whose StripeStatistics prove no row can
    match are skipped without decoding (the caller's residual filter
    keeps results exact)."""
    f = read_orc_file(path, predicates)
    return f.names, f.columns, f.valids, f.logicals


def _stats_range(cs: Dict[int, list], kind: int, tmeta) \
        -> Tuple[Optional[object], Optional[object]]:
    """(min, max) of one ColumnStatistics message in engine physical
    values, or (None, None) when absent/unusable."""
    if kind in (K_BYTE, K_SHORT, K_INT, K_LONG):
        m = cs.get(2)
        if m:
            st = pb_decode(m[0])
            lo, hi = st.get(1, [None])[0], st.get(2, [None])[0]
            return (None if lo is None else _zz(lo),
                    None if hi is None else _zz(hi))
    elif kind == K_DATE:
        m = cs.get(7)
        if m:
            st = pb_decode(m[0])
            lo, hi = st.get(1, [None])[0], st.get(2, [None])[0]
            return (None if lo is None else _zz(lo),
                    None if hi is None else _zz(hi))
    elif kind in (K_FLOAT, K_DOUBLE):
        m = cs.get(3)
        if m:
            st = pb_decode(m[0])
            lo, hi = st.get(1, [None])[0], st.get(2, [None])[0]
            return (None if lo is None else _pb_double(lo),
                    None if hi is None else _pb_double(hi))
    elif kind == K_DECIMAL:
        m = cs.get(6)
        if m:
            from decimal import Decimal
            st = pb_decode(m[0])
            scale = tmeta.get(6, [0])[0]
            lo, hi = st.get(1, [None])[0], st.get(2, [None])[0]
            try:
                return (None if lo is None else
                        int(Decimal(lo.decode()).scaleb(scale)),
                        None if hi is None else
                        int(Decimal(hi.decode()).scaleb(scale)))
            except Exception:   # noqa: BLE001 — malformed decimal stat
                return None, None
    elif kind in (K_STRING, K_VARCHAR, K_CHAR):
        m = cs.get(4)
        if m:
            st = pb_decode(m[0])
            lo, hi = st.get(1, [None])[0], st.get(2, [None])[0]
            return (None if lo is None else lo.decode("utf-8", "replace"),
                    None if hi is None else hi.decode("utf-8", "replace"))
    return None, None


def _stripe_excluded(col_stats, child_ids, names, types,
                     predicates: dict) -> bool:
    """True when some predicate column's stripe statistics prove the
    stripe empty under (lo, hi) inclusive bounds (parquet's
    _group_excluded, for ORC StripeStatistics)."""
    for j, cid in enumerate(child_ids):
        if j >= len(names) or cid >= len(col_stats):
            continue
        rng = predicates.get(names[j])
        if rng is None:
            continue
        kind = types[cid].get(1, [None])[0]
        cmin, cmax = _stats_range(col_stats[cid], kind, types[cid])
        lo, hi = rng
        try:
            if cmin is not None and hi is not None and cmin > hi:
                return True
            if cmax is not None and lo is not None and cmax < lo:
                return True
        except TypeError:       # incomparable stat/bound types: keep
            continue
    return False


def read_orc_file(path: str,
                  predicates: Optional[dict] = None) -> OrcFile:
    with open(path, "rb") as f:
        blob = f.read()
    ps_len = blob[-1]
    ps = pb_decode(blob[-1 - ps_len:-1])
    footer_len = ps[1][0]
    comp = ps.get(2, [C_NONE])[0]
    magic = ps.get(8000, [b""])[0]
    if magic != b"ORC":
        raise ValueError("not an ORC file")
    footer_raw = blob[-1 - ps_len - footer_len:-1 - ps_len]
    footer = pb_decode(_decompress_stream(comp, footer_raw))
    # Metadata section (StripeStatistics) sits just before the footer;
    # PostScript field 5 carries its length
    metadata_len = ps.get(5, [0])[0]
    stripe_stats: List[list] = []
    if metadata_len:
        meta_raw = blob[-1 - ps_len - footer_len - metadata_len:
                        -1 - ps_len - footer_len]
        meta = pb_decode(_decompress_stream(comp, meta_raw))
        for ss in meta.get(1, []):
            stripe_stats.append(
                [pb_decode(cs) for cs in pb_decode(ss).get(1, [])])

    types = [pb_decode(t) for t in footer.get(4, [])]
    root = types[0]
    if root.get(1, [K_STRUCT])[0] != K_STRUCT:
        raise ValueError("ORC root type must be STRUCT")
    child_ids = pb_ints(root, 2)
    names = [n.decode() for n in root.get(3, [])]
    for cid in child_ids:
        k = types[cid].get(1, [None])[0]
        if k in (K_LIST, K_MAP, K_UNION, K_BINARY):
            raise ValueError(f"unsupported ORC column kind {k}")

    stripes = [pb_decode(s) for s in footer.get(3, [])]
    col_parts: Dict[int, list] = {cid: [] for cid in child_ids}
    val_parts: Dict[int, list] = {cid: [] for cid in child_ids}
    skipped = 0
    for si, st in enumerate(stripes):
        if predicates and si < len(stripe_stats) and _stripe_excluded(
                stripe_stats[si], child_ids, names, types, predicates):
            skipped += 1
            continue
        offset = st.get(1, [0])[0]
        index_len = st.get(2, [0])[0]
        data_len = st.get(3, [0])[0]
        sfooter_len = st.get(4, [0])[0]
        n_rows = st.get(5, [0])[0]
        sf_raw = blob[offset + index_len + data_len:
                      offset + index_len + data_len + sfooter_len]
        sfooter = pb_decode(_decompress_stream(comp, sf_raw))
        streams = [pb_decode(s) for s in sfooter.get(1, [])]
        encodings = [pb_decode(e) for e in sfooter.get(2, [])]
        # stream placement: sequential after the index region
        spos = offset
        placed = []
        for s in streams:
            kind = s.get(1, [S_DATA])[0]
            col = s.get(2, [0])[0]
            ln = s.get(3, [0])[0]
            placed.append((kind, col, spos, ln))
            spos += ln
        for cid in child_ids:
            kind = types[cid].get(1, [None])[0]
            enc = encodings[cid].get(1, [E_DIRECT])[0] \
                if cid < len(encodings) else E_DIRECT
            dict_size = encodings[cid].get(2, [0])[0] \
                if cid < len(encodings) else 0
            mine = {k: blob[p:p + ln]
                    for (k, c, p, ln) in placed if c == cid}
            vals, valid = _read_column(kind, enc, dict_size, mine, comp,
                                       n_rows, types[cid])
            col_parts[cid].append(vals)
            val_parts[cid].append(valid)

    # dtype of an all-stripes-pruned column must still follow its ORC
    # kind, or the connector's schema inference flips with the predicate
    _empty_dtype = {K_BOOLEAN: np.bool_, K_FLOAT: np.float64,
                    K_DOUBLE: np.float64, K_STRING: object,
                    K_VARCHAR: object, K_CHAR: object}
    columns, valids, logicals = [], [], []
    for cid in child_ids:
        parts = col_parts[cid]
        vparts = val_parts[cid]
        kind0 = types[cid].get(1, [None])[0]
        columns.append(np.concatenate(parts) if len(parts) > 1 else
                       (parts[0] if parts else
                        np.zeros(0, _empty_dtype.get(kind0, np.int64))))
        if any(v is not None for v in vparts):
            vs = [v if v is not None else np.ones(len(p), np.bool_)
                  for v, p in zip(vparts, parts)]
            valids.append(np.concatenate(vs) if len(vs) > 1 else vs[0])
        else:
            valids.append(None)
        kind = types[cid].get(1, [None])[0]
        if kind == K_DECIMAL:
            logicals.append(("decimal",
                             types[cid].get(5, [18])[0],
                             types[cid].get(6, [0])[0]))
        elif kind == K_DATE:
            logicals.append(("date",))
        elif kind == K_TIMESTAMP:
            logicals.append(("timestamp",))
        else:
            logicals.append(None)
    return OrcFile(names, columns, valids, logicals,
                   skipped_stripes=skipped, total_stripes=len(stripes))


def timestamp_micros(secs: np.ndarray, nraw: np.ndarray) -> np.ndarray:
    """Compose TIMESTAMP microseconds from the raw (seconds-from-2015,
    encoded-nanos) stream pair.

    Nanos: low 3 bits k != 0 => (k+1) trailing zeros were stripped
    (verified against pyarrow: 1000ns -> (1<<3)|2, 2.5e8 -> 25|6).

    Negative-time adjustment: Java ORC writers store trunc-toward-zero
    seconds with a POSITIVE sub-second part, so a pre-1970 timestamp
    with fractional seconds carries seconds one above the floor — a
    conforming reader subtracts one second when the 1970-relative
    seconds are negative and nanos are non-zero (TreeReaderFactory's
    TimestampTreeReader). The C++ writer (pyarrow) instead truncates
    toward zero WITH sign-carrying nanos; those rows arrive here with
    nanos < 0 and must NOT be adjusted — hence the nanos > 0 condition,
    which distinguishes the two encodings exactly."""
    zeros = nraw & 7
    nanos = np.where(zeros == 0, nraw >> 3,
                     (nraw >> 3) * np.power(10, zeros + 1))
    base = 1420070400      # 2015-01-01T00:00:00Z
    abs_secs = secs + base
    abs_secs = np.where((abs_secs < 0) & (nanos > 0), abs_secs - 1,
                        abs_secs)
    return abs_secs * 1_000_000 + nanos // 1000


def _read_column(kind, enc, dict_size, streams, comp, n_rows, tmeta):
    present = streams.get(S_PRESENT)
    valid = None
    if present is not None:
        valid = _bool_rle(_decompress_stream(comp, present), n_rows)
    n_present = int(valid.sum()) if valid is not None else n_rows
    data = _decompress_stream(comp, streams.get(S_DATA, b""))

    def rle_ints(raw, cnt, signed=True):
        if enc in (E_DIRECT_V2, E_DICTIONARY_V2):
            return int_rle_v2(raw, cnt, signed)
        return int_rle_v1(raw, cnt, signed)

    if kind in (K_SHORT, K_INT, K_LONG, K_DATE):
        vals_p = rle_ints(data, n_present)
    elif kind == K_BYTE:
        vals_p = np.frombuffer(_byte_rle(data, n_present),
                               dtype=np.int8).astype(np.int64)
    elif kind == K_BOOLEAN:
        vals_p = _bool_rle(data, n_present)
    elif kind == K_FLOAT:
        vals_p = np.frombuffer(data, dtype="<f4",
                               count=n_present).astype(np.float64)
    elif kind == K_DOUBLE:
        vals_p = np.frombuffer(data, dtype="<f8", count=n_present)
    elif kind in (K_STRING, K_VARCHAR, K_CHAR):
        lens_raw = _decompress_stream(comp, streams.get(S_LENGTH, b""))
        if enc in (E_DICTIONARY, E_DICTIONARY_V2):
            dict_raw = _decompress_stream(
                comp, streams.get(S_DICTIONARY_DATA, b""))
            lens = rle_ints(lens_raw, dict_size, signed=False)
            pool, pos = [], 0
            for ln in lens.tolist():
                pool.append(dict_raw[pos:pos + ln].decode(
                    "utf-8", "replace"))
                pos += ln
            idx = rle_ints(data, n_present, signed=False)
            vals_p = np.array([pool[i] for i in idx.tolist()],
                              dtype=object)
        else:
            lens = rle_ints(lens_raw, n_present, signed=False)
            out, pos = [], 0
            for ln in lens.tolist():
                out.append(data[pos:pos + ln].decode("utf-8", "replace"))
                pos += ln
            vals_p = np.array(out, dtype=object)
    elif kind == K_DECIMAL:
        # unbounded base-128 varints (sign in zigzag), scale SECONDARY
        sec = _decompress_stream(comp, streams.get(S_SECONDARY, b""))
        scales = rle_ints(sec, n_present)
        scale = tmeta.get(6, [0])[0]
        vals = []
        pos = 0
        for i in range(n_present):
            v, pos = _varint(data, pos)
            v = _zz(v)
            s = int(scales[i])
            vals.append(v * (10 ** (scale - s)) if s != scale else v)
        vals_p = np.asarray(vals, dtype=np.int64)
    elif kind == K_TIMESTAMP:
        # DATA = seconds from 2015-01-01 UTC (signed RLE); SECONDARY =
        # nanos with the trailing-zero trick (low 3 bits k != 0 =>
        # nanos = (v >> 3) * 10^(k+1)). Engine lanes are microseconds.
        secs = rle_ints(data, n_present).astype(np.int64)
        sec_raw = _decompress_stream(comp, streams.get(S_SECONDARY,
                                                       b""))
        nraw = rle_ints(sec_raw, n_present, signed=False).astype(
            np.int64)
        vals_p = timestamp_micros(secs, nraw)
    else:
        raise ValueError(f"unsupported ORC column kind {kind}")

    if valid is None:
        return vals_p, None
    if vals_p.dtype == object:
        full = np.full(n_rows, "", dtype=object)
    else:
        full = np.zeros(n_rows, dtype=vals_p.dtype)
    full[valid] = vals_p
    return full, valid


# --------------------------------------------------------------------------
# writer — minimal valid ORC (RLE v1 / DIRECT encodings, NONE compression)
# Reference role: lib/trino-orc OrcWriter.java. The simplest spec-legal
# encodings are chosen for writability; any conforming reader (including
# this module's own and pyarrow's) decodes them.
# --------------------------------------------------------------------------

def _pb_varint_enc(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def pb_encode(fields: Dict[int, list]) -> bytes:
    """Inverse of pb_decode: {field id: [int | bytes | float, ...]} ->
    proto2 wire bytes (varint for ints, length-delimited for bytes,
    fixed64 for Python floats — DoubleStatistics)."""
    out = bytearray()
    for fid in sorted(fields):
        for v in fields[fid]:
            if isinstance(v, (bytes, bytearray)):
                out += _pb_varint_enc((fid << 3) | 2)
                out += _pb_varint_enc(len(v))
                out += v
            elif isinstance(v, float):
                out += _pb_varint_enc((fid << 3) | 1)
                out += struct.pack("<d", v)
            else:
                out += _pb_varint_enc((fid << 3) | 0)
                out += _pb_varint_enc(int(v))
    return bytes(out)


def _compress_stream(kind: int, data: bytes, block: int = 262144) -> bytes:
    """Writer-side inverse of _decompress_stream: ORC 3-byte chunk
    framing (header = len << 1 | isOriginal). A chunk that deflate does
    not shrink is stored original, per spec."""
    if kind == C_NONE:
        return data
    if kind != C_ZLIB:
        raise ValueError(f"unsupported ORC write compression kind {kind}")
    out = bytearray()
    for i in range(0, len(data), block):
        chunk = data[i:i + block]
        co = zlib.compressobj(6, zlib.DEFLATED, -15)   # raw deflate
        comp = co.compress(chunk) + co.flush()
        if len(comp) < len(chunk):
            out += (len(comp) << 1).to_bytes(3, "little") + comp
        else:
            out += ((len(chunk) << 1) | 1).to_bytes(3, "little") + chunk
    return bytes(out)


def _dec_str(v: int, scale: int) -> str:
    """Scaled-int64 decimal -> ORC DecimalStatistics string ("‑1.23")."""
    if scale <= 0:
        return str(v)
    sign = "-" if v < 0 else ""
    v = abs(v)
    return f"{sign}{v // 10 ** scale}.{v % 10 ** scale:0{scale}d}"


def _col_stats(kind: int, present: np.ndarray, has_null: bool,
               logical) -> bytes:
    """ColumnStatistics proto for one column's stripe slice: value
    count, hasNull, and a kind-appropriate min/max message (sint64
    zigzag for integers/dates, IEEE doubles, decimal strings, UTF-8
    strings) — what _stats_range/_stripe_excluded prune against."""
    msg: Dict[int, list] = {1: [len(present)]}
    if has_null:
        msg[10] = [1]
    if len(present):
        if kind in (K_BYTE, K_SHORT, K_INT, K_LONG, K_DATE):
            lo, hi = int(np.min(present)), int(np.max(present))
            fid = 7 if kind == K_DATE else 2
            msg[fid] = [pb_encode({1: [_zz_enc(lo)], 2: [_zz_enc(hi)]})]
        elif kind == K_DOUBLE:
            a = np.asarray(present, dtype=np.float64)
            if not np.isnan(a).any():
                msg[3] = [pb_encode({1: [float(a.min())],
                                     2: [float(a.max())]})]
        elif kind == K_DECIMAL:
            scale = logical[2] if logical else 0
            lo, hi = int(np.min(present)), int(np.max(present))
            msg[6] = [pb_encode({1: [_dec_str(lo, scale).encode()],
                                 2: [_dec_str(hi, scale).encode()]})]
        elif kind == K_STRING:
            ss = [("" if s is None else str(s)) for s in present]
            msg[4] = [pb_encode({1: [min(ss).encode()],
                                 2: [max(ss).encode()]})]
        # K_BOOLEAN: counts only (BucketStatistics adds nothing here)
    return pb_encode(msg)


def _zz_enc(v: int) -> int:
    return (v << 1) ^ (v >> 63) if v < 0 else v << 1


def _rle_v1_ints(vals, signed=True) -> bytes:
    """Integer RLE v1, all-literal runs (header = -(n) as signed byte,
    then n base-128 varints, zigzag when signed)."""
    out = bytearray()
    vals = [int(v) for v in vals]
    for i in range(0, len(vals), 128):
        group = vals[i:i + 128]
        out.append(256 - len(group))          # -n two's complement
        for v in group:
            out += _pb_varint_enc(_zz_enc(v) if signed else v)
    return bytes(out)


def _byte_rle_enc(data: bytes) -> bytes:
    """Byte RLE, all-literal runs."""
    out = bytearray()
    for i in range(0, len(data), 128):
        group = data[i:i + 128]
        out.append(256 - len(group))
        out += group
    return bytes(out)


def _bool_rle_enc(bits: np.ndarray) -> bytes:
    packed = np.packbits(bits.astype(np.uint8))
    return _byte_rle_enc(packed.tobytes())


def write_orc(path: str, names, columns, valids=None, logicals=None,
              stripe_rows: int = 1 << 20,
              compression: str = "none") -> None:
    """Write columns to an ORC file. Types map from numpy dtypes unless
    `logicals[i]` overrides: ("decimal", p, s) or ("date",). Strings
    pass as object/str arrays. NULLs via `valids` boolean masks.
    `compression` is "none" or "zlib" (raw deflate inside ORC's 3-byte
    chunk framing, applied to streams and metadata sections alike).
    Every stripe's min/max/null statistics are recorded in the file's
    Metadata section for reader-side stripe pruning."""
    comp = {"none": C_NONE, "zlib": C_ZLIB}.get(compression.lower())
    if comp is None:
        raise ValueError(f"unsupported ORC compression: {compression!r}")
    n = len(columns[0]) if columns else 0
    valids = valids or [None] * len(columns)
    logicals = logicals or [None] * len(columns)

    def orc_kind(i):
        lg = logicals[i]
        if lg is not None:
            if lg[0] == "decimal":
                return K_DECIMAL
            if lg[0] == "date":
                return K_DATE
        a = columns[i]
        if a.dtype == np.bool_:
            return K_BOOLEAN
        if np.issubdtype(a.dtype, np.integer):
            return K_INT if a.dtype.itemsize <= 4 else K_LONG
        if np.issubdtype(a.dtype, np.floating):
            return K_DOUBLE
        return K_STRING

    kinds = [orc_kind(i) for i in range(len(columns))]

    body = bytearray(b"ORC")
    stripe_infos = []
    stripe_stat_msgs = []       # one StripeStatistics message per stripe
    for start in range(0, max(n, 1), stripe_rows):
        count = min(stripe_rows, n - start)
        if count <= 0 and n > 0:
            break
        streams = []        # (kind, col_id, bytes)
        encodings = [{1: [E_DIRECT]}]          # root struct
        col_stat_blobs = [pb_encode({1: [count]})]     # root struct stats
        for ci, arr in enumerate(columns):
            cid = ci + 1
            a = arr[start:start + count]
            v = None if valids[ci] is None else \
                np.asarray(valids[ci][start:start + count], dtype=bool)
            if v is not None and not v.all():
                streams.append((S_PRESENT, cid, _bool_rle_enc(v)))
                sel = v
            else:
                sel = np.ones(count, dtype=bool)
                v = None
            present_vals = a[sel] if v is not None else a
            col_stat_blobs.append(_col_stats(
                kinds[ci], present_vals, v is not None, logicals[ci]))
            k = kinds[ci]
            enc = {1: [E_DIRECT]}
            if k == K_BOOLEAN:
                streams.append((S_DATA, cid, _bool_rle_enc(
                    np.asarray(present_vals, dtype=bool))))
            elif k in (K_INT, K_LONG, K_DATE):
                streams.append((S_DATA, cid,
                                _rle_v1_ints(present_vals)))
            elif k == K_DOUBLE:
                streams.append((S_DATA, cid, np.asarray(
                    present_vals, dtype="<f8").tobytes()))
            elif k == K_DECIMAL:
                out = bytearray()
                for x in present_vals:
                    out += _pb_varint_enc(_zz_enc(int(x)))
                streams.append((S_DATA, cid, bytes(out)))
                scale = logicals[ci][2]
                streams.append((S_SECONDARY, cid, _rle_v1_ints(
                    [scale] * len(present_vals))))
            else:                               # strings
                strs = [("" if s is None else str(s)).encode()
                        for s in present_vals]
                streams.append((S_DATA, cid, b"".join(strs)))
                streams.append((S_LENGTH, cid, _rle_v1_ints(
                    [len(s) for s in strs], signed=False)))
            encodings.append(enc)

        offset = len(body)
        data_len = 0
        stream_msgs = []
        for skind, cid, blob in streams:
            framed = _compress_stream(comp, blob)
            body += framed
            data_len += len(framed)
            stream_msgs.append(pb_encode(
                {1: [skind], 2: [cid], 3: [len(framed)]}))
        sfooter = _compress_stream(comp, pb_encode({
            1: [bytes(m) for m in stream_msgs],
            2: [pb_encode(e) for e in encodings],
        }))
        body += sfooter
        stripe_infos.append(pb_encode({
            1: [offset], 2: [0], 3: [data_len], 4: [len(sfooter)],
            5: [count]}))
        stripe_stat_msgs.append(pb_encode({1: col_stat_blobs}))
        if n == 0:
            break

    # footer: type tree (root STRUCT + one child per column)
    types = [pb_encode({1: [K_STRUCT],
                        2: list(range(1, len(columns) + 1)),
                        3: [nm.encode() for nm in names]})]
    for ci in range(len(columns)):
        t = {1: [kinds[ci]]}
        if kinds[ci] == K_DECIMAL:
            t[5] = [logicals[ci][1]]
            t[6] = [logicals[ci][2]]
        types.append(pb_encode(t))
    content_len = len(body)
    # Metadata section (StripeStatistics): between the stripes and the
    # footer; readers prune stripes against it without touching data
    metadata = _compress_stream(comp, pb_encode({1: stripe_stat_msgs}))
    body += metadata
    footer = _compress_stream(comp, pb_encode({
        1: [3],                                # headerLength: "ORC" magic
        2: [content_len],                      # contentLength
        3: stripe_infos,
        4: types,
        6: [n],                                # numberOfRows
        8: [10000],                            # rowIndexStride
    }))
    body += footer
    ps = pb_encode({
        1: [len(footer)],
        2: [comp],
        3: [262144],
        4: [0, 12],                            # version 0.12
        5: [len(metadata)],                    # metadataLength
        6: [6],                                # writerVersion
        8000: [b"ORC"],
    })
    body += ps
    body.append(len(ps))
    from ..utils.atomicio import atomic_write_bytes
    atomic_write_bytes(path, bytes(body))
