"""Device-resident fact-column cache with range-compressed dtypes.

Counterpart of ``trino_tpu/exec/device_cache.py`` (Trino's memory-pinned
page cache and the bit-packed integers of ORC/Parquet, moved onto the
device): the chunked driver's fact table stays resident on the card in the
NARROWEST integer dtype its value range allows, and each chunk widens to
the engine's lane dtype as it is sliced (exec/chunked.py). Steady-state
chunked queries then never copy the fact table from the host again.

Host-to-device transfers ship low-entropy encodings (sorted keys as int8
deltas, other multi-byte integers as byte planes) and decode on the card
with torch ops; steady state sees ordinary narrow columns. A disk tier
keeps the encoded columns of deterministic catalogs under
``connectors/diskcache.cache_root()``, checked against a fingerprint of
the source so a regenerated table never serves stale data.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


class NarrowColumn:
    """One device-resident column: narrow-dtype data + optional validity."""

    __slots__ = ("data", "valid", "wide_dtype")

    def __init__(self, data, valid, wide_dtype):
        self.data = data              # torch.Tensor, narrowest safe dtype
        self.valid = valid            # torch.Tensor bool or None (all valid)
        self.wide_dtype = wide_dtype  # numpy dtype the engine's lanes expect

    @property
    def nbytes(self) -> int:
        n = self.data.numel() * self.data.element_size()
        if self.valid is not None:
            n += self.valid.numel()
        return n


_INT_STEPS = (np.int8, np.int16, np.int32, np.int64)


# ---------------------------------------------------------------------------
# transfer encodings: sorted key columns delta-encode (tiny repeated values),
# other multi-byte integers split into byte planes (near-constant high bytes
# compress away); decode runs on the card right after the copy
# ---------------------------------------------------------------------------

def encode_transfer(narrow: np.ndarray):
    """-> (enc, payload ndarray, meta dict). enc: raw | delta8 | planes."""
    if narrow.dtype.itemsize == 1 or \
            not np.issubdtype(narrow.dtype, np.integer) or \
            narrow.size < 2:
        return "raw", narrow, {}
    d = np.diff(narrow)
    if d.size and int(d.min()) >= -128 and int(d.max()) <= 127:
        return "delta8", d.astype(np.int8), {
            "base": int(narrow[0]), "dtype": str(narrow.dtype)}
    k = narrow.dtype.itemsize
    planes = np.ascontiguousarray(
        narrow.view(np.uint8).reshape(-1, k).T)
    return "planes", planes, {"dtype": str(narrow.dtype)}


def decode_transfer(enc: str, payload: torch.Tensor, meta: dict):
    """Decode on the payload's device. Built on int64 with left shifts and
    masks only (torch has no unsigned right shift on the CPU); the final
    narrowing cast keeps the low bits, which is the two's-complement
    reinterpretation the reference's bitcast does."""
    if enc == "raw":
        return payload
    from ..batch import torch_dtype
    dt = torch_dtype(meta["dtype"])
    if enc == "delta8":
        cs = torch.cumsum(payload.to(torch.int64), 0)
        full = torch.cat([torch.zeros(1, dtype=torch.int64,
                                      device=payload.device), cs])
        return (full + int(meta["base"])).to(dt)
    word = payload[0].to(torch.int64)
    for j in range(1, payload.shape[0]):
        word = word | (payload[j].to(torch.int64) << (8 * j))
    return word.to(dt)


# TRINO_TPU_CHUNK_PROFILE=1: per-phase walls to stderr (read at call time so
# the toggle works however late it is set); shared by the chunked driver
# and the ingest path
def profile_enabled() -> bool:
    return bool(os.environ.get("TRINO_TPU_CHUNK_PROFILE"))


def prof(msg: str) -> None:
    if profile_enabled():
        print(f"[chunk {time.monotonic():.3f}] {msg}", file=sys.stderr,
              flush=True)


_warmed = set()


def warm_transfer_path(device) -> None:
    """One small incompressible host-to-device copy before the first bulk
    ingest on `device` (the reference opens its transfer path this way;
    on a local card it costs one 4 MB copy and nothing else)."""
    device = torch.device(device)
    if device.type == "cpu" or device in _warmed:
        return
    _warmed.add(device)
    x = np.random.default_rng(0).integers(0, 1 << 30, size=1_000_000,
                                          dtype=np.int32)
    torch.from_numpy(x).to(device)


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    """Host array (a read-only mmap too) to a tensor on `device`."""
    return torch.from_numpy(np.require(arr, requirements=["C", "W"])) \
        .to(device)


def _narrow_dtype(arr: np.ndarray, valid: Optional[np.ndarray]):
    """Smallest signed integer dtype holding the column's valid values."""
    if not np.issubdtype(arr.dtype, np.integer):
        return arr.dtype                       # floats/bools ship as-is
    if valid is not None:
        vals = arr[valid]
        if len(vals) == 0:
            return np.int8
        lo, hi = int(vals.min()), int(vals.max())
    elif len(arr) == 0:
        return np.int8
    else:
        lo, hi = int(arr.min()), int(arr.max())
    for dt in _INT_STEPS:
        info = np.iinfo(dt)
        if info.min <= lo and hi <= info.max:
            return dt
    return np.int64


class FactTableCache:
    """LRU of device-resident narrowed fact tables, capped by device bytes.

    Keys are (catalog, schema, table, column_indices) as the chunked driver
    builds them; the disk tier's fingerprint guards regenerated tables."""

    def __init__(self, max_bytes: int = 9 << 30):
        self.max_bytes = max_bytes
        self._entries: "OrderedDict[tuple, Tuple[List[NarrowColumn], int]]" \
            = OrderedDict()
        self._bytes: Dict[tuple, int] = {}
        self.hits = 0
        self.misses = 0

    def total_bytes(self) -> int:
        return sum(self._bytes.values())

    def get(self, key) -> Optional[List[NarrowColumn]]:
        hit = self._entries.get(key)
        if hit is None:
            return None
        self._entries.move_to_end(key)
        return hit[0]

    def invalidate(self) -> int:
        """Drop everything; returns bytes released."""
        freed = self.total_bytes()
        self._entries.clear()
        self._bytes.clear()
        return freed

    def estimate_bytes(self, data, column_indices) -> int:
        """Cheap upper estimate without the min/max pass: int32 narrowing
        for wider integers plus validity bytes. Rejects tables early."""
        n = data.num_rows
        total = 0
        for i in column_indices:
            arr = np.asarray(data.columns[i])
            itemsize = min(arr.dtype.itemsize, 4) \
                if np.issubdtype(arr.dtype, np.integer) else \
                arr.dtype.itemsize
            total += n * itemsize
            if data.valids is not None and data.valids[i] is not None:
                total += n
        return total

    def _narrow_disk_dir(self, key) -> str:
        from ..connectors.diskcache import cache_root
        h = hashlib.sha256(repr(key).encode()).hexdigest()[:24]
        return os.path.join(cache_root(), f"narrow_torch_{h}")

    @staticmethod
    def _source_fingerprint(data, column_indices) -> str:
        """Row count + per-column dtype + head/tail samples: catches a
        regenerated table (same name, new data) without a full read."""
        h = hashlib.sha256(str(data.num_rows).encode())
        for i in column_indices:
            arr = np.asarray(data.columns[i])
            h.update(str(arr.dtype).encode())
            h.update(np.ascontiguousarray(arr[:1024]).tobytes())
            h.update(np.ascontiguousarray(arr[-1024:]).tobytes())
        return h.hexdigest()

    def _load_narrow_disk(self, key, data, column_indices):
        """mmap previously narrowed columns in their transfer encoding."""
        d = self._narrow_disk_dir(key)
        meta_p = os.path.join(d, "meta.json")
        if not os.path.isfile(meta_p):
            return None
        try:
            with open(meta_p) as f:
                meta = json.load(f)
            if meta.get("v") != 2 or meta.get("fingerprint") != \
                    self._source_fingerprint(data, column_indices):
                return None           # format or table changed
            out = []
            for j, cm in enumerate(meta["cols"]):
                payload = np.load(os.path.join(d, f"c{j}.npy"),
                                  mmap_mode="r")
                valid = None
                vp = os.path.join(d, f"v{j}.npy")
                if os.path.isfile(vp):
                    valid = np.load(vp, mmap_mode="r")
                out.append((cm, payload, valid))
            return out
        except Exception:     # noqa: BLE001 — corrupt cache = cold start
            return None

    def _save_narrow_disk(self, key, encoded, fingerprint) -> None:
        d = self._narrow_disk_dir(key)
        tmp = d + f".tmp{os.getpid()}"
        try:
            os.makedirs(tmp, exist_ok=True)
            cols = []
            for j, (cm, payload, valid) in enumerate(encoded):
                np.save(os.path.join(tmp, f"c{j}.npy"), payload)
                if valid is not None:
                    np.save(os.path.join(tmp, f"v{j}.npy"), valid)
                cols.append(cm)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"v": 2, "cols": cols,
                           "fingerprint": fingerprint}, f)
            if os.path.isdir(d):      # os.replace cannot overwrite a
                shutil.rmtree(d, ignore_errors=True)   # non-empty dir
            os.replace(tmp, d)
        except Exception:     # noqa: BLE001 — cache write is best-effort
            shutil.rmtree(tmp, ignore_errors=True)

    def load(self, key, data, column_indices, device,
             persist_ok: bool = False) -> Optional[List[NarrowColumn]]:
        """Narrow and ship `column_indices` of `data` to `device`, evicting
        LRU entries to fit. None if the table cannot fit the budget. With
        persist_ok (deterministic catalogs only) the encoded host arrays
        also cache on disk, so a later process ships them straight from
        the mmap with no host passes."""
        prof_on = profile_enabled()
        from ..metrics import DEVICE_CACHE_HITS, DEVICE_CACHE_MISSES
        hit = self.get(key)
        if hit is not None:
            self.hits += 1
            DEVICE_CACHE_HITS.inc()
            return hit
        self.misses += 1
        DEVICE_CACHE_MISSES.inc()
        warm_transfer_path(device)
        disk = self._load_narrow_disk(key, data, column_indices) \
            if persist_ok else None
        cols: List[NarrowColumn] = []
        total = 0
        to_persist = []
        for j, i in enumerate(column_indices):
            t0 = time.monotonic()
            if disk is not None:
                cm, payload, valid_np = disk[j]
                enc, wide_dt = cm["enc"], np.dtype(cm["wide"])
                narrow_nbytes = data.num_rows * \
                    np.dtype(cm.get("dtype", "int8")).itemsize \
                    if enc != "raw" else payload.nbytes
            else:
                arr = np.asarray(data.columns[i])
                wide_dt = arr.dtype
                valid_np = None
                if data.valids is not None and data.valids[i] is not None:
                    valid_np = np.asarray(data.valids[i])
                dt = _narrow_dtype(arr, valid_np)
                narrow = arr if arr.dtype == dt else arr.astype(dt)
                if valid_np is not None and narrow is not arr:
                    # invalid slots may hold out-of-range garbage: zero
                    # them so the narrowed cast is well-defined
                    narrow = np.where(valid_np, narrow, np.zeros((), dt))
                enc, payload, em = encode_transfer(narrow)
                cm = dict(em, enc=enc, wide=str(wide_dt),
                          dtype=str(narrow.dtype))
                narrow_nbytes = narrow.nbytes
            total += narrow_nbytes + \
                (data.num_rows if valid_np is not None else 0)
            if total > self.max_bytes:
                return None
            t1 = time.monotonic()
            dev_payload = _to_device(payload, device)
            d = decode_transfer(enc, dev_payload, cm)
            dv = None if valid_np is None else _to_device(valid_np, device)
            if prof_on:
                print(f"[ingest] col {i}: {payload.nbytes / 1e6:.0f}MB "
                      f"enc={enc} host {t1 - t0:.3f}s copy+decode "
                      f"{time.monotonic() - t1:.3f}s disk={disk is not None}",
                      file=sys.stderr, flush=True)
            cols.append(NarrowColumn(d, dv, wide_dt))
            if persist_ok and disk is None:
                to_persist.append((cm, payload, valid_np))
        if to_persist:
            self._save_narrow_disk(key, to_persist,
                                   self._source_fingerprint(
                                       data, column_indices))
        while self._entries and self.total_bytes() + total > self.max_bytes:
            old, _ = self._entries.popitem(last=False)
            self._bytes.pop(old, None)
        self._entries[key] = (cols, data.num_rows)
        self._bytes[key] = total
        return cols
