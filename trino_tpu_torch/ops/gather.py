"""K1 and K2: the dense-join probe kernels.

Counterpart of ``trino_tpu/ops/pallas_gather.py``.

K1 (TPU kernel ``_scan_kernel`` launched by ``_scan_gather_planes``,
public ``gather_columns``). Contract, bit-exact vs a plain ``take``:

    out[t][i] = tables[t][idx[i]]   if 0 <= idx[i] < W
              = fills[t]            otherwise

The kernel (``csrc/gather.cu``) carries up to MAX_TABLES tables per launch
over native 1/2/4/8-byte lanes and int32 or int64 indices: a CTA keeps a
tile of range-checked int32 indices in registers and walks the tables,
gathering each through L1 (``plan_gather`` splits a call into launches
and picks the tile size). The TPU's VMEM staging, int32 planes and
``W <= 65536`` scan gate do not carry over, so every call site takes the
kernel whenever its mode is on and the dtype gate passes.

K2 (TPU kernel ``_window_kernel`` launched by ``_window_gather_planes``,
public ``gather_word_windowed``): one word of a value-packed LUT per
near-sorted probe index, resolved against a window of 2 * WIN entries
chosen per 1024-index tile; indices outside their tile's window come back
as 0 and are counted as escapes (``csrc/window_gather.cu``). The
"planes" are the LUT in its own word dtype, padded by the TPU's rule, so
window choices and escape totals equal the TPU's.

Each wrapper decides by the tensors' device: CPU tensors get the plain
torch version (the CPU tests' path); CUDA tensors launch the kernel or
raise — there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .cuda_build import check, launch_on, library

MAX_TABLES = 64             # tables per launch (csrc/gather.cu MAX_TABLES)
# K1: a table of at most this many bytes can stay in an SM's L1 (256 KB
# of L1 and shared memory together); a launch with such a table takes big
# tiles, so that a tile reuses the table across more indices
L1_BYTES = 224 * 1024
K1_TILE_BIG = 16384         # indices per big tile (csrc/gather.cu)
MAX_K1_WIDTH = (1 << 31) - 1   # K1 narrows indices to int32
TILE = 1024                 # K2: probe indices per tile (one window each)
WIN = 8192                  # K2: LUT entries per window block
# K2's indices are 32-bit in the kernel
MAX_WINDOWED_ELEMS = (1 << 31) - 1
_WORD_DTYPES = {"int8": torch.int8, "int16": torch.int16,
                "int32": torch.int32, "int64": torch.int64}

_LANE_DTYPES = (torch.bool, torch.int8, torch.uint8, torch.int16,
                torch.int32, torch.int64, torch.float32, torch.float64)


def resolve_mode(setting) -> str:
    """Session-property value -> 'on' | 'off'. `auto` means on, as it
    does on the TPU; the wrapper picks kernel or plain by device."""
    return "on" if str(setting).lower() in ("true", "1", "auto") else "off"


def supports_tables(tables) -> bool:
    """The dtype gate: every table a 1-D engine lane type."""
    return bool(tables) and all(
        t.dtype in _LANE_DTYPES and t.dim() == 1 for t in tables)


_fill_cache = {}


def _fill_bits(fill, dtype: torch.dtype) -> int:
    """The fill value's bit pattern in the table's lane width (numpy's
    cast; cached per dtype and fill)."""
    key = (dtype, type(fill), repr(fill))
    bits = _fill_cache.get(key)
    if bits is None:
        np_dt = torch.empty(0, dtype=dtype).numpy().dtype
        arr = np.zeros(1, dtype=np_dt)
        arr[0] = fill
        bits = int.from_bytes(arr.view(np.uint8).tobytes(), "little")
        if len(_fill_cache) > 4096:
            _fill_cache.clear()
        _fill_cache[key] = bits
    return bits


class K1Launch(NamedTuple):
    """One K1 launch of a call: `tables` are positions in the call's table
    list; `big_tile` asks for 16,384-index tiles (else 4,096)."""
    tables: Tuple[int, ...]
    big_tile: bool


def plan_gather(esizes: Sequence[int], width: int) -> Tuple[K1Launch, ...]:
    """How K1 runs a call of len(esizes) tables of `width` rows: launches
    of at most MAX_TABLES tables in order, each in big tiles where one of
    its tables fits L1_BYTES. Pure and deterministic."""
    return _plan_gather(tuple(esizes), int(width))


@functools.lru_cache(maxsize=1024)
def _plan_gather(esizes, width):
    out = []
    for g0 in range(0, len(esizes), MAX_TABLES):
        grp = esizes[g0:g0 + MAX_TABLES]
        out.append(K1Launch(
            tables=tuple(range(g0, g0 + len(grp))),
            big_tile=any(0 < width * e <= L1_BYTES for e in grp)))
    return tuple(out)


def gather_columns_plain(tables: Sequence[torch.Tensor], idx: torch.Tensor,
                         fills=None) -> List[torch.Tensor]:
    """The plain torch version (CPU tests, and the on-card comparison)."""
    tables = list(tables)
    if fills is None:
        fills = [0] * len(tables)
    w = tables[0].shape[0]
    ok = (idx >= 0) & (idx < w)
    idx_c = idx.clamp(0, max(w - 1, 0))
    out = []
    for t, f in zip(tables, fills):
        if w == 0:
            out.append(torch.full(idx.shape, f, dtype=t.dtype,
                                  device=t.device))
            continue
        out.append(torch.where(ok, t[idx_c],
                               torch.tensor(f, dtype=t.dtype,
                                            device=t.device)))
    return out


def gather_columns(tables: Sequence[torch.Tensor], idx: torch.Tensor,
                   fills=None) -> List[torch.Tensor]:
    """Fused multi-table gather (see module docstring). All tables share
    length W and the index's device."""
    tables = list(tables)
    if fills is None:
        fills = [0] * len(tables)
    if not supports_tables(tables) or len(fills) != len(tables):
        raise ValueError("gather_columns: unsupported tables or fills")
    if idx.dim() != 1 or idx.dtype.is_floating_point or \
            idx.dtype == torch.bool:
        raise ValueError("gather_columns: idx must be a 1-D integer tensor")
    w = tables[0].shape[0]
    dev = idx.device
    for t in tables:
        if t.shape[0] != w or t.device != dev:
            raise ValueError("gather_columns: tables must share length "
                             "and device with the index")
    if dev.type == "cpu":
        return gather_columns_plain(tables, idx, fills)
    if dev.type != "cuda":
        raise RuntimeError(f"gather_columns: no kernel for {dev}")
    return _launch(tables, idx, fills)


gather_columns.launches = 0


def _launch(tables, idx, fills) -> List[torch.Tensor]:
    fn = library("gather").k1_gather
    # the kernel reads int32 and int64 indices as they are
    if idx.dtype != torch.int64 and idx.dtype != torch.int32:
        idx = idx.to(torch.int64)
    if not idx.is_contiguous():
        idx = idx.contiguous()
    n = idx.shape[0]
    w = tables[0].shape[0]
    dev = idx.device
    outs = [torch.empty(n, dtype=t.dtype, device=dev) for t in tables]
    if n == 0:
        return outs
    if w > MAX_K1_WIDTH:
        raise ValueError(f"gather_columns: {w} rows exceed K1's int32 "
                         f"indices")
    tables = [t if t.is_contiguous() else t.contiguous() for t in tables]
    with launch_on(dev) as stream:
        for plan in plan_gather([t.element_size() for t in tables], w):
            desc = (ctypes.c_uint64 * (4 * len(plan.tables)))()
            for k, p in enumerate(plan.tables):
                desc[4 * k] = tables[p].data_ptr()
                desc[4 * k + 1] = outs[p].data_ptr()
                desc[4 * k + 2] = _fill_bits(fills[p], tables[p].dtype)
                desc[4 * k + 3] = tables[p].element_size()
            status = fn(idx.data_ptr(), idx.element_size(), n, w,
                        len(plan.tables), desc, int(plan.big_tile), stream)
            check(status, "K1 gather launch")
            gather_columns.launches += 1
    return outs


# --------------------------------------------------------------------------
# K2: windowed single-word gather for near-sorted probe keys
# --------------------------------------------------------------------------

def _pad_to(x: torch.Tensor, mult: int, value) -> torch.Tensor:
    pad = (-x.shape[0]) % mult
    if pad == 0:
        return x
    return torch.cat([x, torch.full((pad,), value, dtype=x.dtype,
                                    device=x.device)])


def prepare_word_planes(lut: torch.Tensor) -> torch.Tensor:
    """One-time prep of a value-packed LUT for gather_word_windowed: the
    LUT in its own word dtype, padded with 0 to whole windows and to at
    least two (the TPU's rule: window choices depend on the padded
    length). The chunked driver calls this once per pinned LUT."""
    planes = _pad_to(lut, WIN, 0)
    if planes.shape[0] < 2 * WIN:
        planes = _pad_to(planes, 2 * WIN, 0)
    return planes


def _window_index(planes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The TPU wrapper's index prep: anything outside [0, W) of the
    PADDED LUT becomes -1 before the int32 narrowing, then -1 pads to
    whole tiles aligned at index 0."""
    w = planes.shape[0]
    ok = (idx >= 0) & (idx < w)
    idx32 = torch.where(ok, idx, -1).to(torch.int32)
    return _pad_to(idx32, TILE, -1)


def window_base_blocks(idx32: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """Per-tile window choice: the tile's least in-range index rounded
    down to a WIN block, clipped to n_blocks - 2 (the window is that
    block and the next)."""
    tiles = idx32.view(-1, TILE)
    lo = torch.where(tiles >= 0, tiles, 2147483647).amin(dim=1)
    return (lo // WIN).clamp(0, max(n_blocks - 2, 0)).to(torch.int32)


def _check_windowed(planes: torch.Tensor, idx: torch.Tensor,
                    word_dtype: str) -> None:
    if _WORD_DTYPES.get(str(word_dtype)) != planes.dtype or \
            planes.dim() != 1:
        raise ValueError(f"gather_word_windowed: planes {planes.dtype} are "
                         f"not a 1-D {word_dtype} LUT")
    n_planes = planes.shape[0]
    if n_planes % WIN or n_planes < 2 * WIN or \
            n_planes > MAX_WINDOWED_ELEMS:
        raise ValueError("gather_word_windowed: planes not prepared by "
                         "prepare_word_planes")
    if idx.dim() != 1 or idx.dtype.is_floating_point or \
            idx.dtype == torch.bool or idx.device != planes.device:
        raise ValueError("gather_word_windowed: idx must be a 1-D integer "
                         "tensor on the planes' device")


def gather_word_windowed_plain(planes: torch.Tensor, idx: torch.Tensor,
                               word_dtype: str):
    """The plain torch version of K2 (CPU tests, and the on-card
    comparison): per-tile amin over a [tiles, 1024] view."""
    _check_windowed(planes, idx, word_dtype)
    n = idx.shape[0]
    idx32 = _window_index(planes, idx)
    base = window_base_blocks(idx32, planes.shape[0] // WIN)
    tiles = idx32.view(-1, TILE).to(torch.int64)
    rel = tiles - base.to(torch.int64)[:, None] * WIN
    in_range = tiles >= 0
    in_win = in_range & (rel >= 0) & (rel < 2 * WIN)
    escaped = (in_range & ~in_win).sum(dtype=torch.int64)
    word = torch.where(in_win, planes[torch.where(in_win, tiles, 0)]
                       .to(torch.int64), 0)
    return word.flatten()[:n], escaped


def gather_word_windowed(planes: torch.Tensor, idx: torch.Tensor,
                         word_dtype: str):
    """Windowed single-word gather off prepared planes
    (prepare_word_planes): returns (word int64 [n], escaped int64
    scalar). `escaped` counts in-range indices outside their tile's
    window; those rows come back as 0 (the packed-LUT miss word) and the
    caller must rerun through its escape machinery when it is > 0."""
    _check_windowed(planes, idx, word_dtype)
    dev = idx.device
    if dev.type == "cpu":
        return gather_word_windowed_plain(planes, idx, word_dtype)
    if dev.type != "cuda":
        raise RuntimeError(f"gather_word_windowed: no kernel for {dev}")
    return _launch_window(planes, idx)


gather_word_windowed.launches = 0


def _launch_window(planes: torch.Tensor, idx: torch.Tensor):
    fn = library("window_gather").k2_window_gather
    # the kernel does _window_index's prep itself, from int64 indices
    if idx.dtype != torch.int64:
        idx = idx.to(torch.int64)
    if not idx.is_contiguous():
        idx = idx.contiguous()
    if not planes.is_contiguous():
        planes = planes.contiguous()
    n = idx.shape[0]
    # the words and the escape total in one allocation
    buf = idx.new_empty(n + 1)
    if n == 0:
        buf.zero_()
        return buf[:0], buf[0]
    ptr = buf.data_ptr()
    with launch_on(idx.device) as stream:
        status = fn(idx.data_ptr(), n, planes.data_ptr(), planes.shape[0],
                    planes.element_size(), ptr, ptr + 8 * n, stream)
        check(status, "K2 window gather launch")
        gather_word_windowed.launches += 1
    return buf[:n], buf[n]
