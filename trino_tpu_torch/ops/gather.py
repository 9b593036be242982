"""K1: fused multi-table gather — the dense-join probe kernel.

Counterpart of ``trino_tpu/ops/pallas_gather.py`` (TPU kernel
``_scan_kernel`` launched by ``_scan_gather_planes``, public
``gather_columns``). Contract, bit-exact vs a plain ``take``:

    out[t][i] = tables[t][idx[i]]   if 0 <= idx[i] < W
              = fills[t]            otherwise

The kernel (``csrc/gather.cu``) is one thread per output index over native
1/2/4/8-byte lanes; the TPU's int32 planes and its ``W <= 65536`` scan gate
do not carry over (a GPU gather costs the same at any W), so every call
site takes the kernel whenever its mode is on and the dtype gate passes.

The wrapper decides by the tensors' device: CPU tensors get the plain
torch version (the CPU tests' path); CUDA tensors launch the kernel or
raise — there is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np
import torch

MAX_TABLES = 16             # tables per launch (csrc/gather.cu MAX_TABLES)

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


def _fill_bits(fill, dtype: torch.dtype) -> int:
    """The fill value's bit pattern in the table's lane width."""
    np_dt = torch.empty(0, dtype=dtype).numpy().dtype
    arr = np.zeros(1, dtype=np_dt)
    arr[0] = fill
    raw = arr.view(np.uint8)
    return int.from_bytes(raw.tobytes(), "little")


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
    from .cuda_build import check, library
    lib = library("gather")
    fn = lib.k1_gather
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    idx = idx.to(torch.int64).contiguous()
    n = idx.shape[0]
    w = tables[0].shape[0]
    outs = [torch.empty(n, dtype=t.dtype, device=idx.device)
            for t in tables]
    tables = [t.contiguous() for t in tables]
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    for g0 in range(0, len(tables), MAX_TABLES):
        grp = tables[g0:g0 + MAX_TABLES]
        k = len(grp)
        tab_p = (ctypes.c_void_p * k)(*[t.data_ptr() for t in grp])
        out_p = (ctypes.c_void_p * k)(
            *[o.data_ptr() for o in outs[g0:g0 + k]])
        esz = (ctypes.c_int * k)(*[t.element_size() for t in grp])
        fl = (ctypes.c_uint64 * k)(
            *[_fill_bits(f, t.dtype)
              for f, t in zip(fills[g0:g0 + k], grp)])
        status = fn(idx.data_ptr(), n, w, k, ctypes.cast(tab_p,
                                                         ctypes.c_void_p),
                    ctypes.cast(out_p, ctypes.c_void_p),
                    ctypes.cast(esz, ctypes.c_void_p),
                    ctypes.cast(fl, ctypes.c_void_p), stream)
        check(status, "K1 gather launch")
        gather_columns.launches += 1
    return outs
