"""The chip's peaks and each hand-written kernel's bytes, from the shapes
of its launch.

Each function counts what the launch must move at the least: every
input read once and every output written once, whatever the kernel
reads again. A kernel's roofline share is then the least time, these
bytes over the peak bandwidth, over the device time that the trace gives
its launches. The kernels' names in the trace are those of their
``__global__`` functions in the program's ``csrc/``.
"""

from __future__ import annotations

import re

# NVIDIA H100 SXM5 80GB HBM3 data sheet: HBM bandwidth, bytes/s
PEAK_HBM_BYTES_S = 3.35e12

# the device functions of each kernel, as the trace names them
KERNEL_NAMES = {
    "K1": re.compile(r"(^|[^_A-Za-z0-9])gather_kernel\b"),
    "K2": re.compile(r"window_gather_kernel"),
    "K3": re.compile(r"(^|[^_A-Za-z0-9])(insert_kernel|epilogue_kernel)\b"),
    "K4": re.compile(r"multiprobe_kernel"),
    "K5": re.compile(r"k5_direct_agg_kernel"),
    "glibc": re.compile(r"(^|[^_A-Za-z0-9])(log_kernel|pow_kernel)\b"),
}


def kernel_of(name: str):
    """The hand-written kernel a device activity belongs to, or None."""
    for k, pat in KERNEL_NAMES.items():
        if pat.search(name):
            return k
    return None


def _nbytes(t) -> int:
    return 0 if t is None else int(t.numel()) * int(t.element_size())


def k1_bytes(tables, idx) -> int:
    """K1 (``gather_columns``): the indices once, each table once, and one
    output element a table for each index."""
    n = int(idx.shape[0])
    return _nbytes(idx) + sum(_nbytes(t) + n * int(t.element_size())
                              for t in tables)


def k3_bytes(key, mask, tid, planes, nstates, T, G, pairs) -> int:
    """K3 (``hash_insert_multi``): keys, the row mask, the table ids and
    each aggregate's values and valid flags once, and the G tables of T
    slots (key word and one word a state, int64; the pair planes where
    asked) written once, as the program's kernel table counts them."""
    planes_b = sum(_nbytes(v) + _nbytes(ok) for v, ok in planes)
    table_b = 8 * G * T * (1 + nstates + (2 if pairs else 0))
    return _nbytes(key) + _nbytes(mask) + _nbytes(tid) + planes_b + table_b

