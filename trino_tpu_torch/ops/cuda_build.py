"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The TPU package had no build step (Pallas kernels compile inside the jit);
this module is the port's equivalent. Each source compiles with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

``csrc/glibc_math.cu`` adds ``-fmad=false`` (its FMAs are written out, and
nothing else may fuse). The library name carries a hash of the source, the
headers under ``csrc/`` and the flags, so an edited source rebuilds and an unchanged one loads from ``_build/`` (listed in
.gitignore; ``$TRINO_TPU_CUDA_BUILD_DIR`` if set). Nothing builds at import time: the first kernel launch (or
``build_all``) does. A missing ``nvcc`` or a failed build raises.

Every C entry's signature stands in ``SIGNATURES`` and is bound once, when
its library loads; ``library`` takes its lock only to build or load, so a
launch pays one dict lookup for its entry.

Each load is recorded in the compile recorder (``exec/profiler.RECORDER``)
as site ``cuda_build.<kernel>`` with the source digest as fingerprint: a
library this process built is a compile with its nvcc seconds, one found
already built is a hit. The record is made on the thread that loads the
library, so a build that a kernel's first launch triggers inside a
profiled dispatch is charged to that thread's ``thread_compile_seconds``
(the operator's `compile` component) and to the ExecStats it bound.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
# TRINO_TPU_CUDA_BUILD_DIR puts the libraries elsewhere (an empty
# directory makes every first launch build its library again)
BUILD_DIR = Path(os.environ.get("TRINO_TPU_CUDA_BUILD_DIR")
                 or PKG_DIR / "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
KERNEL_SOURCES = ("gather", "window_gather", "hash_insert", "multiprobe",
                  "direct_agg", "glibc_math")
EXTRA_FLAGS = {"glibc_math": ("-fmad=false",)}

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# library -> {C entry: argtypes}; every entry returns a CUDA status (int)
SIGNATURES = {
    # idx, idx bytes, n, width, tables, descriptors, big tile, stream
    "gather": {"k1_gather": [_P, _I, _I64, _I64, _I, _P, _I, _P]},
    # idx, n, lut, lut_len, esize, out, esc, stream
    "window_gather": {"k2_window_gather": [_P, _I64, _P, _I64, _I, _P, _P,
                                           _P]},
    # key, mask, tid, n, layout, planes, buf, T, G, cap, pairs,
    # pair state, stream
    "hash_insert": {"k3_hash_insert_multi": [_P] * 3 + [_I64] + [_P] * 3 +
                    [_I64, _I, _I, _P, _I, _P]},
    # live, dims, n, k, table, T, found, miss, stream
    "multiprobe": {"k4_multiprobe": [_P, _P, _I64, _I, _P, _I64, _P, _P,
                                     _P]},
    # live, words, n, keys, aggregates, groups, out, scratch, stream
    "direct_agg": {"k5_direct_agg": [_P, _P, _I64, _I, _I, _I, _P, _P,
                                     _P]},
    # x, (y,) out, n, stream
    "glibc_math": {"glibc_log": [_P, _P, _I64, _P],
                   "glibc_pow": [_P, _P, _P, _I64, _P]},
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# library -> nvcc seconds of a build this process made and has not loaded
_built_s: Dict[str, float] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels cannot be built")


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _digest(name: str) -> str:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    for header in sorted(SRC_DIR.glob("*.h")):
        src += header.read_bytes()
    return hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()


def _target(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)[:16]}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp path, target) or
    None when the library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc_path(), *_flags(name), "-o", str(tmp),
           str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.monotonic()


def _finish_build(name: str, started) -> None:
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    _built_s[name] = time.monotonic() - t0


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> float:
    """Build every named kernel library, all nvcc processes started
    together; returns the wall seconds spent."""
    t0 = time.monotonic()
    with _lock:
        started = {n: _start_build(n) for n in names}
        for n, s in started.items():
            if s is not None:
                _finish_build(n, s)
    return time.monotonic() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, building it on first use, its C
    entries bound to their SIGNATURES."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        started = _start_build(name)
        if started is not None:
            _finish_build(name, started)
        lib = ctypes.CDLL(str(_target(name)))
        for entry, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
        built_s = _built_s.pop(name, None)
    from ..exec.profiler import RECORDER
    RECORDER.record(f"cuda_build.{name}", _digest(name)[:16],
                    built_s or 0.0, hit=built_s is None)
    return lib


def load_all(names: Iterable[str] = KERNEL_SOURCES) -> int:
    """Build (all nvcc processes together) and load every named kernel
    library; returns how many were loaded by this call."""
    names = [n for n in names if n not in _libs]
    build_all(names)
    for n in names:
        library(n)
    return len(names)


def _card(device) -> torch.device:
    """`device` with its index: an index-less `cuda` is the current card."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def raw_stream(device) -> int:
    """The current CUDA stream's handle on `device`: the raw handle
    torch's own generated kernels launch on, without building a
    torch.cuda.Stream object per call."""
    return torch._C._cuda_getCurrentRawStream(_card(device).index)


@contextlib.contextmanager
def launch_on(device):
    """Make `device`'s card current for a ctypes launch and yield its
    current stream's handle. A launch goes to a stream of the card that
    is current, and the C entries read the current card (its
    multiprocessor count, occupancy), so every launch enters the card
    its tensors lie on; on leaving, the card that was current before is
    current again. A wrapper adds to its launch count inside this block,
    so the count can be read per card around it."""
    dev = _card(device)
    with torch.cuda.device(dev):
        yield raw_stream(dev)


def check(status: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (cudaGetLastError)."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
