"""Write the tables of glibc's `log` and `pow` as a C header.

    python3 tools/extract_glibc_math_tables.py [LIBM] [OUT]

Since glibc 2.28, `log` and `pow` on x86_64 are the table-and-polynomial
algorithms of Arm's optimized-routines. Their data lives in libm's
read-only data under hidden symbols that `nm -D` does not list
(`__log_data`, `__pow_log_data`, `__exp_data`); this script finds each
by its leading constants and checks what follows:

- `__log_data`: ln2hi, ln2lo, then poly[0] = -0x1.0000000000001p-1;
  layout ln2hi, ln2lo, poly[5], poly1[11], tab[128] of {invc, logc}
  (the FMA build reads no tab2);
- `__pow_log_data`: ln2hi, ln2lo, then poly[0] = -0.5; layout ln2hi,
  ln2lo, poly[7], tab[128] of {invc, pad, logc, logctail};
- `__exp_data`: invln2N = 0x1.71547652b82fep7; layout invln2N,
  negln2hiN, negln2loN, poly[4], shift, exp2_shift, exp2_poly[5],
  tab[256] (the 2.36 layout: shift after the polynomial).

Every value is written as its 64-bit pattern, so the header is exact.
LIBM defaults to the libm this interpreter loads, OUT to
`trino_tpu_torch/csrc/glibc_math_tables.h`. The CUDA source
`csrc/glibc_math.cu` includes the header, and `ops/project.py` reads it
for its plain replay.
"""

import ctypes
import ctypes.util
import os
import struct
import sys

LN2HI = float.fromhex("0x1.62e42fefa3800p-1")
LN2LO = float.fromhex("0x1.ef35793c76730p-45")
LOG_POLY0 = float.fromhex("-0x1.0000000000001p-1")
INVLN2N = float.fromhex("0x1.71547652b82fep7")
EXP_SHIFT = float.fromhex("0x1.8p52")

LOG_WORDS = 2 + 5 + 11 + 2 * 128
POW_WORDS = 2 + 7 + 4 * 128
EXP_WORDS = 4 + 3 + 1 + 1 + 5 + 2 * 128


def loaded_libm() -> str:
    ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    with open("/proc/self/maps") as maps:
        for line in maps:
            path = line.split()[-1]
            if os.path.basename(path).startswith("libm.so"):
                return path
    raise RuntimeError("libm is not mapped")


def find(blob: bytes, lead: bytes, then=None) -> int:
    at = blob.find(lead)
    while at >= 0:
        if at % 8 == 0 and (then is None or
                            blob[at + len(lead):at + len(lead) + 8] == then):
            return at
        at = blob.find(lead, at + 1)
    raise RuntimeError(f"constants {lead.hex()} not found")


def words(blob: bytes, at: int, n: int):
    return list(struct.unpack_from(f"<{n}Q", blob, at))


def as_double(w: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", w))[0]


def extract(blob: bytes) -> dict:
    ln2 = struct.pack("<dd", LN2HI, LN2LO)
    log = words(blob, find(blob, ln2, struct.pack("<d", LOG_POLY0)),
                LOG_WORDS)
    pw = words(blob, find(blob, ln2, struct.pack("<d", -0.5)), POW_WORDS)
    ex = words(blob, find(blob, struct.pack("<d", INVLN2N)), EXP_WORDS)
    # what must follow if the layouts are the ones described above
    if as_double(ex[7]) != EXP_SHIFT or ex[14] != 0 or \
            ex[15] != 0x3FF0000000000000:
        raise RuntimeError("__exp_data does not have the expected layout")
    for i in range(128):
        invc = as_double(log[18 + 2 * i])
        pinvc = as_double(pw[9 + 4 * i])
        if not (0.7 < invc < 1.5 and 0.7 < pinvc < 1.5 and
                pw[9 + 4 * i + 1] == 0):
            raise RuntimeError("a log table does not have the expected "
                               "layout")
    return {"GLIBC_LOG_DATA": log, "GLIBC_POW_LOG_DATA": pw,
            "GLIBC_EXP_DATA": ex}


def header(tables: dict, source: str) -> str:
    out = ["// Generated by tools/extract_glibc_math_tables.py from "
           f"{os.path.basename(source)}: do not edit.",
           "// The data of glibc's log and pow (Arm optimized-routines), "
           "each value as its",
           "// 64-bit pattern. Layouts: see the script's docstring.",
           "// A CUDA source defines GLIBC_TABLE_QUAL as __device__ first.",
           "#pragma once", "#ifndef GLIBC_TABLE_QUAL",
           "#define GLIBC_TABLE_QUAL", "#endif", ""]
    for name, ws in tables.items():
        out.append(f"#define {name}_WORDS {len(ws)}")
        out.append(f"GLIBC_TABLE_QUAL static const unsigned long long "
                   f"{name}_BITS[] = {{")
        for i in range(0, len(ws), 4):
            out.append("    " + ", ".join(f"0x{w:016x}ULL"
                                          for w in ws[i:i + 4]) + ",")
        out.append("};")
        out.append("")
    return "\n".join(out)


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    libm = sys.argv[1] if len(sys.argv) > 1 else loaded_libm()
    dest = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        here, "trino_tpu_torch", "csrc", "glibc_math_tables.h")
    with open(libm, "rb") as f:
        blob = f.read()
    with open(dest, "w") as f:
        f.write(header(extract(blob), libm))
    print(f"wrote {dest} from {libm}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
