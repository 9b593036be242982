"""Port copy of ``trino_tpu/utils/atomicio.py`` (unchanged).

Crash-safe file writes (temp + fsync + atomic rename).

The diskcache connector established the pattern (connectors/diskcache.py):
never let a reader observe a torn file. Writers materialize the full byte
body into a same-directory temp name, fsync the file, rename it over the
destination, then fsync the parent directory so the rename itself is
durable. A crash at any point leaves either the old file, no file, or a
dot-prefixed temp that directory scans skip — never a truncated table.
"""

import os
import tempfile


def atomic_write_bytes(path: str, data: bytes, fsync: bool = True) -> None:
    """Write ``data`` to ``path`` so a crash can never expose a prefix."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp.",
                               suffix=os.path.basename(path))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if fsync:
            fsync_dir(d)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def fsync_dir(path: str) -> None:
    """Durably record directory-entry changes (renames, unlinks)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
