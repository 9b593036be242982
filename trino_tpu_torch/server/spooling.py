"""Port copy of ``trino_tpu/server/spooling.py`` (no edits).

Result spooling: large result sets as fetch/ack segments.

Reference: the spooled client protocol (server/protocol/spooling/ —
SpoolingManagerBridge, CoordinatorSegmentResource; SPI spi/spool/
SpoolingManager.java; plugin/trino-spooling-filesystem). Clients that
opt in receive segment descriptors instead of inline data, fetch each
segment by URI, and acknowledge it — decoupling result lifetime from the
query and keeping coordinator memory flat.

Here: segments are JSON files under a spool directory; ack deletes.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
import uuid
from typing import List, Optional


class SpoolingManager:
    def __init__(self, directory: Optional[str] = None,
                 segment_rows: int = 5000):
        self.directory = directory or tempfile.mkdtemp(prefix="spool-")
        os.makedirs(self.directory, exist_ok=True)
        self.segment_rows = segment_rows
        self._lock = threading.Lock()
        self.segments_written = 0

    def _path(self, segment_id: str) -> str:
        # ids are uuid4 hex (validated on read): no path traversal
        return os.path.join(self.directory, f"{segment_id}.json")

    def spool(self, rows: List[list]) -> List[dict]:
        """Write rows as segments; returns descriptors
        [{id, uri(relative), rowCount}]."""
        descriptors = []
        for start in range(0, len(rows), self.segment_rows):
            chunk = rows[start:start + self.segment_rows]
            sid = uuid.uuid4().hex
            with open(self._path(sid), "w") as f:
                json.dump(chunk, f)
            with self._lock:
                self.segments_written += 1
            descriptors.append({
                "id": sid,
                "uri": f"/v1/spooled/segments/{sid}",
                "rowCount": len(chunk)})
        return descriptors

    def read(self, segment_id: str) -> Optional[list]:
        if not segment_id.isalnum():
            return None
        try:
            with open(self._path(segment_id)) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def ack(self, segment_id: str) -> None:
        if not segment_id.isalnum():
            return
        try:
            os.remove(self._path(segment_id))
        except FileNotFoundError:
            pass
