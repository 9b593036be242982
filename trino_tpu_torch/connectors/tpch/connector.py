"""Port copy of ``trino_tpu/connectors/tpch/connector.py`` (no edits beyond
import targets noted inline).

TPC-H connector: schema catalog over the deterministic generator.

Reference: plugin/trino-tpch (TpchMetadata.java:100 exposes schemas
tiny/sf1/sf100/..., TpchRecordSet.java:44 generates rows on demand).
Generated tables are cached per scale factor for the process lifetime.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

from .datagen import TableData, generate

_SCHEMAS = {"tiny": 0.01, "sf1": 1.0, "sf10": 10.0, "sf100": 100.0,
            "sf1000": 1000.0}

TABLE_NAMES = ["region", "nation", "supplier", "customer", "part",
               "partsupp", "orders", "lineitem"]


class TpchConnector:
    name = "tpch"

    def __init__(self):
        self._cache: Dict[float, Dict[str, TableData]] = {}

    @staticmethod
    def scale_for_schema(schema: str) -> Optional[float]:
        if schema in _SCHEMAS:
            return _SCHEMAS[schema]
        m = re.fullmatch(r"sf([0-9.]+)", schema)
        if m:
            return float(m.group(1))
        return None

    def schema_names(self):
        return list(_SCHEMAS)

    def table_names(self, schema: str):
        return list(TABLE_NAMES)

    # scales at/above this persist to the on-disk cache: generation there
    # costs minutes (SF10 ~ the round-2 bench timeout) while tiny/0.01
    # regenerates in milliseconds
    DISK_CACHE_MIN_SCALE = 1.0

    def get_table(self, schema: str, table: str) -> TableData:
        scale = self.scale_for_schema(schema)
        if scale is None:
            raise KeyError(f"tpch schema {schema!r} not found")
        if table not in TABLE_NAMES:
            raise KeyError(f"tpch table {table!r} not found")
        from ..diskcache import get_or_generate
        return get_or_generate(
            f"tpch_sf{scale:g}", table, self._cache.setdefault(scale, {}),
            lambda: generate(scale), TableData,
            use_disk=scale >= self.DISK_CACHE_MIN_SCALE)

    def get_table_schema(self, schema: str, table: str):
        """Schema without materializing data (information_schema must not
        trigger SF1000 generation); scale-independent, so read from the
        smallest scale."""
        return self.get_table("tiny", table).schema
