"""Port copy of ``trino_tpu/connectors/tpcds/connector.py`` (no edits: its
relative imports resolve to this package's ``connectors/tpch/datagen`` and
``connectors/diskcache.py``).

TPC-DS connector.

Reference: plugin/trino-tpcds (TpcdsMetadata/TpcdsRecordSet over the
Teradata generators) — schemas tiny/sf1/... map to scale factors, tables
generated deterministically and cached per scale.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

from ..tpch.datagen import TableData
from .datagen import PRIMARY_KEYS, generate

_SCHEMAS = {"tiny": 0.01, "sf1": 1.0, "sf10": 10.0, "sf100": 100.0,
            "sf1000": 1000.0}

TABLE_NAMES = list(PRIMARY_KEYS)


class TpcdsConnector:
    name = "tpcds"

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

    DISK_CACHE_MIN_SCALE = 1.0     # see tpch/connector.py

    def get_table(self, schema: str, table: str) -> TableData:
        scale = self.scale_for_schema(schema)
        if scale is None:
            raise KeyError(f"tpcds schema {schema!r} not found")
        if table not in TABLE_NAMES:
            raise KeyError(f"tpcds table {table!r} not found")
        from ..diskcache import get_or_generate
        return get_or_generate(
            f"tpcds_sf{scale:g}", table, self._cache.setdefault(scale, {}),
            lambda: generate(scale), TableData,
            use_disk=scale >= self.DISK_CACHE_MIN_SCALE)

    def get_table_schema(self, schema: str, table: str):
        """Scale-independent schema without data generation (see tpch)."""
        return self.get_table("tiny", table).schema
