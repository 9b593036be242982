"""Port copy of ``trino_tpu/connectors/orcdir.py`` (unchanged).

ORC file connector.

Reference role: the ORC storage tier (lib/trino-orc
reader/OrcRecordReader.java:83 feeding the hive-style connectors). A
root directory holds schemas as subdirectories and tables as
`<name>.orc` files; the type mapping mirrors the parquet connector —
strings dictionary-encode at load, DECIMAL/DATE carry their logical
annotations.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..batch import Field, Schema
from ..formats.orc import read_orc_file
from ..types import BIGINT, BOOLEAN, DOUBLE, TypeKind, VARCHAR
from .dirtable import StagedWriteMixin
from .tpch.datagen import TableData


def load_orc(path: str, name: str,
             predicates: Optional[dict] = None) -> TableData:
    """Decode an ORC file into engine TableData. `predicates` (column
    name -> (lo, hi) physical bounds) skips stripes whose statistics
    prove no match; the result then holds only surviving stripes' rows
    and records skipped_stripes/total_stripes for observability."""
    from ..types import DATE, decimal
    f = read_orc_file(path, predicates)
    names, columns, valids, logicals = \
        f.names, f.columns, f.valids, f.logicals
    fields: List[Field] = []
    arrays: List[np.ndarray] = []
    out_valids: List[Optional[np.ndarray]] = []
    for cname, col, valid, logical in zip(names, columns, valids,
                                          logicals):
        if col.dtype == object:              # STRING -> dict varchar
            mask = valid if valid is not None else \
                np.ones(len(col), dtype=np.bool_)
            pool = sorted({s for s, v in zip(col, mask) if v})
            index = {s: i for i, s in enumerate(pool)}
            codes = np.fromiter((index.get(s, 0) for s in col),
                                dtype=np.int32, count=len(col))
            arrays.append(codes)
            fields.append(Field(cname, VARCHAR, dictionary=tuple(pool)))
        elif logical is not None and logical[0] == "decimal":
            arrays.append(np.asarray(col, dtype=np.int64))
            fields.append(Field(cname, decimal(logical[1], logical[2])))
        elif logical is not None and logical[0] == "date":
            arrays.append(np.asarray(col, dtype=np.int32))
            fields.append(Field(cname, DATE))
        elif logical is not None and logical[0] == "timestamp":
            from ..types import TIMESTAMP
            arrays.append(np.asarray(col, dtype=np.int64))
            fields.append(Field(cname, TIMESTAMP))
        elif col.dtype == np.bool_:
            arrays.append(np.asarray(col))
            fields.append(Field(cname, BOOLEAN))
        elif np.issubdtype(col.dtype, np.integer):
            arrays.append(np.asarray(col, dtype=np.int64))
            fields.append(Field(cname, BIGINT))
        elif np.issubdtype(col.dtype, np.floating):
            arrays.append(np.asarray(col, dtype=np.float64))
            fields.append(Field(cname, DOUBLE))
        else:
            raise ValueError(f"{name}.{cname}: unsupported ORC dtype "
                             f"{col.dtype}")
        out_valids.append(valid)
    if all(v is None for v in out_valids):
        out_valids = None
    data = TableData(name, Schema(tuple(fields)), arrays,
                     valids=out_valids)
    data.skipped_stripes = f.skipped_stripes
    data.total_stripes = f.total_stripes
    return data


class OrcConnector(StagedWriteMixin):
    name = "orc"
    ext = "orc"
    fmt = "orc"

    def __init__(self, root: str):
        self.root = root
        self._cache: Dict[Tuple[str, str], TableData] = {}
        # unclean-shutdown recovery: roll forward / sweep any staged
        # write state before the first scan can observe it
        self.sweep_on_startup()

    @staticmethod
    def _load(path: str, name: str,
              predicates: Optional[dict] = None) -> TableData:
        return load_orc(path, name, predicates)

    def _schema_dir(self, schema: str) -> str:
        return os.path.join(self.root, schema)

    def schema_names(self):
        if not os.path.isdir(self.root):
            return []
        return sorted(d for d in os.listdir(self.root)
                      if os.path.isdir(os.path.join(self.root, d))
                      and not d.startswith("."))

    def table_names(self, schema: str):
        return self._list_tables(schema)

    def get_table(self, schema: str, table: str) -> TableData:
        key = (schema, table)
        if key not in self._cache:
            self._cache[key] = self._load_table(schema, table)
        return self._cache[key]

    def get_table_schema(self, schema: str, table: str) -> Schema:
        return self.get_table(schema, table).schema

    def get_table_pruned(self, schema: str, table: str,
                         ranges: dict) -> TableData:
        """Predicate-pruned decode: stripes whose statistics cannot
        match `ranges` are never decompressed or decoded. The result is
        NOT cached as the table (its row set is predicate-specific);
        callers own caching under a predicate-aware key."""
        return self._load_table(schema, table, predicates=ranges)


def export_table(data: TableData, path: str,
                 compression: str = "none") -> None:
    """Engine TableData -> ORC file (formats/orc.py write_orc), the
    write-parity twin of parquetdir.export_table (lib/trino-orc
    OrcWriter.java's role); flattening is shared with the parquet
    exporter. `compression` is "none" or "zlib"."""
    from ..formats.orc import write_orc
    from .parquetdir import flatten_table
    write_orc(path, *flatten_table(data, "ORC"),
              compression=compression)
