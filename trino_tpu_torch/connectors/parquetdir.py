"""Port copy of ``trino_tpu/connectors/parquetdir.py`` (unchanged).

Parquet file connector.

Reference role: the parquet storage tier (lib/trino-parquet
reader/ParquetReader.java:103 feeding the hive-style connectors). A root
directory holds schemas as subdirectories and tables as `<name>.parquet`
files; columns map onto the engine's types:

- INT64 -> BIGINT, INT32 -> INTEGER, DOUBLE -> DOUBLE, BOOLEAN -> BOOLEAN
- BYTE_ARRAY (UTF8) -> VARCHAR, dictionary-encoded at load (strings never
  reach the device — the ingest policy shared with every connector)

`export_table` writes engine tables back out (TableWriter + the parquet
writer), which is also how round-trip tests and benchmark datasets are
produced in an environment with no external parquet tooling.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..batch import Field, Schema
from ..formats.parquet import read_parquet_file, write_parquet
from ..types import BIGINT, BOOLEAN, DOUBLE, INTEGER, TypeKind, VARCHAR
from .dirtable import StagedWriteMixin
from .tpch.datagen import TableData


def _pool_encode(values, mask, key=None):
    """Shared dictionary-building: sorted unique valid values -> (int32
    codes, pool tuple). Used by the varchar and array branches."""
    pool = sorted({v for v, m in zip(values, mask) if m}, key=key)
    index = {v: i for i, v in enumerate(pool)}
    codes = np.fromiter((index.get(v, 0) for v in values),
                        dtype=np.int32, count=len(values))
    return codes, tuple(pool)


def load_parquet(path: str, name: str,
                 predicates: Optional[dict] = None) -> TableData:
    """Decode a parquet file into engine TableData. `predicates`
    (column name -> (lo, hi) physical bounds) skips row groups whose
    chunk statistics prove no match; the result then holds only the
    surviving groups' rows and records skipped/total row groups."""
    from ..types import DATE, decimal
    f = read_parquet_file(path, predicates)
    names, columns, valids, logicals = \
        f.names, f.columns, f.valids, f.logicals
    fields: List[Field] = []
    arrays: List[np.ndarray] = []
    out_valids: List[Optional[np.ndarray]] = []
    for cname, col, valid, logical in zip(names, columns, valids,
                                          logicals):
        if logical is not None and logical[0] == "list":
            # LIST leaves arrive as object arrays of per-row tuples;
            # arrays follow the engine's pool-id discipline
            from ..types import array_of
            mask = valid if valid is not None else \
                np.ones(len(col), dtype=np.bool_)

            def norm(t):
                if t is None:
                    return ()
                return tuple(None if x is None else
                             float(x) if isinstance(x, (float, np.floating))
                             else int(x) for x in t)
            normed = [norm(t) for t in col]
            elem_t = DOUBLE if any(
                isinstance(x, float) for t in normed for x in t) else BIGINT
            codes, pool = _pool_encode(
                normed, mask,
                key=lambda t: (len(t), tuple((x is None, x or 0)
                                             for x in t)))
            arrays.append(codes)
            fields.append(Field(cname, array_of(elem_t),
                                dictionary=pool))
            out_valids.append(valid)
            continue
        if col.dtype == object:              # BYTE_ARRAY -> dict varchar
            mask = valid if valid is not None else \
                np.ones(len(col), dtype=np.bool_)
            codes, pool = _pool_encode(col, mask)
            arrays.append(codes)
            fields.append(Field(cname, VARCHAR, dictionary=pool))
        elif logical is not None and logical[0] == "decimal":
            arrays.append(np.asarray(col, dtype=np.int64))
            fields.append(Field(cname, decimal(logical[1], logical[2])))
        elif logical is not None and logical[0] == "date":
            arrays.append(np.asarray(col, dtype=np.int32))
            fields.append(Field(cname, DATE))
        elif col.dtype == np.dtype("<i8"):
            arrays.append(np.asarray(col, dtype=np.int64))
            fields.append(Field(cname, BIGINT))
        elif col.dtype == np.dtype("<i4"):
            arrays.append(np.asarray(col, dtype=np.int32))
            fields.append(Field(cname, INTEGER))
        elif col.dtype == np.dtype("<f8"):
            arrays.append(np.asarray(col, dtype=np.float64))
            fields.append(Field(cname, DOUBLE))
        elif col.dtype == np.bool_:
            arrays.append(np.asarray(col))
            fields.append(Field(cname, BOOLEAN))
        else:
            raise ValueError(f"{name}.{cname}: unsupported parquet dtype "
                             f"{col.dtype}")
        out_valids.append(valid)
    if all(v is None for v in out_valids):
        out_valids = None
    data = TableData(name, Schema(tuple(fields)), arrays,
                     valids=out_valids)
    data.skipped_row_groups = f.skipped_row_groups
    data.total_row_groups = f.total_row_groups
    return data


def flatten_table(data: TableData, fmt: str):
    """Engine TableData -> (names, arrays, valids, logicals) for a
    columnar file writer: dictionary codes decode back to strings;
    DECIMAL/DATE carry logical annotations so a round trip reconstructs
    the exact engine types. Shared by the parquet and ORC exporters."""
    names, arrays, valids, logicals = [], [], [], []
    for i, f in enumerate(data.schema):
        names.append(f.name)
        col = np.asarray(data.columns[i])
        valid = None if data.valids is None else data.valids[i]
        logical = None
        if f.dtype.kind is TypeKind.ARRAY:
            # the flat writers cannot represent repeated leaves; silent
            # code-column output would corrupt a round trip
            raise ValueError(
                f"{data.name}.{f.name}: ARRAY columns cannot be "
                f"exported to {fmt} yet")
        if f.dtype.kind is TypeKind.VARCHAR:
            pool = np.array(f.dictionary, dtype=object)
            col = pool[col]
        elif f.dtype.kind is TypeKind.DECIMAL:
            col = col.astype(np.int64)
            logical = ("decimal", f.dtype.precision, f.dtype.scale)
        elif f.dtype.kind is TypeKind.DATE:
            col = col.astype(np.int32)
            logical = ("date",)
        arrays.append(col)
        valids.append(None if valid is None else np.asarray(valid))
        logicals.append(logical)
    return names, arrays, valids, logicals


def export_table(data: TableData, path: str) -> None:
    """Engine TableData -> parquet file."""
    write_parquet(path, *flatten_table(data, "parquet"))


class ParquetConnector(StagedWriteMixin):
    name = "parquet"
    ext = "parquet"
    fmt = "parquet"

    def __init__(self, root: str):
        self.root = root
        self._cache: Dict[Tuple[str, str], TableData] = {}
        # unclean-shutdown recovery: roll forward / sweep any staged
        # write state before the first scan can observe it
        self.sweep_on_startup()

    @staticmethod
    def _load(path: str, name: str,
              predicates: Optional[dict] = None) -> TableData:
        return load_parquet(path, name, predicates)

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
        """Predicate-pruned decode: row groups whose chunk statistics
        cannot match `ranges` are never decompressed or decoded. The
        result is NOT cached as the table (its row set is
        predicate-specific); callers own caching under a
        predicate-aware key."""
        return self._load_table(schema, table, predicates=ranges)
