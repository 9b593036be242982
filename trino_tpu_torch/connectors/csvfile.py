"""Port copy of ``trino_tpu/connectors/csvfile.py`` (unchanged).

CSV file connector.

Reference role: the file-format storage connectors (lib/trino-hive-formats
text codecs + the hive connector's table mapping). Minimal file-based
connector: a root directory, schemas as subdirectories, tables as
`<name>.csv` files with a header row. Types are inferred column-wise
(BIGINT -> DOUBLE -> DATE -> VARCHAR); empty cells are NULL; VARCHAR
columns dictionary-encode at load (the engine's ingest policy — strings
never reach the device).

    catalog.register("csv", CsvConnector("/data"))
    SELECT * FROM csv.default.mytable
"""

from __future__ import annotations

import csv
import datetime
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..batch import Field, Schema
from ..types import BIGINT, DATE, DOUBLE, VARCHAR
from .tpch.datagen import TableData

EPOCH = datetime.date(1970, 1, 1)


def _infer(values: List[str]):
    """Column type from non-empty cells: BIGINT | DOUBLE | DATE | VARCHAR."""
    kinds = {"int": True, "float": True, "date": True}
    seen = False
    for v in values:
        if v == "":
            continue
        seen = True
        if kinds["int"]:
            try:
                int(v)
            except ValueError:
                kinds["int"] = False
        if not kinds["int"] and kinds["float"]:
            try:
                float(v)
            except ValueError:
                kinds["float"] = False
        if kinds["date"]:
            try:
                datetime.date.fromisoformat(v)
            except ValueError:
                kinds["date"] = False
    if not seen:
        return VARCHAR
    if kinds["int"]:
        return BIGINT
    if kinds["float"]:
        return DOUBLE
    if kinds["date"]:
        return DATE
    return VARCHAR


def load_csv(path: str, name: str) -> TableData:
    with open(path, newline="") as f:
        reader = csv.reader(f)
        rows = list(reader)
    if not rows:
        raise ValueError(f"{path}: empty CSV (need a header row)")
    header, body = rows[0], rows[1:]
    ncols = len(header)
    columns = [[r[i] if i < len(r) else "" for r in body]
               for i in range(ncols)]
    fields: List[Field] = []
    arrays: List[np.ndarray] = []
    valids: List[Optional[np.ndarray]] = []
    for cname, cells in zip(header, columns):
        dtype = _infer(cells)
        valid = np.array([c != "" for c in cells], dtype=np.bool_)
        if dtype is BIGINT:
            arrays.append(np.array([int(c) if c else 0 for c in cells],
                                   dtype=np.int64))
            fields.append(Field(cname, BIGINT))
        elif dtype is DOUBLE:
            arrays.append(np.array([float(c) if c else 0.0 for c in cells],
                                   dtype=np.float64))
            fields.append(Field(cname, DOUBLE))
        elif dtype is DATE:
            arrays.append(np.array(
                [(datetime.date.fromisoformat(c) - EPOCH).days if c else 0
                 for c in cells], dtype=np.int32))
            fields.append(Field(cname, DATE))
        else:
            pool = sorted({c for c, v in zip(cells, valid) if v})
            index = {s: i for i, s in enumerate(pool)}
            arrays.append(np.array([index.get(c, 0) for c in cells],
                                   dtype=np.int32))
            fields.append(Field(cname, VARCHAR, dictionary=tuple(pool)))
        valids.append(None if valid.all() else valid)
    if all(v is None for v in valids):
        valids = None
    return TableData(name, Schema(tuple(fields)), arrays, valids=valids)


class CsvConnector:
    name = "csv"

    def __init__(self, root: str):
        self.root = root
        self._cache: Dict[Tuple[str, str], TableData] = {}

    def _schema_dir(self, schema: str) -> str:
        return os.path.join(self.root, schema)

    def schema_names(self):
        if not os.path.isdir(self.root):
            return []
        return sorted(d for d in os.listdir(self.root)
                      if os.path.isdir(os.path.join(self.root, d)))

    def table_names(self, schema: str):
        d = self._schema_dir(schema)
        if not os.path.isdir(d):
            return []
        return sorted(f[:-4] for f in os.listdir(d) if f.endswith(".csv"))

    def get_table(self, schema: str, table: str) -> TableData:
        key = (schema, table)
        if key not in self._cache:
            path = os.path.join(self._schema_dir(schema), f"{table}.csv")
            if not os.path.isfile(path):
                raise KeyError(f"csv table {schema}.{table} not found "
                               f"({path})")
            self._cache[key] = load_csv(path, table)
        return self._cache[key]
