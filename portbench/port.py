"""The adapter between the benchmark's columns and the program under test.

The generators make plain torch columns (``gen/common.Table``); this
module hands host copies of them to the program as its own tables, under
one catalog of their own, and starts the program's coordinator over
them. It is the only module of the benchmark, with ``run.py``'s traced
run, that imports the program (``trino_tpu_torch``).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

from .gen.common import Table


def _sql_type(name: str):
    from trino_tpu_torch.types import BIGINT, DATE, INTEGER, VARCHAR, decimal
    m = re.fullmatch(r"decimal\((\d+),(\d+)\)", name)
    if m:
        return decimal(int(m.group(1)), int(m.group(2)))
    return {"bigint": BIGINT, "integer": INTEGER, "date": DATE,
            "varchar": VARCHAR}[name]


def program_table(t: Table, host: Dict[str, np.ndarray]):
    from trino_tpu_torch.batch import Field, Schema
    from trino_tpu_torch.connectors.tpch.datagen import TableData
    fields = tuple(Field(c, _sql_type(t.types[c]),
                         tuple(t.pools[c]) if c in t.pools else None)
                   for c in t.columns)
    return TableData(t.name, Schema(fields), [host[c] for c in t.columns],
                     tuple(k for k in t.primary_key if k in t.columns))


class Connector:
    """The generated tables under one schema, in the shape the program's
    catalog reads for plan statistics (``_cache`` by scale)."""

    def __init__(self, schema: str, tables: dict):
        self._schema = schema
        self._tables = tables
        self._cache = {schema: tables}

    def scale_for_schema(self, schema):
        return schema

    def schema_names(self):
        return [self._schema]

    def table_names(self, schema):
        return sorted(self._tables)

    def get_table(self, schema, table):
        if schema != self._schema or table not in self._tables:
            raise KeyError(f"table {schema}.{table} not found")
        return self._tables[table]


def start(config: dict, tables: Dict[str, Table],
          host: Dict[str, Dict[str, np.ndarray]], device):
    """The program's Session over the tables, at its defaults, and its
    coordinator on 127.0.0.1 with no workers. Returns (session, server)."""
    from trino_tpu_torch.catalog import Catalog
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.server.coordinator import CoordinatorServer
    schema = config["schema"]
    conn = Connector(schema, {name: program_table(t, host[name])
                              for name, t in tables.items()})
    cat = Catalog()
    cat.register(config["catalog"], conn)
    session = Session(catalog=cat, default_cat=config["catalog"],
                      default_schema=schema, device=device)
    server = CoordinatorServer(session, port=0).start()
    return session, server
