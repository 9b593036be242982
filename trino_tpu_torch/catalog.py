"""Port copy of ``trino_tpu/catalog.py`` (port_table and
catalog_from_tables added).

Catalog registry — maps catalog names to connectors.

Reference: Trino's CatalogManager / connector loading
(metadata/CatalogManager.java, server/PluginManager.java). Connectors
implement a minimal duck-typed contract for now (schema_names/table_names/
get_table returning host TableData); the split-based scan SPI for
distributed execution layers on top in planner/physical.py.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .connectors.tpcds.connector import TpcdsConnector
from .connectors.tpch.connector import TpchConnector


class Catalog:
    def __init__(self):
        self._connectors: Dict[str, object] = {}
        self._stats_cache: Dict[tuple, object] = {}
        # monotonic catalog version: bumped on every DDL/write that goes
        # through the session (CREATE/DROP/INSERT/UPDATE/DELETE/MERGE).
        # The serving layer stamps every cached plan and result page with
        # the version it observed, so a write invalidates them all
        # without enumerating which tables changed.
        self.version = 0

    def bump_version(self) -> None:
        self.version += 1
        # table contents moved: cached plan-time stats are stale too
        self._stats_cache.clear()

    def register(self, name: str, connector) -> None:
        self._connectors[name] = connector

    def connector(self, name: str):
        if name not in self._connectors:
            raise KeyError(f"catalog {name!r} not found "
                           f"(have {sorted(self._connectors)})")
        return self._connectors[name]

    def get_table(self, catalog: str, schema: str, table: str):
        if schema == "information_schema":
            return self.information_schema_table(catalog, table)
        return self.connector(catalog).get_table(schema, table)

    def get_table_stats(self, catalog: str, schema: str, table: str):
        """TableStats for an already-materialized table, else None —
        plan-time stats must never trigger SF1000 generation
        (spi/statistics ConnectorTableStatistics role, cached)."""
        key = (catalog, schema, table)
        if key in self._stats_cache:
            return self._stats_cache[key]
        try:
            conn = self.connector(catalog)
            if hasattr(conn, "scale_for_schema"):
                # generator connectors: only stats for materialized scales
                scale = conn.scale_for_schema(schema)
                data = conn._cache.get(scale, {}).get(table)
            else:
                data = conn.get_table(schema, table)
        except Exception:
            data = None
        if data is None:
            return None
        from .stats import compute_table_stats
        stats = compute_table_stats(data)
        self._stats_cache[key] = stats
        return stats

    def information_schema_table(self, catalog: str, table: str):
        """Synthesize information_schema.{schemata,tables,columns} from
        connector metadata (reference: the engine-provided
        information_schema connector, connector/informationschema/)."""
        conn = self.connector(catalog)
        if table == "schemata":
            names = list(conn.schema_names())
            return _strings_table("schemata",
                                  [("catalog_name", [catalog] * len(names)),
                                   ("schema_name", names)])
        if table == "tables":
            cats, schemas, tables = [], [], []
            for s in conn.schema_names():
                for t in conn.table_names(s):
                    cats.append(catalog)
                    schemas.append(s)
                    tables.append(t)
            return _strings_table("tables",
                                  [("table_catalog", cats),
                                   ("table_schema", schemas),
                                   ("table_name", tables)])
        if table == "columns":
            get_schema = getattr(conn, "get_table_schema",
                                 lambda s, t: conn.get_table(s, t).schema)
            schemas, tables, cols, types, positions = [], [], [], [], []
            for s in conn.schema_names():
                for t in conn.table_names(s):
                    table_schema = get_schema(s, t)
                    for i, f in enumerate(table_schema):
                        schemas.append(s)
                        tables.append(t)
                        cols.append(f.name)
                        types.append(str(f.dtype))
                        positions.append(i + 1)
            out = _strings_table("columns",
                                 [("table_schema", schemas),
                                  ("table_name", tables),
                                  ("column_name", cols),
                                  ("data_type", types)])
            import numpy as np
            from .batch import Field, Schema
            from .types import BIGINT
            return type(out)(
                "columns",
                Schema(out.schema.fields + (Field("ordinal_position",
                                                  BIGINT),)),
                out.columns + [np.asarray(positions, dtype=np.int64)])
        raise KeyError(f"information_schema table {table!r} not found")


def _strings_table(name: str, cols):
    """Build a TableData of VARCHAR columns from python string lists."""
    import numpy as np
    from .batch import Field, Schema
    from .connectors.tpch.datagen import TableData
    from .types import VARCHAR
    fields = []
    arrays = []
    for col_name, values in cols:
        pool = sorted(set(values))
        index = {s: i for i, s in enumerate(pool)}
        fields.append(Field(col_name, VARCHAR, dictionary=tuple(pool)))
        arrays.append(np.array([index[v] for v in values],
                               dtype=np.int32))
    return TableData(name, Schema(tuple(fields)), arrays)


def default_catalog() -> Catalog:
    cat = Catalog()
    cat.register("tpch", TpchConnector())
    cat.register("tpcds", TpcdsConnector())
    from .connectors.memory import MemoryConnector
    cat.register("memory", MemoryConnector())
    return cat


def _port_type(dt):
    """Rebuild a DataType (from either package) as this package's."""
    from .types import DataType, TypeKind
    return DataType(TypeKind(dt.kind.value), dt.precision, dt.scale,
                    None if dt.element is None else _port_type(dt.element))


def port_table(t):
    """A generated table (from this package's datagen or the reference
    package's) with its schema objects rebuilt as this package's; the
    host arrays are shared as they are."""
    from .batch import Field, Schema
    from .connectors.tpch.datagen import TableData
    fields = tuple(Field(f.name, _port_type(f.dtype), f.dictionary)
                   for f in t.schema.fields)
    return TableData(t.name, Schema(fields),
                     [np.asarray(c) for c in t.columns],
                     tuple(t.primary_key),
                     None if t.valids is None else list(t.valids))


def catalog_from_tables(tables, schema: str = "tiny",
                        catalog: str = "tpch") -> Catalog:
    """A catalog whose `<catalog>.<schema>` tables (catalog `tpch` or
    `tpcds`) are `tables` (name -> generated table, from either package;
    see port_table), so both engines can run on the very same data. The
    connector's other tables still generate on demand; an empty `memory`
    catalog is registered beside it, as in default_catalog."""
    from .connectors.memory import MemoryConnector
    conn = TpchConnector() if catalog == "tpch" else TpcdsConnector()
    conn._cache.setdefault(conn.scale_for_schema(schema), {}).update(
        {name: port_table(t) for name, t in tables.items()})
    cat = Catalog()
    cat.register(catalog, conn)
    cat.register("memory", MemoryConnector())
    return cat
