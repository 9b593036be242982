"""Port copy of ``trino_tpu/connectors/memory.py`` (unchanged; `_note_zones`
reaches this package's ``exec/zonemap.note_table``).

In-memory connector (reference: plugin/trino-memory, MemoryMetadata/
MemoryPagesStore) — tables created via CREATE TABLE / CTAS / INSERT or
programmatically, held as host numpy columns."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..batch import Field, Schema
from ..types import TypeKind
from .tpch.datagen import TableData


def _remap_codes(target_field: Field, src_field: Optional[Field],
                 codes: np.ndarray):
    """Translate VARCHAR codes from `src_field`'s pool into
    `target_field`'s, extending the target pool with unseen strings while
    KEEPING THE POOL SORTED — the engine-wide invariant that code order ==
    string order (varchar range compares, ORDER BY, min/max all rely on
    it), so unseen strings INSERT at their sorted position rather than
    append. That can renumber existing codes, so the remap for the
    STORED column's codes is returned too.

    Returns (remapped incoming codes, remap array for existing stored
    codes or None if their numbering is unchanged, updated Field)."""
    old_pool = tuple(target_field.dictionary or ())
    src_pool = tuple(src_field.dictionary or ()) if src_field else ()
    merged = tuple(sorted(set(old_pool) | set(src_pool)))
    index = {s: j for j, s in enumerate(merged)}
    src_remap = np.array([index[s] for s in src_pool] or [0],
                         dtype=np.int32)
    old_remap = None
    if merged != old_pool and old_pool:
        old_remap = np.array([index[s] for s in old_pool],
                             dtype=np.int32)
    new_codes = src_remap[np.clip(np.asarray(codes, dtype=np.int32),
                                  0, len(src_remap) - 1)]
    return new_codes, old_remap, Field(
        target_field.name, target_field.dtype, dictionary=merged)


def _apply_old_remap(old_codes: np.ndarray,
                     old_remap: Optional[np.ndarray]) -> np.ndarray:
    if old_remap is None or len(old_codes) == 0:
        return old_codes
    return old_remap[np.clip(np.asarray(old_codes, dtype=np.int32),
                             0, len(old_remap) - 1)]


class MemoryConnector:
    name = "memory"

    def __init__(self):
        self._tables: Dict[Tuple[str, str], TableData] = {}

    @staticmethod
    def _note_zones(data: TableData) -> None:
        """Eager insert-time zone maps (scans of file/generator tables
        build theirs lazily). Every mutation stores a NEW TableData, so
        noting it here also retires the previous version's zones."""
        try:
            from ..exec.zonemap import note_table
            note_table(data)
        except Exception:   # noqa: BLE001 — pruning is advisory only
            pass

    def schema_names(self):
        return sorted({s for (s, _) in self._tables}) or ["default"]

    def table_names(self, schema: str):
        return sorted(t for (s, t) in self._tables if s == schema)

    def create_table(self, schema: str, name: str, data: TableData,
                     if_not_exists: bool = False) -> None:
        key = (schema, name)
        if key in self._tables:
            if if_not_exists:
                return
            raise KeyError(f"table {schema}.{name} already exists")
        self._tables[key] = data
        self._note_zones(data)

    def drop_table(self, schema: str, name: str,
                   if_exists: bool = False) -> None:
        key = (schema, name)
        if key not in self._tables:
            if if_exists:
                return
            raise KeyError(f"memory table {schema}.{name} not found")
        del self._tables[key]

    def insert(self, schema: str, name: str, arrays: List[np.ndarray],
               valids: List[Optional[np.ndarray]],
               fields: List[Field]) -> int:
        """Append rows (ConnectorPageSink.appendPage's role). VARCHAR
        columns arrive as codes + their pool in `fields`; they are remapped
        into the stored table's pool, extending it with unseen strings."""
        key = (schema, name)
        if key not in self._tables:
            raise KeyError(f"memory table {schema}.{name} not found")
        t = self._tables[key]
        if len(arrays) != len(t.schema.fields):
            raise ValueError(
                f"INSERT has {len(arrays)} columns, table has "
                f"{len(t.schema.fields)}")
        new_cols = []
        new_fields = []
        new_valids = []
        for i, (tf, nf) in enumerate(zip(t.schema.fields, fields)):
            old = np.asarray(t.columns[i])
            add = np.asarray(arrays[i])
            fld = tf
            if tf.dtype.kind is TypeKind.VARCHAR:
                add, old_remap, fld = _remap_codes(tf, nf, add)
                old = _apply_old_remap(old, old_remap)
            elif add.dtype != old.dtype:
                add = add.astype(old.dtype)
            new_cols.append(np.concatenate([old, add]))
            new_fields.append(fld)
            ov = None if t.valids is None else t.valids[i]
            if ov is None:
                ov = np.ones(len(old), dtype=np.bool_)
            nv = valids[i]
            if nv is None:
                nv = np.ones(len(add), dtype=np.bool_)
            new_valids.append(np.concatenate([np.asarray(ov),
                                              np.asarray(nv)]))
        self._tables[key] = TableData(
            t.name, Schema(tuple(new_fields)), new_cols,
            primary_key=(), valids=new_valids)
        self._note_zones(self._tables[key])
        return len(arrays[0]) if arrays else 0

    def get_table(self, schema: str, table: str) -> TableData:
        key = (schema, table)
        if key not in self._tables:
            raise KeyError(f"memory table {schema}.{table} not found")
        return self._tables[key]

    # ---- mutation (the MergeWriterOperator / row-change tier) -----------

    def delete_rows(self, schema: str, name: str,
                    ids: np.ndarray) -> int:
        """Drop rows by position (row-id + delete-mask scheme, the
        reference's row-change paradigm reduced to the in-memory case)."""
        t = self.get_table(schema, name)
        keep = np.ones(t.num_rows, dtype=np.bool_)
        keep[np.asarray(ids, dtype=np.int64)] = False
        cols = [np.asarray(c)[keep] for c in t.columns]
        valids = None
        if t.valids is not None:
            valids = [None if v is None else np.asarray(v)[keep]
                      for v in t.valids]
        self._tables[(schema, name)] = TableData(
            t.name, t.schema, cols, primary_key=(), valids=valids)
        return int((~keep).sum())

    def update_rows(self, schema: str, name: str, ids: np.ndarray,
                    updates: dict) -> int:
        """Overwrite columns at row positions. `updates` maps column name
        -> (values, valid, field); VARCHAR values arrive as codes in the
        field's pool and are remapped into (and extend) the stored
        pool."""
        t = self.get_table(schema, name)
        ids = np.asarray(ids, dtype=np.int64)
        cols = [np.asarray(c).copy() for c in t.columns]
        valids = [np.ones(t.num_rows, dtype=np.bool_)
                  if t.valids is None or t.valids[i] is None
                  else np.asarray(t.valids[i]).copy()
                  for i in range(len(cols))]
        fields = list(t.schema.fields)
        for col_name, (vals, valid, src_field) in updates.items():
            i = t.schema.index_of(col_name)
            tf = fields[i]
            vals = np.asarray(vals)
            if tf.dtype.kind is TypeKind.VARCHAR:
                vals, old_remap, fields[i] = _remap_codes(tf, src_field,
                                                          vals)
                cols[i] = _apply_old_remap(cols[i], old_remap)
            else:
                vals = vals.astype(cols[i].dtype)
            cols[i][ids] = vals
            valids[i][ids] = np.ones(len(ids), dtype=np.bool_) \
                if valid is None else np.asarray(valid)
        self._tables[(schema, name)] = TableData(
            t.name, Schema(tuple(fields)), cols, primary_key=(),
            valids=valids)
        return len(ids)
