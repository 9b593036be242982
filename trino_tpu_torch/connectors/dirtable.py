"""Port copy of ``trino_tpu/connectors/dirtable.py``. One departure: a
write inside a coordinator's run of a tracked query
(`writeprotocol.coordinator_write`) commits under that query's id and
checks its fence, where the reference always mints `local_<uuid>`.

Directory-table support shared by the orcdir and parquetdir connectors.

A table is either the legacy single file `<schema>/<table>.<ext>` or a
directory `<schema>/<table>/` of published parts (`part-NNNNN-<qtok>-rN.
<ext>`) written by the exactly-once commit protocol
(server/writeprotocol.py). Reads concatenate parts in sequence order,
merging VARCHAR dictionaries into one sorted pool (the engine-wide
invariant: code order == string order). Directory listings skip dotfiles
and write-protocol artifacts (`.staging/`, `*.journal`, temp names) so a
crashed write can never surface as a phantom table or partial data.

Writes — `create_table` / `insert` / `drop_table` — run the same staged
commit protocol locally: stage one attempt file, journal the intent,
publish by rename. A crash at any point leaves either the old table or
the new one, never a prefix.
"""

import os
import uuid
from typing import List, Optional

import numpy as np

from ..batch import Field, Schema
from ..server import writeprotocol as wp
from ..types import TypeKind
from .tpch.datagen import TableData


def is_artifact(name: str) -> bool:
    """Write-protocol / temp artifacts a directory scan must skip."""
    return (name.startswith(".") or name.endswith(".journal")
            or name.endswith(".tmp"))


def concat_table_data(name: str, parts: List[TableData]) -> TableData:
    """Concatenate decoded part tables into one TableData, merging
    VARCHAR pools into a single sorted dictionary."""
    if len(parts) == 1:
        p = parts[0]
        return TableData(name, p.schema, p.columns, valids=p.valids)
    base = parts[0].schema
    for p in parts[1:]:
        if tuple(f.name for f in p.schema) != tuple(f.name for f in base):
            raise ValueError(
                f"{name}: part schema mismatch "
                f"({[f.name for f in p.schema]} vs "
                f"{[f.name for f in base]})")
    fields: List[Field] = []
    columns: List[np.ndarray] = []
    valids: List[Optional[np.ndarray]] = []
    for i, f in enumerate(base):
        cols = [np.asarray(p.columns[i]) for p in parts]
        vs = [None if p.valids is None else p.valids[i] for p in parts]
        if f.dtype.kind is TypeKind.VARCHAR:
            pool = sorted({s for p in parts
                           for s in p.schema.fields[i].dictionary})
            index = {s: j for j, s in enumerate(pool)}
            remapped = []
            for p, c in zip(parts, cols):
                src = p.schema.fields[i].dictionary
                lut = np.array([index[s] for s in src] or [0],
                               dtype=np.int32)
                remapped.append(lut[c] if len(src) else
                                np.zeros(len(c), dtype=np.int32))
            columns.append(np.concatenate(remapped)
                           if remapped else np.empty(0, np.int32))
            fields.append(Field(f.name, f.dtype, dictionary=tuple(pool)))
        else:
            columns.append(np.concatenate(cols))
            fields.append(f)
        if all(v is None for v in vs):
            valids.append(None)
        else:
            valids.append(np.concatenate(
                [np.ones(len(c), dtype=np.bool_) if v is None
                 else np.asarray(v) for v, c in zip(vs, cols)]))
    if all(v is None for v in valids):
        valids = None
    return TableData(name, Schema(tuple(fields)), columns, valids=valids)


class StagedWriteMixin:
    """Write API + directory-table reads for file connectors. Hosts set
    `ext` ("orc"/"parquet"), `fmt`, and `_load(path, name, predicates)`."""

    supports_staged_writes = True

    def _table_dir(self, schema: str, table: str) -> str:
        return os.path.join(self._schema_dir(schema), table)

    def _table_file(self, schema: str, table: str) -> str:
        return os.path.join(self._schema_dir(schema),
                            f"{table}.{self.ext}")

    def _dir_parts(self, schema: str, table: str):
        return wp.list_parts(self._table_dir(schema, table))

    def table_exists(self, schema: str, table: str) -> bool:
        return (os.path.isfile(self._table_file(schema, table))
                or bool(self._dir_parts(schema, table)))

    def _list_tables(self, schema: str):
        d = self._schema_dir(schema)
        if not os.path.isdir(d):
            return []
        suffix = f".{self.ext}"
        names = set()
        for f in os.listdir(d):
            if is_artifact(f):
                continue
            p = os.path.join(d, f)
            if os.path.isfile(p) and f.endswith(suffix):
                names.add(f[:-len(suffix)])
            elif os.path.isdir(p) and wp.list_parts(p):
                names.add(f)
        return sorted(names)

    def _load_table(self, schema: str, table: str,
                    predicates: Optional[dict] = None) -> TableData:
        """Single file, directory of parts, or both (a legacy file that
        later received distributed INSERT parts), concatenated."""
        parts: List[TableData] = []
        fpath = self._table_file(schema, table)
        skipped = total = 0
        if os.path.isfile(fpath):
            parts.append(self._load(fpath, table, predicates))
        tdir = self._table_dir(schema, table)
        for pf in self._dir_parts(schema, table):
            parts.append(self._load(os.path.join(tdir, pf), table,
                                    predicates))
        if not parts:
            raise KeyError(f"{self.name} table {schema}.{table} not "
                           f"found ({fpath})")
        skipped_rg = total_rg = 0
        for p in parts:
            skipped += getattr(p, "skipped_stripes", 0)
            total += getattr(p, "total_stripes", 0)
            skipped_rg += getattr(p, "skipped_row_groups", 0)
            total_rg += getattr(p, "total_row_groups", 0)
        data = concat_table_data(table, parts)
        data.skipped_stripes = skipped
        data.total_stripes = total
        data.skipped_row_groups = skipped_rg
        data.total_row_groups = total_rg
        return data

    # ---- write API (staged commit, exactly-once even locally) --------

    def create_table(self, schema: str, name: str, data: TableData,
                     if_not_exists: bool = False) -> None:
        if self.table_exists(schema, name):
            if if_not_exists:
                return
            raise ValueError(f"table {schema}.{name} already exists")
        self._staged_write(schema, name, data)

    def insert(self, schema: str, name: str, arrays, valids,
               fields) -> int:
        existing = self.get_table(schema, name)
        merged_fields = []
        for cur, new in zip(existing.schema, fields):
            if cur.dtype.kind is not new.dtype.kind:
                raise ValueError(
                    f"insert into {schema}.{name}.{cur.name}: kind "
                    f"mismatch {cur.dtype.kind} vs {new.dtype.kind}")
            merged_fields.append(Field(cur.name, new.dtype,
                                       dictionary=new.dictionary))
        data = TableData(name, Schema(tuple(merged_fields)),
                         [np.asarray(a) for a in arrays],
                         valids=None if valids is None or
                         all(v is None for v in valids) else list(valids))
        self._staged_write(schema, name, data)
        return data.num_rows

    def drop_table(self, schema: str, name: str,
                   if_exists: bool = False) -> None:
        qid, fence = wp.current_write()
        wp.check_fence(fence, "drop", self._table_dir(schema, name), qid)
        found = False
        fpath = self._table_file(schema, name)
        if os.path.isfile(fpath):
            os.unlink(fpath)
            found = True
        tdir = self._table_dir(schema, name)
        if os.path.isdir(tdir):
            import shutil
            shutil.rmtree(tdir, ignore_errors=True)
            found = True
        if not found and not if_exists:
            raise KeyError(f"table {schema}.{name} not found")
        self._cache.pop((schema, name), None)

    def _staged_write(self, schema: str, name: str, data: TableData,
                      query_id: Optional[str] = None, injector=None):
        tdir = self._table_dir(schema, name)
        fence = None
        if query_id is None:
            query_id, fence = wp.claim_scoped_write()
        qid = query_id or f"local_{uuid.uuid4().hex[:12]}"
        wp.check_fence(fence, "stage", tdir, qid)
        os.makedirs(tdir, exist_ok=True)
        m = wp.stage_table_data(tdir, data, qid, stage=0, partition=0,
                                attempt="a0", fmt=self.fmt,
                                injector=injector)
        stats = wp.commit(tdir, qid, [m], injector=injector, fence=fence)
        self._cache.pop((schema, name), None)
        return stats

    def sweep_on_startup(self) -> dict:
        return wp.sweep_root(self.root)
