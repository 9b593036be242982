"""Port copy of ``trino_tpu/connectors/diskcache.py`` (no edits beyond import
targets noted inline).

On-disk cache for generated connector tables.

Reference analog: the benchto methodology benchmarks Trino over
pre-generated ORC/Parquet data on disk (testing/trino-benchto-benchmarks),
not over in-process generation — datagen cost is paid once per dataset,
not once per run.  Here a generated TableData is persisted as one .npy per
column plus a JSON sidecar (schema, dictionaries, primary key); loads are
np.load(mmap_mode='r'), so a bench restart reads pages lazily from the OS
cache instead of re-running minutes of dbgen formulas.

Layout: {root}/{dataset}/{table}/meta.json + col{i}.npy + valid{i}.npy.
Default root: $TRINO_TPU_DATA_CACHE or <repo>/.datacache (gitignored).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

import numpy as np


def cache_root() -> str:
    env = os.environ.get("TRINO_TPU_DATA_CACHE")
    if env:
        return env
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, ".datacache")


def _type_to_json(dt) -> dict:
    out = {"kind": dt.kind.value}
    if dt.precision is not None:
        out["precision"] = dt.precision
    if dt.scale is not None:
        out["scale"] = dt.scale
    if dt.element is not None:
        out["element"] = _type_to_json(dt.element)
    return out


def _type_from_json(d):
    from ..types import DataType, TypeKind
    return DataType(TypeKind(d["kind"]), d.get("precision"),
                    d.get("scale"),
                    _type_from_json(d["element"]) if "element" in d
                    else None)


def save_table(dataset: str, table) -> None:
    """Persist one TableData. Atomic per table (tmp dir + rename) so a
    killed bench never leaves a half-written table behind."""
    from ..batch import Field  # noqa: F401 — layout documented above
    root = os.path.join(cache_root(), dataset)
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, table.name)
    if os.path.isdir(final):
        return
    tmp = tempfile.mkdtemp(dir=root, prefix=f".{table.name}.")
    try:
        meta = {
            "name": table.name,
            "primary_key": list(table.primary_key),
            "fields": [{"name": f.name, "dtype": _type_to_json(f.dtype),
                        "dictionary": list(f.dictionary)
                        if f.dictionary is not None else None}
                       for f in table.schema.fields],
            "valids": [v is not None for v in table.valids]
            if table.valids is not None else None,
        }
        for i, col in enumerate(table.columns):
            np.save(os.path.join(tmp, f"col{i}.npy"),
                    np.ascontiguousarray(col))
        if table.valids is not None:
            for i, v in enumerate(table.valids):
                if v is not None:
                    np.save(os.path.join(tmp, f"valid{i}.npy"),
                            np.ascontiguousarray(v))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        os.rename(tmp, final)
    except OSError:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


def get_or_generate(dataset: str, table: str, mem_cache: dict,
                    generate_fn, table_cls, use_disk: bool):
    """Connector-side cache protocol shared by tpch/tpcds: in-memory dict
    first, then disk, then whole-schema generation (persisting every
    generated table when use_disk)."""
    if table not in mem_cache:
        if use_disk:
            t = load_table(dataset, table, table_cls)
            if t is not None:
                mem_cache[table] = t
                return t
        generated = generate_fn()
        if use_disk:
            for t in generated.values():
                save_table(dataset, t)
        mem_cache.update(generated)
    return mem_cache[table]


def load_table(dataset: str, name: str, table_cls) -> Optional[object]:
    """Load one table back as `table_cls` (TableData-shaped), or None."""
    from ..batch import Field, Schema
    d = os.path.join(cache_root(), dataset, name)
    meta_path = os.path.join(d, "meta.json")
    if not os.path.isfile(meta_path):
        return None
    with open(meta_path) as f:
        meta = json.load(f)
    fields = tuple(
        Field(fm["name"], _type_from_json(fm["dtype"]),
              tuple(fm["dictionary"]) if fm["dictionary"] is not None
              else None)
        for fm in meta["fields"])
    columns = [np.load(os.path.join(d, f"col{i}.npy"), mmap_mode="r")
               for i in range(len(fields))]
    valids = None
    if meta["valids"] is not None:
        valids = [np.load(os.path.join(d, f"valid{i}.npy"), mmap_mode="r")
                  if has else None
                  for i, has in enumerate(meta["valids"])]
    return table_cls(meta["name"], Schema(fields), columns,
                     primary_key=tuple(meta["primary_key"]), valids=valids)
