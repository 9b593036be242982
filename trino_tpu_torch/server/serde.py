"""Port copy of ``trino_tpu/server/serde.py`` (no edits beyond import targets
noted inline).

Data-only wire serde for plan fragments.

Reference: Trino ships plan fragments between coordinator and workers as
Jackson-serialized JSON (sql/planner/PlanFragment.java + the codec in
server/InternalCommunicationModule) — data-only: deserializing attacker
bytes can at worst build a malformed plan, never execute code.  Round-2's
pickle serde did not have that property (a crafted POST /v1/task body could
run arbitrary code in the worker); this module replaces it.

Design: every node in a plan tree is a frozen dataclass from a closed set
of modules (planner.logical, ir, batch, types, server.tasks).  The encoder
reflects over dataclass fields; the decoder instantiates ONLY classes in
the registry, via their constructors.  Leaves: JSON primitives, tuples,
numpy arrays (base64), enums from the registry.  Shared references are
encoded once and re-linked on decode ("$ref"), preserving the object
identity the executor's driver-scan substitution relies on (id(scan)).
"""

from __future__ import annotations

import base64
import dataclasses
import enum
import json
import threading
from typing import Any, Dict

import numpy as np


def _build_registry():
    from .. import ir
    from ..batch import Field, Schema
    from ..planner import logical
    from ..sql import ast_nodes
    from ..types import DataType, TypeKind

    classes: Dict[str, type] = {}
    for mod in (ir, logical, ast_nodes):
        for name in dir(mod):
            obj = getattr(mod, name)
            if isinstance(obj, type) and dataclasses.is_dataclass(obj):
                classes[obj.__name__] = obj
    for cls in (Field, Schema, DataType):
        classes[cls.__name__] = cls
    enums = {"TypeKind": TypeKind}
    return classes, enums


_registry_lock = threading.Lock()
_classes: Dict[str, type] = {}
_enums: Dict[str, type] = {}


def _registry():
    global _classes, _enums
    if not _classes:
        with _registry_lock:
            if not _classes:
                _classes, _enums = _build_registry()
    return _classes, _enums


def register(cls: type) -> type:
    """Add an out-of-module dataclass (e.g. Split) to the closed set."""
    _registry()
    _classes[cls.__name__] = cls
    return cls


class _Encoder:
    def __init__(self):
        self.memo: Dict[int, int] = {}     # id(obj) -> slot
        self.slots = []                    # slot -> encoded node

    def enc(self, obj: Any) -> Any:
        if obj is None or isinstance(obj, (bool, int, float, str)):
            return obj
        if isinstance(obj, (np.integer, np.floating, np.bool_)):
            return {"$np": obj.dtype.name, "v": obj.item()}
        if isinstance(obj, tuple):
            return {"$tup": [self.enc(x) for x in obj]}
        if isinstance(obj, list):
            return {"$list": [self.enc(x) for x in obj]}
        if isinstance(obj, frozenset):
            return {"$fset": [self.enc(x) for x in sorted(obj, key=repr)]}
        if isinstance(obj, dict):
            return {"$dict": [[self.enc(k), self.enc(v)]
                              for k, v in obj.items()]}
        if isinstance(obj, np.ndarray):
            a = np.ascontiguousarray(obj)
            return {"$nd": a.dtype.str, "shape": list(a.shape),
                    "data": base64.b64encode(a.tobytes()).decode()}
        if isinstance(obj, enum.Enum):
            return {"$enum": type(obj).__name__, "v": obj.value}
        if dataclasses.is_dataclass(obj):
            slot = self.memo.get(id(obj))
            if slot is not None:
                return {"$ref": slot}
            classes, _ = _registry()
            name = type(obj).__name__
            if classes.get(name) is not type(obj):
                raise TypeError(f"unregistered fragment class: {name}")
            slot = len(self.slots)
            self.memo[id(obj)] = slot
            self.slots.append(None)        # reserve (cycles impossible in
            fields = {}                    # frozen trees, but keep order)
            for f in dataclasses.fields(obj):
                if f.name == "lock":
                    continue
                fields[f.name] = self.enc(getattr(obj, f.name))
            self.slots[slot] = {"$dc": name, "f": fields}
            return {"$ref": slot}
        raise TypeError(f"cannot encode {type(obj).__name__} on the wire")


class _Decoder:
    def __init__(self, slots):
        self.raw = slots
        self.built = [None] * len(slots)
        self.done = [False] * len(slots)

    def dec(self, obj: Any) -> Any:
        if obj is None or isinstance(obj, (bool, int, float, str)):
            return obj
        if isinstance(obj, list):          # only produced inside markers
            return [self.dec(x) for x in obj]
        if "$np" in obj:
            return np.dtype(obj["$np"]).type(obj["v"])
        if "$tup" in obj:
            return tuple(self.dec(x) for x in obj["$tup"])
        if "$list" in obj:
            return [self.dec(x) for x in obj["$list"]]
        if "$fset" in obj:
            return frozenset(self.dec(x) for x in obj["$fset"])
        if "$dict" in obj:
            return {self.dec(k): self.dec(v) for k, v in obj["$dict"]}
        if "$nd" in obj:
            a = np.frombuffer(base64.b64decode(obj["data"]),
                              dtype=np.dtype(obj["$nd"]))
            return a.reshape(obj["shape"])
        if "$enum" in obj:
            _, enums = _registry()
            return enums[obj["$enum"]](obj["v"])
        if "$ref" in obj:
            slot = obj["$ref"]
            if not self.done[slot]:
                node = self.raw[slot]
                classes, _ = _registry()
                cls = classes.get(node["$dc"])
                if cls is None:
                    raise TypeError(
                        f"unregistered fragment class: {node['$dc']}")
                kwargs = {k: self.dec(v) for k, v in node["f"].items()}
                self.built[slot] = cls(**kwargs)
                self.done[slot] = True
            return self.built[slot]
        raise TypeError(f"bad wire object: {list(obj)[:3]}")


def dumps(obj: Any) -> str:
    e = _Encoder()
    root = e.enc(obj)
    return json.dumps({"v": 1, "slots": e.slots, "root": root})


def loads(blob: str) -> Any:
    payload = json.loads(blob)
    if payload.get("v") != 1:
        raise ValueError("unknown fragment wire version")
    return _Decoder(payload["slots"]).dec(payload["root"])
