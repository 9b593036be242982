"""Port copy of ``trino_tpu/types.py`` (no edits beyond import targets noted
inline).

Type system for trino_tpu.

Role of the reference's ``core/trino-spi`` type system (spi/type/Type.java,
82 files): a fixed set of SQL logical types with a defined physical layout.
Our physical layout is chosen for TPU/XLA rather than the JVM:

- BIGINT / INTEGER      -> int64 / int32 arrays
- DOUBLE                -> float64 (SQL double semantics: discrete
                           functions like ceil/floor must not jump on f32
                           rounding error; XLA emulates f64 on the TPU VPU
                           — acceptable since hot aggregation arithmetic is
                           scaled-int64 decimal, not double)
- BOOLEAN               -> bool arrays
- DATE                  -> int32 days since 1970-01-01 (same as Trino)
- DECIMAL(p, s)         -> int64 scaled by 10**s (Trino short decimal,
                           spi/type/DecimalType.java); sums widened per
                           ops/aggregate.py's accumulator policy
- VARCHAR               -> int32 dictionary codes into a host-side string
                           pool (Trino's DictionaryBlock generalized into
                           the storage policy, spi/block/DictionaryBlock.java)

Nullability is carried out-of-band as a per-column validity mask (Trino:
per-block null mask, spi/block/Block.java). Three-valued logic lives in
ops/project.py.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

import numpy as np


class TypeKind(enum.Enum):
    BIGINT = "bigint"
    INTEGER = "integer"
    DOUBLE = "double"
    BOOLEAN = "boolean"
    DATE = "date"
    TIMESTAMP = "timestamp"
    DECIMAL = "decimal"
    VARCHAR = "varchar"
    ARRAY = "array"


@dataclass(frozen=True)
class DataType:
    """A SQL logical type. Hashable so schemas can key jit caches."""

    kind: TypeKind
    precision: Optional[int] = None  # DECIMAL only
    scale: Optional[int] = None      # DECIMAL only
    element: Optional["DataType"] = None   # ARRAY only

    def __post_init__(self):
        if self.kind is TypeKind.DECIMAL:
            assert self.precision is not None and self.scale is not None
            # p <= 18 columns store int64 unscaled values directly;
            # 18 < p <= 38 (Int128 territory in the reference,
            # spi/type/Int128.java) arises from aggregate RESULT types —
            # sums accumulate in two int64 limbs on device and combine
            # exactly while |total| < 2^63 (raises at the type level
            # beyond 38 digits like the reference's overflow checks)
            assert self.precision <= 38, \
                "decimals beyond 38 digits unsupported"
        if self.kind is TypeKind.ARRAY:
            assert self.element is not None

    # ---- physical layout ------------------------------------------------

    @property
    def np_dtype(self) -> np.dtype:
        return {
            TypeKind.BIGINT: np.dtype(np.int64),
            TypeKind.INTEGER: np.dtype(np.int32),
            TypeKind.DOUBLE: np.dtype(np.float64),
            TypeKind.BOOLEAN: np.dtype(np.bool_),
            TypeKind.DATE: np.dtype(np.int32),
            TypeKind.TIMESTAMP: np.dtype(np.int64),   # micros since epoch
            TypeKind.DECIMAL: np.dtype(np.int64),
            TypeKind.VARCHAR: np.dtype(np.int32),  # dictionary codes
            # arrays follow the dictionary discipline: the device carries
            # int32 pool ids, element tuples live host-side in the Field
            # (offsets+flat-values device layout is the escape hatch once
            # array-heavy kernels become hot; today's consumers — UNNEST,
            # cardinality, element access — run at batch edges)
            TypeKind.ARRAY: np.dtype(np.int32),
        }[self.kind]

    @property
    def is_dictionary(self) -> bool:
        return self.kind in (TypeKind.VARCHAR, TypeKind.ARRAY)

    @property
    def is_integerlike(self) -> bool:
        return self.kind in (TypeKind.BIGINT, TypeKind.INTEGER, TypeKind.DATE,
                             TypeKind.TIMESTAMP, TypeKind.DECIMAL,
                             TypeKind.VARCHAR)

    def __repr__(self) -> str:
        if self.kind is TypeKind.DECIMAL:
            return f"decimal({self.precision},{self.scale})"
        return self.kind.value


BIGINT = DataType(TypeKind.BIGINT)
INTEGER = DataType(TypeKind.INTEGER)
DOUBLE = DataType(TypeKind.DOUBLE)
BOOLEAN = DataType(TypeKind.BOOLEAN)
DATE = DataType(TypeKind.DATE)
TIMESTAMP = DataType(TypeKind.TIMESTAMP)
VARCHAR = DataType(TypeKind.VARCHAR)


def decimal(precision: int, scale: int) -> DataType:
    return DataType(TypeKind.DECIMAL, precision, scale)


def array_of(element: DataType) -> DataType:
    return DataType(TypeKind.ARRAY, element=element)


def common_super_type(a: DataType, b: DataType) -> DataType:
    """Result type of arithmetic coercion between two types.

    Mirrors the spirit of Trino's TypeCoercion (sql/analyzer/TypeCoercion.java)
    for the subset of types we support.
    """
    if a == b:
        return a
    kinds = {a.kind, b.kind}
    if TypeKind.DOUBLE in kinds:
        return DOUBLE
    if a.kind is TypeKind.DECIMAL and b.kind is TypeKind.DECIMAL:
        scale = max(a.scale, b.scale)
        intd = max(a.precision - a.scale, b.precision - b.scale)
        return decimal(min(18, intd + scale), scale)
    if TypeKind.DECIMAL in kinds:
        d = a if a.kind is TypeKind.DECIMAL else b
        return d
    if kinds == {TypeKind.BIGINT, TypeKind.INTEGER}:
        return BIGINT
    if TypeKind.DATE in kinds and kinds & {TypeKind.BIGINT, TypeKind.INTEGER}:
        return DATE  # date +/- integer days
    if kinds == {TypeKind.TIMESTAMP, TypeKind.DATE}:
        return TIMESTAMP
    if TypeKind.TIMESTAMP in kinds and \
            kinds & {TypeKind.BIGINT, TypeKind.INTEGER}:
        return TIMESTAMP
    raise TypeError(f"no common type for {a} and {b}")
