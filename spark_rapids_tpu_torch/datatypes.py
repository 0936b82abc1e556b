"""Spark SQL data type system for the PyTorch/CUDA engine.

Counterpart of ``spark_rapids_tpu/datatypes.py:1`` (a copy: the port
imports nothing of the JAX package, so it carries its own). Each type
knows its fixed-width device lane dtype (``np_dtype``; strings, binary
and nested types are variable-width), its Arrow equivalent for the host
boundary, and its Spark-facing name.

Decimal: precision <= 18 is a scaled int64 lane (Decimal64), the
device's decimal; a wider decimal lives only on the host, as two int64
lanes (Arrow's decimal128 words, ``columnar/column.py``). The result
types of decimal arithmetic are Spark's ``DecimalPrecision`` rules
(``decimal_result_type``, beside ``common_type``), with its default
``spark.sql.decimalOperations.allowPrecisionLoss``; an integral operand
widens as Spark's ``DecimalType.forType`` (``decimal_for``), an integer
literal to the fewest digits that hold it (``DecimalType.fromLiteral``,
``literal_decimal``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "DataType", "NullType", "BooleanType", "ByteType", "ShortType",
    "IntegerType", "LongType", "FloatType", "DoubleType", "StringType",
    "BinaryType", "DateType", "TimestampType", "DecimalType", "ArrayType",
    "MapType", "StructType", "StructField", "Schema",
    "NULL", "BOOL", "INT8", "INT16", "INT32", "INT64", "FLOAT32", "FLOAT64",
    "STRING", "BINARY", "DATE", "TIMESTAMP",
    "is_numeric", "is_integral", "is_floating", "is_nested",
    "common_type", "is_wide_decimal", "decimal_for", "literal_decimal",
    "decimal_result_type", "wider_decimal", "adjust_precision_scale",
]


class DataType:
    """Base class for SQL data types."""

    #: numpy dtype of the fixed-width device representation, or None
    np_dtype: Optional[np.dtype] = None

    def simple_string(self) -> str:
        return type(self).__name__.replace("Type", "").lower()

    @property
    def is_variable_width(self) -> bool:
        return self.np_dtype is None

    def __repr__(self) -> str:
        return self.simple_string()

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))


class NullType(DataType):
    np_dtype = np.dtype(np.int8)  # placeholder lane; all rows null

    def simple_string(self):
        return "void"


class BooleanType(DataType):
    np_dtype = np.dtype(np.bool_)


class ByteType(DataType):
    np_dtype = np.dtype(np.int8)

    def simple_string(self):
        return "tinyint"


class ShortType(DataType):
    np_dtype = np.dtype(np.int16)

    def simple_string(self):
        return "smallint"


class IntegerType(DataType):
    np_dtype = np.dtype(np.int32)

    def simple_string(self):
        return "int"


class LongType(DataType):
    np_dtype = np.dtype(np.int64)

    def simple_string(self):
        return "bigint"


class FloatType(DataType):
    np_dtype = np.dtype(np.float32)


class DoubleType(DataType):
    np_dtype = np.dtype(np.float64)


class StringType(DataType):
    np_dtype = None  # (offsets:int32, bytes:uint8) pair on device


class BinaryType(DataType):
    np_dtype = None


class DateType(DataType):
    """Days since epoch, int32 on device (matches Spark/Arrow date32)."""
    np_dtype = np.dtype(np.int32)


class TimestampType(DataType):
    """Microseconds since epoch UTC, int64 on device (Spark semantics)."""
    np_dtype = np.dtype(np.int64)


@dataclasses.dataclass(frozen=True, eq=False)
class DecimalType(DataType):
    precision: int = 10
    scale: int = 0

    MAX_PRECISION = 38
    MAX_INT64_PRECISION = 18

    def __post_init__(self):
        if not (0 < self.precision <= self.MAX_PRECISION):
            raise ValueError(f"decimal precision out of range: {self.precision}")
        if not (0 <= self.scale <= self.precision):
            raise ValueError(f"decimal scale out of range: {self.scale}")

    @property
    def np_dtype(self):  # type: ignore[override]
        # Decimal64 fast path; decimal128 handled as a 2-lane column.
        if self.precision <= self.MAX_INT64_PRECISION:
            return np.dtype(np.int64)
        return None  # two int64 lanes; see columnar.column Decimal128 layout

    def simple_string(self):
        return f"decimal({self.precision},{self.scale})"

    def __eq__(self, other):
        return (isinstance(other, DecimalType)
                and other.precision == self.precision
                and other.scale == self.scale)

    def __hash__(self):
        return hash(("decimal", self.precision, self.scale))


@dataclasses.dataclass(frozen=True, eq=False)
class ArrayType(DataType):
    element_type: DataType = None  # type: ignore
    contains_null: bool = True
    np_dtype = None

    def simple_string(self):
        return f"array<{self.element_type.simple_string()}>"

    def __eq__(self, other):
        return (isinstance(other, ArrayType)
                and other.element_type == self.element_type)

    def __hash__(self):
        return hash(("array", self.element_type))


@dataclasses.dataclass(frozen=True, eq=False)
class MapType(DataType):
    key_type: DataType = None  # type: ignore
    value_type: DataType = None  # type: ignore
    value_contains_null: bool = True
    np_dtype = None

    def simple_string(self):
        return (f"map<{self.key_type.simple_string()},"
                f"{self.value_type.simple_string()}>")

    def __eq__(self, other):
        return (isinstance(other, MapType)
                and other.key_type == self.key_type
                and other.value_type == self.value_type)

    def __hash__(self):
        return hash(("map", self.key_type, self.value_type))


@dataclasses.dataclass(frozen=True)
class StructField:
    name: str
    dtype: DataType
    nullable: bool = True


@dataclasses.dataclass(frozen=True, eq=False)
class StructType(DataType):
    fields: tuple = ()
    np_dtype = None

    def __init__(self, fields):
        object.__setattr__(self, "fields", tuple(fields))

    def simple_string(self):
        inner = ",".join(f"{f.name}:{f.dtype.simple_string()}" for f in self.fields)
        return f"struct<{inner}>"

    def field_names(self):
        return [f.name for f in self.fields]

    def __eq__(self, other):
        return isinstance(other, StructType) and other.fields == self.fields

    def __hash__(self):
        return hash(("struct", self.fields))


# Schema for a batch / relation: ordered named fields.
class Schema:
    def __init__(self, fields):
        self.fields = [f if isinstance(f, StructField) else StructField(*f)
                       for f in fields]

    @property
    def names(self):
        return [f.name for f in self.fields]

    @property
    def types(self):
        return [f.dtype for f in self.fields]

    def __len__(self):
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __getitem__(self, i):
        if isinstance(i, str):
            for f in self.fields:
                if f.name == i:
                    return f
            raise KeyError(i)
        return self.fields[i]

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    def __repr__(self):
        return "Schema(" + ", ".join(
            f"{f.name}:{f.dtype.simple_string()}" for f in self.fields) + ")"

    def __eq__(self, other):
        return isinstance(other, Schema) and [
            (f.name, f.dtype) for f in self.fields] == [
            (f.name, f.dtype) for f in other.fields]


# Singletons for common types
NULL = NullType()
BOOL = BooleanType()
INT8 = ByteType()
INT16 = ShortType()
INT32 = IntegerType()
INT64 = LongType()
FLOAT32 = FloatType()
FLOAT64 = DoubleType()
STRING = StringType()
BINARY = BinaryType()
DATE = DateType()
TIMESTAMP = TimestampType()

_INTEGRAL = (ByteType, ShortType, IntegerType, LongType)
_FLOATING = (FloatType, DoubleType)


def is_integral(dt: DataType) -> bool:
    return isinstance(dt, _INTEGRAL)


def is_floating(dt: DataType) -> bool:
    return isinstance(dt, _FLOATING)


def is_numeric(dt: DataType) -> bool:
    return is_integral(dt) or is_floating(dt) or isinstance(dt, DecimalType)


def is_nested(dt: DataType) -> bool:
    return isinstance(dt, (StructType, ArrayType, MapType))


_NUMERIC_ORDER = [ByteType, ShortType, IntegerType, LongType, FloatType,
                  DoubleType]


def common_type(a: DataType, b: DataType) -> DataType:
    """Spark's implicit-cast numeric widening (simplified TypeCoercion)."""
    if a == b:
        return a
    if isinstance(a, NullType):
        return b
    if isinstance(b, NullType):
        return a
    if isinstance(a, DecimalType) or isinstance(b, DecimalType):
        if isinstance(a, DecimalType) and isinstance(b, DecimalType):
            scale = max(a.scale, b.scale)
            intd = max(a.precision - a.scale, b.precision - b.scale)
            return DecimalType(min(intd + scale, DecimalType.MAX_PRECISION), scale)
        dec = a if isinstance(a, DecimalType) else b
        other = b if isinstance(a, DecimalType) else a
        if is_integral(other):
            return common_type(dec, decimal_for(other))
        return FLOAT64
    try:
        ia = _NUMERIC_ORDER.index(type(a))
        ib = _NUMERIC_ORDER.index(type(b))
    except ValueError:
        raise TypeError(f"no common type for {a} and {b}")
    # Spark promotes (long, float) -> float -> but comparisons go to double.
    return _NUMERIC_ORDER[max(ia, ib)]()


def is_wide_decimal(t: DataType) -> bool:
    """A decimal past the device's 18 digits (host only)."""
    return isinstance(t, DecimalType) \
        and t.precision > DecimalType.MAX_INT64_PRECISION


_INTEGRAL_DIGITS = {ByteType: 3, ShortType: 5, IntegerType: 10,
                    LongType: 20}


def decimal_for(t: DataType) -> "DecimalType":
    """Spark's ``DecimalType.forType``: the decimal an integral operand
    widens to (tinyint 3, smallint 5, int 10, bigint 20 digits)."""
    if isinstance(t, DecimalType):
        return t
    return DecimalType(_INTEGRAL_DIGITS[type(t)], 0)


def literal_decimal(value: int) -> "DecimalType":
    """Spark's ``DecimalType.fromLiteral`` for an integer literal: the
    fewest digits that hold it, scale 0."""
    return DecimalType(max(len(str(abs(int(value)))), 1), 0)


def adjust_precision_scale(precision: int, scale: int) -> "DecimalType":
    """Spark's ``DecimalType.adjustPrecisionScale`` (precision loss
    allowed): past 38 digits the scale gives way, down to 6."""
    if precision <= DecimalType.MAX_PRECISION:
        return DecimalType(precision, scale)
    int_digits = precision - scale
    min_scale = min(scale, 6)
    adjusted = max(DecimalType.MAX_PRECISION - int_digits, min_scale)
    return DecimalType(DecimalType.MAX_PRECISION, adjusted)


def decimal_result_type(op: str, a: "DecimalType",
                        b: "DecimalType") -> "DecimalType":
    """Spark's ``DecimalPrecision`` result type of ``a op b``: ``add``
    and ``sub`` keep the larger scale with one more integral digit,
    ``mul`` adds precisions and scales, ``div`` keeps at least 6
    fraction digits, ``mod`` (``%`` and ``pmod``) the smaller integral
    part."""
    p1, s1, p2, s2 = a.precision, a.scale, b.precision, b.scale
    if op in ("add", "sub"):
        scale = max(s1, s2)
        return adjust_precision_scale(max(p1 - s1, p2 - s2) + scale + 1,
                                      scale)
    if op == "mul":
        return adjust_precision_scale(p1 + p2 + 1, s1 + s2)
    if op == "div":
        scale = max(6, s1 + p2 + 1)
        return adjust_precision_scale(p1 - s1 + s2 + scale, scale)
    if op == "mod":
        scale = max(s1, s2)
        return adjust_precision_scale(min(p1 - s1, p2 - s2) + scale, scale)
    raise ValueError(op)


def wider_decimal(a: "DecimalType", b: "DecimalType") -> "DecimalType":
    """Spark's ``widerDecimalType``: both integral parts and the larger
    scale (capped at 38 digits)."""
    scale = max(a.scale, b.scale)
    int_digits = max(a.precision - a.scale, b.precision - b.scale)
    return DecimalType(min(int_digits + scale, DecimalType.MAX_PRECISION),
                       min(scale, DecimalType.MAX_PRECISION))


def from_arrow(at) -> DataType:
    """Arrow DataType -> engine DataType."""
    import pyarrow as pa
    if pa.types.is_boolean(at):
        return BOOL
    if pa.types.is_int8(at):
        return INT8
    if pa.types.is_int16(at):
        return INT16
    if pa.types.is_int32(at):
        return INT32
    if pa.types.is_int64(at):
        return INT64
    if pa.types.is_float32(at):
        return FLOAT32
    if pa.types.is_float64(at):
        return FLOAT64
    if pa.types.is_string(at) or pa.types.is_large_string(at):
        return STRING
    if pa.types.is_binary(at) or pa.types.is_large_binary(at):
        return BINARY
    if pa.types.is_date32(at):
        return DATE
    if pa.types.is_timestamp(at):
        return TIMESTAMP
    if pa.types.is_decimal(at):
        return DecimalType(at.precision, at.scale)
    if pa.types.is_list(at) or pa.types.is_large_list(at):
        return ArrayType(from_arrow(at.value_type))
    if pa.types.is_map(at):
        return MapType(from_arrow(at.key_type), from_arrow(at.item_type))
    if pa.types.is_struct(at):
        return StructType([StructField(f.name, from_arrow(f.type), f.nullable)
                           for f in at])
    if pa.types.is_null(at):
        return NULL
    raise TypeError(f"unsupported arrow type {at}")


def to_arrow(dt: DataType):
    """Engine DataType -> Arrow DataType."""
    import pyarrow as pa
    mapping = {
        BooleanType: pa.bool_(), ByteType: pa.int8(), ShortType: pa.int16(),
        IntegerType: pa.int32(), LongType: pa.int64(),
        FloatType: pa.float32(), DoubleType: pa.float64(),
        StringType: pa.string(), BinaryType: pa.binary(),
        DateType: pa.date32(), TimestampType: pa.timestamp("us", tz="UTC"),
        NullType: pa.null(),
    }
    if type(dt) in mapping:
        return mapping[type(dt)]
    if isinstance(dt, DecimalType):
        return pa.decimal128(dt.precision, dt.scale)
    if isinstance(dt, ArrayType):
        return pa.list_(to_arrow(dt.element_type))
    if isinstance(dt, MapType):
        return pa.map_(to_arrow(dt.key_type), to_arrow(dt.value_type))
    if isinstance(dt, StructType):
        return pa.struct([(f.name, to_arrow(f.dtype)) for f in dt.fields])
    raise TypeError(f"unsupported type {dt}")
