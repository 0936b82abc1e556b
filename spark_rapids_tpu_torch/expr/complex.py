"""Complex-type expressions: struct, array and map access and
construction.

Counterpart of ``spark_rapids_tpu/expr/complex.py:27-221``. The layout
is Arrow's (``columnar/column.py``), so a struct field is a child
column, an array item a gather of the element column (**K4**), and a
map's keys or values its offsets over one child. Validity combines with
``and_validity``: ``None`` means every row is valid.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .. import datatypes as dt
from ..columnar.column import GpuColumnVector, and_validity
from .base import Expression

__all__ = ["GetStructField", "GetArrayItem", "CreateNamedStruct", "Size",
           "MapKeys", "MapValues"]


class GetStructField(Expression):
    """``struct.field``: the field's column, null where the struct is."""

    def __init__(self, child: Expression, name: str):
        self.children = (child,)
        self.name = name

    def _struct_type(self) -> dt.StructType:
        t = self.children[0].dtype
        if not isinstance(t, dt.StructType):
            raise TypeError(f"GetStructField over {t.simple_string()}")
        return t

    @property
    def ordinal(self) -> int:
        st = self._struct_type()
        for i, f in enumerate(st.fields):
            if f.name == self.name:
                return i
        raise KeyError(f"no field {self.name!r} in {st.simple_string()}")

    @property
    def dtype(self):
        return self._struct_type().fields[self.ordinal].dtype

    def validate(self):
        self.ordinal  # raises on a missing field or a non-struct

    def eval_gpu(self, batch, ctx):
        scol = self.children[0].eval_gpu(batch, ctx)
        return scol.children[self.ordinal].with_validity(and_validity(
            scol.children[self.ordinal].validity, scol.validity))

    def __repr__(self):
        return f"{self.children[0]!r}.{self.name}"


class GetArrayItem(Expression):
    """``array[index]``, 0-based; an index out of range, a null array or
    a null index give null (Spark outside ANSI mode)."""

    def __init__(self, child: Expression, index: Expression):
        self.children = (child, index)

    @property
    def dtype(self):
        t = self.children[0].dtype
        if not isinstance(t, dt.ArrayType):
            raise TypeError(f"GetArrayItem over {t.simple_string()}")
        return t.element_type

    def validate(self):
        self.dtype
        if not dt.is_integral(self.children[1].dtype):
            raise TypeError("array index must be integral")

    def eval_gpu(self, batch, ctx):
        from ..ops.gather import gather_column
        acol = self.children[0].eval_gpu(batch, ctx)
        icol = self.children[1].eval_gpu(batch, ctx)
        starts = acol.offsets[:-1]
        lens = acol.offsets[1:] - starts
        k = icol.data.to(torch.int32)
        ok = (k >= 0) & (k < lens)
        for v in (acol.validity, icol.validity):
            if v is not None:
                ok = ok & v
        elem = acol.children[0]
        if elem.capacity == 0:
            return GpuColumnVector.nulls(self.dtype, acol.capacity,
                                         acol.device)
        idx = (starts + k).clamp(0, elem.capacity - 1).to(torch.int32)
        return gather_column(elem, idx, ok)

    def __repr__(self):
        return f"{self.children[0]!r}[{self.children[1]!r}]"


class CreateNamedStruct(Expression):
    """``named_struct(n1, v1, ...)``: never null at the top level."""

    def __init__(self, names: Sequence[str], values: Sequence[Expression]):
        if len(names) != len(values):
            raise ValueError("names/values length mismatch")
        self.names = list(names)
        self.children = tuple(values)

    @property
    def dtype(self):
        return dt.StructType([dt.StructField(n, c.dtype, c.nullable)
                              for n, c in zip(self.names, self.children)])

    @property
    def nullable(self):
        return False

    def eval_gpu(self, batch, ctx):
        cols = [c.eval_gpu(batch, ctx) for c in self.children]
        return GpuColumnVector(self.dtype, None, None, children=cols)

    def __repr__(self):
        inner = ", ".join(f"{n}={c!r}"
                          for n, c in zip(self.names, self.children))
        return f"named_struct({inner})"


class Size(Expression):
    """``size(array | map)``: the element count; a null input gives null
    (the reference's, Spark's ``sizeOfNull=false``)."""

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self):
        return dt.INT32

    def validate(self):
        t = self.children[0].dtype
        if not isinstance(t, (dt.ArrayType, dt.MapType)):
            raise TypeError(f"size() over {t.simple_string()}")

    def eval_gpu(self, batch, ctx):
        col = self.children[0].eval_gpu(batch, ctx)
        lens = (col.offsets[1:] - col.offsets[:-1]).to(torch.int32)
        return GpuColumnVector(dt.INT32, lens, col.validity)


class _MapProject(Expression):
    """``map_keys`` / ``map_values``: the map's offsets over one of its
    children."""

    child_index = 0

    def __init__(self, child: Expression):
        self.children = (child,)

    def _map_type(self) -> dt.MapType:
        t = self.children[0].dtype
        if not isinstance(t, dt.MapType):
            raise TypeError(f"{self.pretty_name()} over "
                            f"{t.simple_string()}")
        return t

    @property
    def dtype(self):
        mt = self._map_type()
        return dt.ArrayType(mt.key_type if self.child_index == 0
                            else mt.value_type)

    def validate(self):
        self._map_type()

    def eval_gpu(self, batch, ctx):
        col = self.children[0].eval_gpu(batch, ctx)
        return GpuColumnVector(self.dtype, None, col.validity, col.offsets,
                               children=[col.children[self.child_index]])


class MapKeys(_MapProject):
    child_index = 0


class MapValues(_MapProject):
    child_index = 1
