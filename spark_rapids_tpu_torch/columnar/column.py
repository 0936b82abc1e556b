"""Device-resident column vectors.

Counterpart of ``spark_rapids_tpu/columnar/column.py:34``
(``TpuColumnVector``): a SQL column whose buffers are torch tensors on
the engine's device.

Layout (Arrow-compatible, the same padding as the reference,
``:7-12``):
  - fixed-width types: ``data`` — shape ``(capacity,)`` of the type's
    lane dtype; rows at and past the batch ``row_count`` are padding.
  - strings and binary: ``offsets`` — int32 ``(capacity + 1,)``,
    monotone through the padding; ``chars`` — uint8
    ``(char_capacity,)``, the bytes past the last offset are padding.
    ``data`` is None.
  - ``validity`` — bool ``(capacity,)`` SQL-null mask (True = valid), or
    ``None`` when every live row is valid. The reference always carries
    the mask; leaving it out lets a column without nulls cost no mask
    bytes in a kernel that reads it.

  - a decimal of precision <= 18 (Decimal64, the reference's
    ``:24-27``): ``data`` int64 ``(capacity,)``, the unscaled values.
  - a wider decimal never gets a device layout (nor has it in the
    reference, ``columnar/arrow_bridge.py:57-58``). On the host, where
    the planner runs everything that holds one, it is ``data`` int64
    ``(capacity, 2)``: Arrow's decimal128 words, low then high
    (``wide_decimal_lanes``).

Nested types (the reference's ``:34-46``, Arrow-shaped):
  - struct: ``children``, one column a field at the struct's capacity,
    and the struct's own ``validity``; ``data`` and ``offsets`` None.
  - array: ``offsets`` int32 ``(capacity + 1,)`` into ``children[0]``,
    the element column, which has a capacity of its own; an empty or
    null row has equal offsets. The offsets may start past 0 (a view
    that shares its elements, ``slice_rows``).
  - map: the array layout with ``children = [keys, values]`` (shared
    offsets).
A string column is told from an array by its type (``is_string_like``),
never by its offsets.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import datatypes as dt
from ..datatypes import DataType

__all__ = ["GpuColumnVector", "torch_dtype", "and_validity",
           "is_string_like", "lane_shape", "is_list_type", "slice_rows"]

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(t: DataType) -> torch.dtype:
    """The torch lane dtype of a fixed-width engine type."""
    if dt.is_wide_decimal(t):
        raise NotImplementedError(
            f"{t.simple_string()}: a decimal past 18 digits has no device "
            "layout; the planner runs what holds one on the CPU")
    if t.np_dtype is None or np.dtype(t.np_dtype) not in _TORCH_DTYPES:
        raise NotImplementedError(
            f"{t.simple_string()} columns are not on the device yet")
    return _TORCH_DTYPES[np.dtype(t.np_dtype)]


def lane_shape(t: DataType, capacity: int, device: torch.device):
    """``(shape, torch dtype)`` of a fixed-width column's data: a wide
    decimal's two words a row, on the host only."""
    if dt.is_wide_decimal(t):
        if torch.device(device).type != "cpu":
            torch_dtype(t)  # raises: never on the device
        return (capacity, 2), torch.int64
    return (capacity,), torch_dtype(t)


def is_string_like(t: DataType) -> bool:
    """Strings and binary: the (offsets, chars) layout."""
    return isinstance(t, (dt.StringType, dt.BinaryType))


def is_list_type(t: DataType) -> bool:
    """Arrays and maps: the (offsets, element children) layout."""
    return isinstance(t, (dt.ArrayType, dt.MapType))


def and_validity(a: Optional[torch.Tensor],
                 b: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """AND of two validity masks where ``None`` means all valid."""
    if a is None:
        return b
    if b is None:
        return a
    return a & b


class GpuColumnVector:
    """One column: ``dtype``, ``data`` (fixed width) or ``offsets`` and
    ``chars`` (strings), ``children`` (nested types), and
    ``validity``."""

    __slots__ = ("dtype", "data", "validity", "offsets", "chars",
                 "children")

    def __init__(self, dtype: DataType, data: Optional[torch.Tensor],
                 validity: Optional[torch.Tensor] = None,
                 offsets: Optional[torch.Tensor] = None,
                 chars: Optional[torch.Tensor] = None,
                 children: Optional[List["GpuColumnVector"]] = None):
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.offsets = offsets
        self.chars = chars
        self.children = children

    @classmethod
    def nulls(cls, dtype: DataType, capacity: int,
              device: torch.device) -> "GpuColumnVector":
        valid = torch.zeros(capacity, dtype=torch.bool, device=device)
        if isinstance(dtype, dt.StructType):
            return cls(dtype, None, valid, children=[
                cls.nulls(f.dtype, capacity, device) for f in dtype.fields])
        if is_list_type(dtype):
            kids = [dtype.key_type, dtype.value_type] \
                if isinstance(dtype, dt.MapType) else [dtype.element_type]
            return cls(dtype, None, valid,
                       torch.zeros(capacity + 1, dtype=torch.int32,
                                   device=device),
                       children=[cls.nulls(k, 0, device) for k in kids])
        if is_string_like(dtype):
            return cls(dtype, None, valid,
                       torch.zeros(capacity + 1, dtype=torch.int32,
                                   device=device),
                       torch.zeros(0, dtype=torch.uint8, device=device))
        shape, lane = lane_shape(dtype, capacity, device)
        return cls(dtype, torch.zeros(shape, dtype=lane, device=device),
                   valid)

    @classmethod
    def from_string_parts(cls, dtype: DataType, offsets: np.ndarray,
                          chars: np.ndarray, validity: Optional[np.ndarray],
                          capacity: int, char_capacity: int,
                          device: torch.device) -> "GpuColumnVector":
        """A string column from host parts (``:74-89``): ``offsets``
        int32 ``(n + 1,)``, ``chars`` uint8, ``validity`` bool ``(n,)`` or
        None; padded to ``capacity`` rows and ``char_capacity`` bytes,
        the offsets held at their last value through the padding."""
        n = len(offsets) - 1
        if char_capacity < len(chars):
            raise ValueError(f"{len(chars)} chars over a capacity of "
                             f"{char_capacity}")
        obuf = np.empty(capacity + 1, dtype=np.int32)
        obuf[:n + 1] = offsets
        obuf[n + 1:] = offsets[-1] if n >= 0 else 0
        cbuf = np.zeros(char_capacity, dtype=np.uint8)
        cbuf[:len(chars)] = chars
        vt = None
        if validity is not None:
            vbuf = np.zeros(capacity, dtype=np.bool_)
            vbuf[:n] = validity
            vt = torch.from_numpy(vbuf).to(device)
        return cls(dtype, None, vt, torch.from_numpy(obuf).to(device),
                   torch.from_numpy(cbuf).to(device))

    @property
    def is_string_like(self) -> bool:
        return is_string_like(self.dtype)

    @property
    def is_nested(self) -> bool:
        return dt.is_nested(self.dtype)

    @property
    def is_list(self) -> bool:
        return is_list_type(self.dtype)

    @property
    def capacity(self) -> int:
        if self.data is not None:
            return self.data.shape[0]
        if self.offsets is not None:
            return self.offsets.shape[0] - 1
        if self.validity is not None:
            return self.validity.shape[0]
        return self.children[0].capacity  # a struct

    @property
    def device(self) -> torch.device:
        for t in (self.data, self.offsets, self.validity):
            if t is not None:
                return t.device
        return self.children[0].device

    def lengths(self) -> torch.Tensor:
        """Byte length of each string row (int32)."""
        return self.offsets[1:] - self.offsets[:-1]

    def arrays(self):
        """The tensors backing this column, pre-order through its
        children."""
        out = [a for a in (self.data, self.validity, self.offsets,
                           self.chars) if a is not None]
        for ch in self.children or ():
            out.extend(ch.arrays())
        return out

    def device_size_bytes(self) -> int:
        """Bytes the column holds on the device, chars included."""
        return sum(a.numel() * a.element_size() for a in self.arrays())

    def valid_mask(self) -> torch.Tensor:
        """The validity as a tensor (all True when it is ``None``)."""
        if self.validity is None:
            return torch.ones(self.capacity, dtype=torch.bool,
                              device=self.device)
        return self.validity

    def with_validity(self, validity: Optional[torch.Tensor]) \
            -> "GpuColumnVector":
        return GpuColumnVector(self.dtype, self.data, validity,
                               self.offsets, self.chars, self.children)

    def clone(self) -> "GpuColumnVector":
        """A copy that owns its tensors, children included."""
        def cp(t):
            return None if t is None else t.clone()
        return GpuColumnVector(
            self.dtype, cp(self.data), cp(self.validity), cp(self.offsets),
            self.chars, None if self.children is None
            else [ch.clone() for ch in self.children])

    def __repr__(self):
        return (f"GpuColumnVector({self.dtype.simple_string()}, "
                f"cap={self.capacity})")


def slice_rows(c: GpuColumnVector, lo: int, hi: int) -> GpuColumnVector:
    """Rows ``[lo, hi)`` of a column as a view: fixed-width lanes and
    validity are sliced, a string's or an array's offsets too while its
    chars or elements stay shared (the offsets are absolute), and a
    struct's children are sliced alike (the reference's ``_shrink_col``
    and split halves)."""
    v = None if c.validity is None else c.validity[lo:hi]
    if c.offsets is not None:
        return GpuColumnVector(c.dtype, None, v, c.offsets[lo:hi + 1],
                               c.chars, c.children)
    if c.children is not None:
        return GpuColumnVector(c.dtype, None, v, children=[
            slice_rows(ch, lo, hi) for ch in c.children])
    return GpuColumnVector(c.dtype, None if c.data is None
                           else c.data[lo:hi], v)
