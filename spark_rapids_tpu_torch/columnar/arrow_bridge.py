"""Host <-> device columnar interchange over Arrow.

Counterpart of ``spark_rapids_tpu/columnar/arrow_bridge.py:25-180,268-296``:
pyarrow RecordBatches are the host currency, torch tensors the device
currency. Fixed-width types (bool, int8-int64, float32/64, date,
timestamp) and strings/binary (Arrow's int32 offsets and bytes), with
nulls, and ``NullType`` (an all-null column both ways, as the
reference's ``:120,231``). A ``decimal128`` of precision <= 18 rides its
int64 lane, the low word of Arrow's 16 bytes (``:52-58``), and comes
back with the high word the low word's sign (``expr/base.py:323-336``);
a wider one is two int64 words a row on the host and is never uploaded
(``column.lane_shape`` raises for a device). Nested types follow the
reference's ``:100-153,183-235``: a struct uploads its children at its
own capacity, an array or map its offsets (rebased to 0) and the
element window they cover, at a capacity of its own
(``column_to_device``); the download walks the same layout back, a map
as ``pa.map_`` and not as a list of structs (``column_to_arrow``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from .. import datatypes as dt
from .batch import GpuBatch, bucket_bytes, bucket_rows
from .column import GpuColumnVector, is_list_type, is_string_like, \
    lane_shape, torch_dtype

__all__ = ["arrow_to_device", "device_to_arrow", "arrow_schema",
           "engine_schema", "host_lanes", "column_from_host",
           "string_parts", "string_column_from_host", "decimal_words",
           "decimal_array", "column_to_device", "column_to_arrow"]


def engine_schema(arrow_schema: pa.Schema) -> dt.Schema:
    return dt.Schema([dt.StructField(f.name, dt.from_arrow(f.type),
                                     f.nullable) for f in arrow_schema])


def arrow_schema(schema: dt.Schema) -> pa.Schema:
    return pa.schema([pa.field(f.name, dt.to_arrow(f.dtype), f.nullable)
                      for f in schema])


def decimal_words(arr) -> np.ndarray:
    """A decimal array's Arrow words as int64 ``(n, 2)``, low then high,
    nulls zero."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if not pa.types.is_decimal128(arr.type):
        arr = arr.cast(pa.decimal128(arr.type.precision, arr.type.scale))
    if arr.null_count:
        arr = pc.fill_null(arr, pa.scalar(0, type=arr.type))
    n = len(arr)
    words = np.frombuffer(arr.buffers()[1], np.int64,
                          count=2 * (arr.offset + n))
    return words.reshape(-1, 2)[arr.offset:]


def decimal_array(t: dt.DecimalType, words: np.ndarray,
                  valid: Optional[np.ndarray]) -> pa.Array:
    """A ``decimal128`` array from int64 lanes: ``(n,)`` unscaled values
    (the high word the sign) or ``(n, 2)`` words."""
    n = words.shape[0]
    if words.ndim == 1:
        pairs = np.empty((n, 2), np.int64)
        pairs[:, 0] = words
        pairs[:, 1] = words >> 63
    else:
        pairs = np.ascontiguousarray(words, dtype=np.int64)
    bitmap, nulls = None, 0
    if valid is not None and not valid.all():
        bitmap = pa.py_buffer(np.packbits(valid, bitorder="little"))
        nulls = int(n - valid.sum())
    return pa.Array.from_buffers(dt.to_arrow(t), n,
                                 [bitmap, pa.py_buffer(pairs)],
                                 null_count=nulls)


def host_lanes(arr, t: dt.DataType) \
        -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(values in the lane dtype with nulls zero-filled, bool validity or
    None when the array has no nulls). The Arrow validity bitmap is
    unpacked to one bool per row here, on the host. A ``NullType``
    column is zeros, every row null."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if isinstance(t, dt.NullType):
        return np.zeros(len(arr), t.np_dtype), np.zeros(len(arr), np.bool_)
    valid = None
    if arr.null_count:
        valid = pc.is_valid(arr).to_numpy(zero_copy_only=False)
    if isinstance(t, dt.DecimalType):
        words = decimal_words(arr)
        return (words if dt.is_wide_decimal(t)
                else np.ascontiguousarray(words[:, 0])), valid
    torch_dtype(t)  # raises for types the device does not hold yet
    atype = arr.type
    if pa.types.is_boolean(atype):
        return pc.fill_null(arr, False).to_numpy(zero_copy_only=False), valid
    if pa.types.is_date32(atype):
        arr = arr.view(pa.int32())
    elif pa.types.is_timestamp(atype):
        if atype.unit != "us":
            arr = arr.cast(pa.timestamp("us", tz=atype.tz))
        arr = arr.view(pa.int64())
    if arr.null_count:
        arr = pc.fill_null(arr, pa.scalar(0, type=arr.type))
    values = arr.to_numpy(zero_copy_only=False).astype(t.np_dtype,
                                                       copy=False)
    return values, valid


def string_parts(arr) -> Tuple[np.ndarray, np.ndarray,
                                Optional[np.ndarray]]:
    """``(offsets int32 (n + 1,) from 0, chars uint8, bool validity or
    None)`` of a host string or binary array: its Arrow buffers, rebased
    when the array is a slice."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if pa.types.is_large_string(arr.type) or pa.types.is_large_binary(
            arr.type):
        arr = arr.cast(pa.binary() if pa.types.is_large_binary(arr.type)
                       else pa.string())
    n = len(arr)
    bufs = arr.buffers()
    offs = np.frombuffer(bufs[1], dtype=np.int32,
                         count=arr.offset + n + 1)[arr.offset:]
    base, end = int(offs[0]), int(offs[-1])
    chars = np.frombuffer(bufs[2], dtype=np.uint8)[base:end] \
        if bufs[2] is not None else np.zeros(0, np.uint8)
    valid = None
    if arr.null_count:
        valid = pc.is_valid(arr).to_numpy(zero_copy_only=False)
    return (offs - base).astype(np.int32), chars, valid


def string_column_from_host(t: dt.DataType, arr, capacity: int,
                            device: torch.device) -> GpuColumnVector:
    """A device string column from a host string array."""
    offs, chars, valid = string_parts(arr)
    return GpuColumnVector.from_string_parts(
        t, offs, chars, valid, capacity, bucket_bytes(len(chars)), device)


def column_from_host(t: dt.DataType, values: np.ndarray,
                     valid: Optional[np.ndarray], capacity: int,
                     device: torch.device) -> GpuColumnVector:
    """Pad host lanes to ``capacity`` and copy them to ``device``."""
    n = len(values)
    shape, _ = lane_shape(t, capacity, device)
    buf = np.zeros(shape, dtype=np.int64 if len(shape) == 2
                   else t.np_dtype)
    buf[:n] = values
    data = torch.from_numpy(buf).to(device)
    validity = None
    if valid is not None:
        vbuf = np.zeros(capacity, dtype=np.bool_)
        vbuf[:n] = valid
        validity = torch.from_numpy(vbuf).to(device)
    return GpuColumnVector(t, data, validity)


def _validity_to_device(arr: pa.Array, capacity: int,
                        device: torch.device) -> Optional[torch.Tensor]:
    if not arr.null_count:
        return None
    vbuf = np.zeros(capacity, dtype=np.bool_)
    vbuf[:len(arr)] = pc.is_valid(arr).to_numpy(zero_copy_only=False)
    return torch.from_numpy(vbuf).to(device)


def column_to_device(arr, t: dt.DataType, capacity: int,
                     device: torch.device) -> GpuColumnVector:
    """One host array as a device column of ``capacity`` rows, nested
    types recursively (module docstring)."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if isinstance(t, dt.NullType):
        return GpuColumnVector.nulls(t, capacity, device)
    if is_string_like(t):
        return string_column_from_host(t, arr, capacity, device)
    if isinstance(t, dt.StructType):
        return GpuColumnVector(
            t, None, _validity_to_device(arr, capacity, device),
            children=[column_to_device(arr.field(i), f.dtype, capacity,
                                       device)
                      for i, f in enumerate(t.fields)])
    if is_list_type(t):
        if pa.types.is_large_list(arr.type):
            arr = arr.cast(pa.list_(arr.type.value_type))
        n = len(arr)
        offs = arr.offsets.to_numpy().astype(np.int64)
        start, end = (int(offs[0]), int(offs[-1])) if n else (0, 0)
        obuf = np.empty(capacity + 1, dtype=np.int32)
        obuf[:n + 1] = offs - start
        obuf[n + 1:] = end - start
        ecap = bucket_rows(end - start)
        if isinstance(t, dt.MapType):
            parts = [(arr.keys, t.key_type), (arr.items, t.value_type)]
        else:
            parts = [(arr.values, t.element_type)]
        return GpuColumnVector(
            t, None, _validity_to_device(arr, capacity, device),
            torch.from_numpy(obuf).to(device),
            children=[column_to_device(a.slice(start, end - start), et,
                                       ecap, device) for a, et in parts])
    values, valid = host_lanes(arr, t)
    return column_from_host(t, values, valid, capacity, device)


def arrow_to_device(rb: pa.RecordBatch, schema: Optional[dt.Schema],
                    device: torch.device) -> GpuBatch:
    """Copy a host RecordBatch into a padded device batch."""
    if schema is None:
        schema = engine_schema(rb.schema)
    cap = bucket_rows(rb.num_rows)
    cols = [column_to_device(rb.column(i), schema[i].dtype, cap, device)
            for i in range(rb.num_columns)]
    return GpuBatch(cols, schema, rb.num_rows)


def _column_to_arrow(t: dt.DataType, values: np.ndarray,
                     valid: Optional[np.ndarray]) -> pa.Array:
    if isinstance(t, dt.DecimalType):
        return decimal_array(t, values, valid)
    mask = None if valid is None or valid.all() else ~valid
    if isinstance(t, dt.DateType):
        return pa.array(values, pa.int32(), mask=mask).view(pa.date32())
    if isinstance(t, dt.TimestampType):
        return pa.array(values, pa.int64(), mask=mask).view(dt.to_arrow(t))
    return pa.array(values, dt.to_arrow(t), mask=mask)


def _string_to_arrow(t: dt.DataType, c: GpuColumnVector, n: int,
                     keep: Optional[np.ndarray]) -> pa.Array:
    offs = c.offsets[:n + 1].cpu().numpy()
    base, end = (int(offs[0]), int(offs[-1])) if n else (0, 0)
    chars = c.chars[base:end].cpu().numpy()
    offs = (offs - base).astype(np.int32)
    valid = None if c.validity is None else c.validity[:n].cpu().numpy()
    bitmap = None
    nulls = 0
    if valid is not None and not valid.all():
        bitmap = pa.py_buffer(np.packbits(valid, bitorder="little"))
        nulls = int(n - valid.sum())
    atype = dt.to_arrow(t)
    arr = pa.Array.from_buffers(atype, n, [bitmap, pa.py_buffer(offs),
                                           pa.py_buffer(chars)],
                                null_count=nulls)
    return arr if keep is None else arr.filter(pa.array(keep))


def _bitmap(valid: Optional[np.ndarray], n: int):
    """``(Arrow validity buffer or None, null count)``."""
    if valid is None or valid.all():
        return None, 0
    return (pa.py_buffer(np.packbits(valid, bitorder="little")),
            int(n - valid.sum()))


def column_to_arrow(c: GpuColumnVector, lo: int, n: int) -> pa.Array:
    """Rows ``[lo, lo + n)`` of a device column as an Arrow array,
    nested types recursively: an array's element window is the span its
    offsets cover (the offsets may be absolute, ``column.slice_rows``)."""
    t = c.dtype
    if isinstance(t, dt.NullType):
        return pa.nulls(n)
    valid = None if c.validity is None else \
        c.validity[lo:lo + n].cpu().numpy()
    if is_string_like(t):
        return _string_to_arrow(
            t, GpuColumnVector(t, None, None if c.validity is None
                               else c.validity[lo:], c.offsets[lo:],
                               c.chars), n, None)
    atype = dt.to_arrow(t)
    bitmap, nulls = _bitmap(valid, n)
    if isinstance(t, dt.StructType):
        kids = [column_to_arrow(ch, lo, n) for ch in c.children]
        return pa.Array.from_buffers(atype, n, [bitmap], null_count=nulls,
                                     children=kids)
    if is_list_type(t):
        offs = c.offsets[lo:lo + n + 1].cpu().numpy().astype(np.int64)
        base, end = (int(offs[0]), int(offs[-1])) if n else (0, 0)
        kids = [column_to_arrow(ch, base, end - base) for ch in c.children]
        obuf = pa.py_buffer((offs - base).astype(np.int32))
        if isinstance(t, dt.MapType):
            kids = [pa.StructArray.from_arrays(
                kids, fields=[atype.key_field, atype.item_field])]
        return pa.Array.from_buffers(atype, n, [bitmap, obuf],
                                     null_count=nulls, children=kids)
    values = c.data[lo:lo + n].cpu().numpy()
    return _column_to_arrow(t, values, valid)


def device_to_arrow(batch: GpuBatch) -> pa.RecordBatch:
    """Download the live rows of a batch, compacting a lazy selection on
    the host."""
    n = batch.row_count
    keep = None
    if batch.selection is not None:
        keep = batch.selection[:n].cpu().numpy()
    arrays = []
    for c in batch.columns:
        if isinstance(c.dtype, dt.NullType):
            arrays.append(pa.nulls(n if keep is None else int(keep.sum())))
            continue
        if c.is_string_like:
            arrays.append(_string_to_arrow(c.dtype, c, n, keep))
            continue
        if c.is_nested:
            arr = column_to_arrow(c, 0, n)
            arrays.append(arr if keep is None else
                          arr.filter(pa.array(keep)))
            continue
        values = c.data[:n].cpu().numpy()
        valid = None if c.validity is None else \
            c.validity[:n].cpu().numpy()
        if keep is not None:
            values = values[keep]
            valid = None if valid is None else valid[keep]
        arrays.append(_column_to_arrow(c.dtype, values, valid))
    return pa.RecordBatch.from_arrays(arrays,
                                      schema=arrow_schema(batch.schema))
