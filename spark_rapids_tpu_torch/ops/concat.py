"""Device batch concatenation.

Counterpart of ``concat_batches_bounded``
(``spark_rapids_tpu/ops/concat.py:148``): the output capacity is the
bucketed sum of the input capacities, so nothing is read back to size it.
Where the reference compacts each input and gathers the live rows into a
prefix, the port copies every input whole, one after the other, and
carries the inputs' live rows as the output's lazy selection: the
consumers (the final aggregate's sort, the join's build presort) read
the live mask and put the dead rows last. No row moves, no gather runs.
A string column's chars are concatenated whole and its rows re-packed
from their shifted starts and lengths, with no readback (unless the
chars would pass an int32 offset: then each input's chars are cut to
its rows' bytes first). A nested column concatenates level by level
(the reference's unit mapping, ``:23-126``): a struct's children with
the rows, an array's or a map's elements whole, side by side, and then
its rows re-packed from their shifted starts and lengths, the elements
moved by one K4 launch (``ops/gather._gather_elements``).
"""
from __future__ import annotations

from typing import List

import torch

from ..columnar.batch import GpuBatch, bucket_rows
from ..columnar.column import GpuColumnVector
from .gather import _gather_elements
from .strings import assemble_strings, string_row_parts

__all__ = ["concat_batches_bounded", "concat_string_columns",
           "concat_columns"]


def _padded_cat(parts: List[torch.Tensor], cap: int) -> torch.Tensor:
    out = torch.cat(parts)
    if out.shape[0] == cap:
        return out
    padded = torch.zeros((cap,) + tuple(out.shape[1:]), dtype=out.dtype,
                         device=out.device)
    padded[:out.shape[0]] = out
    return padded


_MAX_CHARS = (1 << 31) - 1  # an int32 offset's reach


def _compacted(col: GpuColumnVector) -> GpuColumnVector:
    """The column with a chars buffer of exactly its rows' bytes (one
    readback of their total)."""
    starts, lengths = string_row_parts(col)
    return assemble_strings(col, starts, lengths, col.validity,
                            int(lengths.sum(dtype=torch.int64)))


def concat_string_columns(parts: List[GpuColumnVector], cap: int) \
        -> GpuColumnVector:
    """String columns end to end: the chars of every input side by side,
    each input's starts shifted by the char capacities before it (sizes
    the host knows), then the rows re-packed from their starts and
    lengths (``ops/strings.assemble_strings``); padding rows are empty.
    Where the capacities together pass an int32 offset (partials that
    each kept a large input's chars buffer for a few rows), each input's
    chars are first cut to its rows' bytes, one readback an input."""
    if sum(p.chars.shape[0] for p in parts) > _MAX_CHARS:
        parts = [_compacted(p) for p in parts]
    starts, lengths, base = [], [], 0
    for p in parts:
        s, n = string_row_parts(p)
        starts.append(s + base)
        lengths.append(n)
        base += p.chars.shape[0]
    raw = GpuColumnVector(parts[0].dtype, None, None,
                          None, torch.cat([p.chars for p in parts]))
    validity = None
    if any(p.validity is not None for p in parts):
        validity = _padded_cat([p.valid_mask() for p in parts], cap)
    return assemble_strings(raw, _padded_cat(starts, cap),
                            _padded_cat(lengths, cap), validity, base)


def concat_columns(parts: List[GpuColumnVector], cap: int) \
        -> GpuColumnVector:
    """Columns of one type end to end at ``cap`` rows, padding rows dead
    (empty, invalid where any part has a validity)."""
    c0 = parts[0]
    if c0.is_string_like:
        return concat_string_columns(parts, cap)
    validity = None
    if any(p.validity is not None for p in parts):
        validity = _padded_cat([p.valid_mask() for p in parts], cap)
    if c0.is_list:
        ecap = bucket_rows(sum(p.children[0].capacity for p in parts))
        kids = [concat_columns([p.children[k] for p in parts], ecap)
                for k in range(len(c0.children))]
        starts, lengths, base = [], [], 0
        for p in parts:
            s, n = string_row_parts(p)
            starts.append(s + base)
            lengths.append(n)
            base += p.children[0].capacity
        raw = GpuColumnVector(c0.dtype, None, None, None, children=kids)
        return _gather_elements(raw, _padded_cat(starts, cap),
                                _padded_cat(lengths, cap), validity, False)
    if c0.children is not None:
        return GpuColumnVector(c0.dtype, None, validity, children=[
            concat_columns([p.children[k] for p in parts], cap)
            for k in range(len(c0.children))])
    return GpuColumnVector(c0.dtype, _padded_cat([p.data for p in parts],
                                                 cap), validity)


def concat_batches_bounded(batches: List[GpuBatch]) -> GpuBatch:
    """Concatenate batches of one schema without a size readback."""
    if len(batches) == 1:
        return batches[0]
    first = batches[0]
    cap = bucket_rows(sum(b.capacity for b in batches))
    cols = []
    for ci, c0 in enumerate(first.columns):
        cols.append(concat_columns([b.columns[ci] for b in batches], cap))
    live = _padded_cat([b.live_mask() for b in batches], cap)
    return GpuBatch(cols, first.schema, cap, selection=live)
