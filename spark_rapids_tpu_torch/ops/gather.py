"""Row gather and stream compaction.

Counterpart of ``spark_rapids_tpu/ops/gather.py:23-60,98-265``, for
fixed-width, string and nested columns. Every data and validity gather goes
through **K4** (``cuda_kernels.gather_rows``): one launch moves all the
columns of a ``gather_columns`` call, where the reference packs them into
one int32 matrix for a single XLA row gather. A string column rides that
launch as its start offsets and lengths, and its characters are copied
after it (``ops/strings.assemble_strings``); a struct's children ride the
same launch, and an array's elements a second one by element index.
``compaction_indices`` is the
reference's sort of ``(dropped?, position)``, on **K3**.

The port's batch keeps its row count on the host, so a compaction that
must leave a prefix layout (``gather_batch`` with a device count,
``compact_batch``, ``ensure_compacted``) reads the count back once; the
join + group-by path never compacts (its join output and aggregate
partials carry lazy selections).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from ..columnar.batch import GpuBatch, bucket_bytes, bucket_rows, row_mask
from ..columnar.column import GpuColumnVector, slice_rows
from . import cuda_kernels as ck
from .strings import assemble_strings, string_row_parts

__all__ = ["inclusive_int_cumsum", "exclusive_cumsum", "list_offsets",
           "element_rows", "compaction_indices",
           "gather_column", "gather_columns", "gather_batch",
           "compact_batch", "shrink_batch", "ensure_compacted"]


def inclusive_int_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum (exact to 2^31)."""
    return torch.cumsum(x.to(torch.int32), 0, dtype=torch.int32)


def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive int32 prefix sum."""
    x = x.to(torch.int32)
    return inclusive_int_cumsum(x) - x


def compaction_indices(keep: torch.Tensor) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """``(indices, count)``: ``indices[j]`` is the source row of the j-th
    kept row for ``j < count``; the rows after hold the dropped rows in
    order. One stable sort by the dropped bit. ``keep`` must already
    exclude padding."""
    _, indices = ck.sort_pairs((~keep).to(torch.int64))
    return indices, keep.sum(dtype=torch.int32)


def _push_lanes(c: GpuColumnVector, datas: list, valids: list) -> None:
    """The K4 lanes of one column, appended in the order ``_rebuild``
    reads them back: a fixed-width column's data and validity; a
    string's or an array's start offsets and lengths, with its validity;
    a wide decimal's two words; a struct's validity (as a bool lane, when
    it has one) and then its children's lanes, which share its rows."""
    if c.is_string_like or c.is_list:
        datas.extend(string_row_parts(c))
        valids.extend([c.validity, None])
    elif c.children is not None:
        if c.validity is not None:
            datas.append(c.validity)
            valids.append(None)
        for ch in c.children:
            _push_lanes(ch, datas, valids)
    elif c.data.dim() == 2:
        # a wide decimal's two words (host only) ride as two columns
        datas.extend([c.data[:, 0].contiguous(), c.data[:, 1].contiguous()])
        valids.extend([c.validity, None])
    else:
        datas.append(c.data)
        valids.append(c.validity)


def _exact_chars(lengths: torch.Tensor) -> int:
    return bucket_bytes(max(int(lengths.sum(dtype=torch.int64)), 1))


def _rebuild(c: GpuColumnVector, it, out_live: Optional[torch.Tensor],
             char_cap: Optional[int], repeat: bool) -> GpuColumnVector:
    """One gathered column from the launch's outputs ``it`` (an iterator
    of ``(data, validity)`` in ``_push_lanes``' order)."""
    if c.is_string_like:
        (st, gv), (ln, _) = next(it), next(it)
        if char_cap is None:
            char_cap = _exact_chars(ln) if repeat else c.chars.shape[0]
        return assemble_strings(c, st, ln, gv, char_cap)
    if c.is_list:
        (st, gv), (ln, _) = next(it), next(it)
        return _gather_elements(c, st, ln, gv, repeat)
    if c.children is not None:
        validity = out_live
        if c.validity is not None:
            validity = next(it)[0]
        return GpuColumnVector(c.dtype, None, validity, children=[
            _rebuild(ch, it, out_live, None, repeat) for ch in c.children])
    d, gv = next(it)
    if c.data.dim() == 2:
        return GpuColumnVector(c.dtype, torch.stack([d, next(it)[0]], 1), gv)
    return GpuColumnVector(c.dtype, d, gv)


def list_offsets(lengths: torch.Tensor) -> torch.Tensor:
    """The int32 offsets (n + 1) of rows of ``lengths`` laid end to end."""
    offsets = torch.zeros(lengths.shape[0] + 1, dtype=torch.int32,
                          device=lengths.device)
    offsets[1:] = inclusive_int_cumsum(lengths)
    return offsets


def element_rows(offsets: torch.Tensor, starts: torch.Tensor, capacity: int,
                 source_capacity: int) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor, torch.Tensor]:
    """``(row, position, source, live)`` of each of ``capacity`` output
    elements laid out by ``offsets``: the row it falls in (a search over
    the offsets, the reference's ``gather_list``), its position in that
    row, the element it copies (``starts[row] + position``, clamped into
    ``source_capacity``, int32) and whether it is below the total. The
    list gather and explode both find their elements' rows here."""
    n = offsets.shape[0] - 1
    e = torch.arange(capacity, dtype=torch.int32, device=offsets.device)
    row = torch.searchsorted(offsets[1:], e, right=True) \
        .clamp_(max=max(n - 1, 0))
    position = e - offsets[row]
    source = (starts[row] + position).clamp_(0, max(source_capacity - 1, 0))
    return row, position, source.to(torch.int32), e < offsets[n]


def _gather_elements(c: GpuColumnVector, starts: torch.Tensor,
                     lengths: torch.Tensor, validity: Optional[torch.Tensor],
                     repeat: bool) -> GpuColumnVector:
    """An array or map column from its rows' gathered ``starts`` and
    ``lengths`` (zero on dead rows): the new offsets are the prefix sum of
    the lengths, each output element finds its row by a search over them,
    and the element columns move in one more K4 launch by element index
    (the reference's ``gather_list``, ``:62-96``). The elements keep
    their column's capacity, enough for a gather that takes each source
    row at most once; with ``repeat`` (a join's or an explode's
    duplicating gather) they are sized to the total, read back."""
    n = lengths.shape[0]
    dev = lengths.device
    offsets = list_offsets(lengths)
    src_cap = c.children[0].capacity
    ecap = bucket_rows(int(offsets[n])) if repeat else src_cap
    if src_cap == 0 or n == 0:
        kids = [GpuColumnVector.nulls(ch.dtype, ecap, dev)
                for ch in c.children]
        return GpuColumnVector(c.dtype, None, validity, offsets,
                               children=kids)
    _, _, src, live = element_rows(offsets, starts, ecap, src_cap)
    kids = gather_columns(c.children, src, live, repeat=repeat)
    return GpuColumnVector(c.dtype, None, validity, offsets, children=kids)


def gather_columns(columns: Sequence[GpuColumnVector],
                   indices: torch.Tensor,
                   out_live: Optional[torch.Tensor],
                   char_capacities: Optional[Sequence[int]] = None,
                   repeat: bool = False) -> List[GpuColumnVector]:
    """Reorder columns by row indices in one K4 launch. ``out_live``
    (need not be a prefix: the join gathers build rows into match
    positions) zeroes dead output rows and clears their validity; None
    means every output row is live. A string column's output holds
    ``char_capacities[i]`` bytes, by default its input's: enough for any
    gather that takes each source row at most once. A struct's children
    ride the same launch; an array's or a map's elements take one more
    (``_gather_elements``). ``repeat`` sizes the strings and elements
    inside nested columns to what a duplicating gather needs (one
    readback each)."""
    if not columns:
        return []
    datas, valids = [], []
    for c in columns:
        _push_lanes(c, datas, valids)
    gd, gv = ck.gather_rows(datas, valids,
                            indices.to(torch.int32).contiguous(), out_live)
    it = iter(zip(gd, gv))
    return [_rebuild(c, it, out_live,
                     None if char_capacities is None or not c.is_string_like
                     else char_capacities[i], repeat)
            for i, c in enumerate(columns)]


def gather_column(col: GpuColumnVector, indices: torch.Tensor,
                  out_live: Optional[torch.Tensor]) -> GpuColumnVector:
    """Reorder one column by row indices."""
    return gather_columns([col], indices, out_live)[0]


def gather_batch(batch: GpuBatch, indices: torch.Tensor,
                 count: Union[int, torch.Tensor]) -> GpuBatch:
    """Reorder or compact a whole batch into prefix layout with ``count``
    live rows (a device count is read back: the batch's row count lives
    on the host)."""
    count = int(count)
    out_live = row_mask(indices.shape[0], count, indices.device)
    cols = gather_columns(batch.columns, indices, out_live)
    return GpuBatch(cols, batch.schema, count)


def compact_batch(batch: GpuBatch, keep: torch.Tensor) -> GpuBatch:
    """Stream compaction: keep the live rows where ``keep``."""
    indices, count = compaction_indices(keep & batch.live_mask())
    return gather_batch(batch, indices, count)


def shrink_batch(batch: GpuBatch, new_cap: int) -> GpuBatch:
    """Slice a prefix-layout batch down to a smaller capacity
    (``row_count <= new_cap``)."""
    if batch.selection is not None:
        raise ValueError("compact before shrinking")
    if new_cap >= batch.capacity:
        return batch
    cols = [slice_rows(c, 0, new_cap) for c in batch.columns]
    return GpuBatch(cols, batch.schema, batch.row_count)


def ensure_compacted(batch: GpuBatch) -> GpuBatch:
    """Materialise a lazy selection into prefix layout; no-op without
    one."""
    if batch.selection is None:
        return batch
    return compact_batch(batch, batch.live_mask())
