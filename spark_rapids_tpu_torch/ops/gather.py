"""Row gather and stream compaction.

Counterpart of ``spark_rapids_tpu/ops/gather.py:23-60,98-265``, for
fixed-width and string columns. Every data and validity gather goes
through **K4** (``cuda_kernels.gather_rows``): one launch moves all the
columns of a ``gather_columns`` call, where the reference packs them into
one int32 matrix for a single XLA row gather. A string column rides that
launch as its start offsets and lengths, and its characters are copied
after it (``ops/strings.assemble_strings``). ``compaction_indices`` is the
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

from ..columnar.batch import GpuBatch, row_mask
from ..columnar.column import GpuColumnVector
from . import cuda_kernels as ck
from .strings import assemble_strings, string_row_parts

__all__ = ["inclusive_int_cumsum", "exclusive_cumsum", "compaction_indices",
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


def gather_columns(columns: Sequence[GpuColumnVector],
                   indices: torch.Tensor,
                   out_live: Optional[torch.Tensor],
                   char_capacities: Optional[Sequence[int]] = None) \
        -> List[GpuColumnVector]:
    """Reorder columns by row indices in one K4 launch. ``out_live``
    (need not be a prefix: the join gathers build rows into match
    positions) zeroes dead output rows and clears their validity; None
    means every output row is live. A string column's output holds
    ``char_capacities[i]`` bytes, by default its input's: enough for any
    gather that takes each source row at most once."""
    if not columns:
        return []
    datas, valids = [], []
    for c in columns:
        if c.is_string_like:
            datas.extend(string_row_parts(c))
            valids.extend([c.validity, None])
        elif c.data.dim() == 2:
            # a wide decimal's two words (host only) ride as two columns
            datas.extend([c.data[:, 0].contiguous(),
                          c.data[:, 1].contiguous()])
            valids.extend([c.validity, None])
        else:
            datas.append(c.data)
            valids.append(c.validity)
    gd, gv = ck.gather_rows(datas, valids,
                            indices.to(torch.int32).contiguous(), out_live)
    out, at = [], 0
    for i, c in enumerate(columns):
        if c.is_string_like:
            cap = c.chars.shape[0] if char_capacities is None \
                else char_capacities[i]
            out.append(assemble_strings(c, gd[at], gd[at + 1], gv[at], cap))
            at += 2
        elif c.data.dim() == 2:
            out.append(GpuColumnVector(
                c.dtype, torch.stack([gd[at], gd[at + 1]], 1), gv[at]))
            at += 2
        else:
            out.append(GpuColumnVector(c.dtype, gd[at], gv[at]))
            at += 1
    return out


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
    cols = [GpuColumnVector(c.dtype,
                            None if c.data is None else c.data[:new_cap],
                            None if c.validity is None
                            else c.validity[:new_cap],
                            None if c.offsets is None
                            else c.offsets[:new_cap + 1], c.chars)
            for c in batch.columns]
    return GpuBatch(cols, batch.schema, batch.row_count)


def ensure_compacted(batch: GpuBatch) -> GpuBatch:
    """Materialise a lazy selection into prefix layout; no-op without
    one."""
    if batch.selection is None:
        return batch
    return compact_batch(batch, batch.live_mask())
