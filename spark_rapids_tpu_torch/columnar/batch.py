"""Columnar batches on the device.

Counterpart of ``spark_rapids_tpu/columnar/batch.py:26,73,78``
(``bucket_rows``, ``row_mask``, ``TpuBatch``). A batch keeps the
reference's layout: a power-of-two ``capacity``, a host ``row_count``
whose prefix holds the live rows, and an optional lazy ``selection``
mask that a filter attaches instead of compacting.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..datatypes import Schema
from .column import GpuColumnVector

__all__ = ["GpuBatch", "bucket_rows", "bucket_bytes", "row_mask"]

_MIN_CAPACITY = 128


def bucket_rows(n: int, minimum: int = _MIN_CAPACITY) -> int:
    """Capacity bucket: the next power of two >= n (>= minimum), the
    same padding as the reference."""
    cap = minimum
    while cap < n:
        cap <<= 1
    return cap


def bucket_bytes(n: int, minimum: int = 1 << 10) -> int:
    """Power-of-two byte capacity of at least ``minimum``: a string
    column's chars bucket (``spark_rapids_tpu/columnar/batch.py:38``)."""
    cap = minimum
    while cap < n:
        cap <<= 1
    return cap


def row_mask(capacity: int, row_count: int,
             device: torch.device) -> torch.Tensor:
    """Bool mask of live (non-padding) rows."""
    return torch.arange(capacity, device=device) < row_count


class GpuBatch:
    """Device batch. Live rows are the prefix below ``row_count``,
    further restricted by the optional ``selection`` mask (the lazy
    filter). Mask-aware consumers read ``live_mask()``; the Arrow
    download compacts."""

    __slots__ = ("columns", "schema", "row_count", "selection")

    def __init__(self, columns: List[GpuColumnVector], schema: Schema,
                 row_count: int, selection: Optional[torch.Tensor] = None):
        self.columns = list(columns)
        self.schema = schema
        self.row_count = int(row_count)
        self.selection = selection

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else 0

    @property
    def device(self) -> torch.device:
        return self.columns[0].device

    def device_size_bytes(self) -> int:
        """Bytes the batch's columns hold on the device."""
        n = sum(c.device_size_bytes() for c in self.columns)
        if self.selection is not None:
            n += self.selection.numel()
        return n

    def live_mask(self) -> torch.Tensor:
        m = row_mask(self.capacity, self.row_count, self.device)
        if self.selection is not None:
            m = m & self.selection
        return m

    def with_selection(self, keep: torch.Tensor) -> "GpuBatch":
        """Restrict live rows by a bool mask (ANDed with any existing
        selection) without moving data."""
        sel = keep if self.selection is None else self.selection & keep
        return GpuBatch(self.columns, self.schema, self.row_count, sel)

    def __repr__(self):
        return (f"GpuBatch(rows={self.row_count}, cap={self.capacity}, "
                f"schema={self.schema})")
