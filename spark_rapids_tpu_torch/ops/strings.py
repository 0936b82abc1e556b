"""String row gathers over ``(offsets int32, chars uint8)`` columns.

Counterpart of ``gather_strings`` (``spark_rapids_tpu/ops/strings.py:82``)
only; the other string kernels (compare, substring, case, search) wait
for ROADMAP item 13. The row part moves with **K4**: each string
column's start offsets and lengths travel as two int32 columns in the
same ``gather_rows`` launch as the batch's fixed-width columns
(``ops/gather.gather_columns``). The output offsets are the exclusive
cumulative sum of the gathered lengths, and the characters are copied
in torch: for each output byte one ``searchsorted`` over the new offsets
finds its row, and one gather reads the byte from the source. This
is not a TPU kernel, so plain torch is the port: a CUDA string gather
waits until a trace shows that it matters. Nothing is read back: the
character capacity of the output is the caller's host-known bound.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..columnar.column import GpuColumnVector
from . import cuda_kernels as ck

__all__ = ["string_row_parts", "assemble_strings", "gather_strings"]


def string_row_parts(col: GpuColumnVector) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """``(starts, lengths)``: two contiguous int32 lanes, one value a
    row, that a row gather moves in place of the string."""
    starts = col.offsets[:-1].contiguous()
    return starts, (col.offsets[1:] - starts).contiguous()


def assemble_strings(col: GpuColumnVector, starts: torch.Tensor,
                     lengths: torch.Tensor,
                     validity: Optional[torch.Tensor],
                     char_capacity: int) -> GpuColumnVector:
    """The gathered string column from the gathered ``starts`` and
    ``lengths`` (zero on dead output rows): offsets by an exclusive
    cumulative sum, then each output byte copied from its source
    position."""
    n = lengths.shape[0]
    dev = lengths.device
    offsets = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(lengths, 0, dtype=torch.int32)
    if char_capacity == 0 or col.chars.shape[0] == 0 or n == 0:
        chars = torch.zeros(char_capacity, dtype=torch.uint8, device=dev)
        return GpuColumnVector(col.dtype, None, validity, offsets, chars)
    k = torch.arange(char_capacity, dtype=torch.int32, device=dev)
    row = torch.searchsorted(offsets[1:], k, right=True).clamp_(max=n - 1)
    src = starts[row] + (k - offsets[row])
    src = src.clamp_(0, col.chars.shape[0] - 1).long()
    chars = torch.where(k < offsets[n], col.chars[src],
                        torch.zeros((), dtype=torch.uint8, device=dev))
    return GpuColumnVector(col.dtype, None, validity, offsets, chars)


def gather_strings(col: GpuColumnVector, indices: torch.Tensor,
                   char_capacity: int,
                   out_live: Optional[torch.Tensor] = None) \
        -> GpuColumnVector:
    """Reorder a string column by row indices: lengths and starts with
    one K4 launch, offsets by a cumulative sum, chars copied in torch.
    ``out_live`` zeroes the lengths of dead output rows (and clears
    their validity), so padding cannot inflate the offsets."""
    starts, lengths = string_row_parts(col)
    (g_starts, g_lens), (valid, _) = ck.gather_rows(
        [starts, lengths], [col.validity, None],
        indices.to(torch.int32).contiguous(), out_live)
    return assemble_strings(col, g_starts, g_lens, valid, char_capacity)
