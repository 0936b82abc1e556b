"""String row gathers and comparisons over ``(offsets int32, chars
uint8)`` columns.

Counterpart of ``gather_window``, ``string_compare_tpu`` and
``gather_strings`` (``spark_rapids_tpu/ops/strings.py:30,48,82``;
``string_lengths``, ``:25``, is ``GpuColumnVector.lengths``); the other
string kernels (substring, case, search, concat) wait for ROADMAP item
13.

A comparison is unsigned and byte-wise, and a shorter prefix comes
first. Where the reference walks 64-byte windows in a
``jax.lax.while_loop`` until every row is decided, the port reads one
window whose width is a host-known bound: the longer of the two
columns' longest strings (one readback), or, against literals of at
most L bytes, L + 1 bytes (the row's first L bytes and one more decide
it, so nothing is read back): ``compare_with_literals`` gathers that
window from the column once and holds it against each literal's bytes,
a broadcast constant, so a literal is never built as a column. The
first differing byte of the window decides each row.

The row part of a gather moves with **K4**: each string
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

from typing import List, Optional, Sequence, Tuple

import torch

from ..columnar.column import GpuColumnVector
from . import cuda_kernels as ck

__all__ = ["gather_window", "string_compare", "compare_with_literals",
           "string_row_parts", "assemble_strings", "gather_strings"]


def gather_window(offsets: torch.Tensor, chars: torch.Tensor, chunk: int,
                  window: int) -> torch.Tensor:
    """``(n, window)`` int16 bytes of window ``chunk`` of each string;
    positions past a string's end hold -1, below every real byte."""
    n = offsets.shape[0] - 1
    starts = offsets[:-1].to(torch.int64)
    lens = (offsets[1:] - offsets[:-1]).to(torch.int64)
    pos = chunk * window + torch.arange(window, dtype=torch.int64,
                                        device=offsets.device)[None, :]
    in_range = pos < lens[:, None]
    if chars.shape[0] == 0:
        return torch.full((n, window), -1, dtype=torch.int16,
                          device=offsets.device)
    idx = (starts[:, None] + pos).clamp_(0, chars.shape[0] - 1)
    b = chars[idx].to(torch.int16)
    return torch.where(in_range, b, torch.full_like(b, -1))


def string_compare(a: GpuColumnVector, b: GpuColumnVector,
                   window: Optional[int] = None) -> torch.Tensor:
    """Row-wise compare, unsigned and byte-wise: int8 -1/0/1. ``window``
    must cover every byte up to the first difference of each row (or the
    longer string when they are equal); None reads back the longer of
    the two columns' longest strings."""
    if window is None:
        window = int(torch.maximum(a.lengths().max(), b.lengths().max())) \
            if a.capacity else 0
    n = a.capacity
    if window == 0:
        return torch.zeros(n, dtype=torch.int8, device=a.device)
    return _first_difference(gather_window(a.offsets, a.chars, 0, window),
                             gather_window(b.offsets, b.chars, 0, window))


def _first_difference(wa: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """int8 -1/0/1 of each row of ``wa`` against the same row of ``wb``
    (or its one row, broadcast), decided by the first byte that
    differs."""
    diff = wa != wb
    first = diff.to(torch.int8).argmax(dim=1, keepdim=True)
    sa = wa.gather(1, first)[:, 0]
    sb = wb.expand_as(wa).gather(1, first)[:, 0]
    cmp = torch.where(sa < sb, -1, 1).to(torch.int8)
    return torch.where(diff.any(dim=1), cmp, torch.zeros_like(cmp))


def compare_with_literals(col: GpuColumnVector,
                          literals: Sequence[bytes]) -> List[torch.Tensor]:
    """Each row of ``col`` against each literal, unsigned and byte-wise:
    int8 -1/0/1, one tensor a literal. One window of the longest
    literal's length plus one byte is gathered from the column, and the
    literals go to the device together, one row of bytes each (-1 past
    the end)."""
    window = max(len(raw) for raw in literals) + 1
    rows = [list(raw) + [-1] * (window - len(raw)) for raw in literals]
    consts = torch.tensor(rows, dtype=torch.int16).to(col.device)
    w = gather_window(col.offsets, col.chars, 0, window)
    return [_first_difference(w, consts[i:i + 1])
            for i in range(len(literals))]


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
