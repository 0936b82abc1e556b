"""String row gathers and comparisons over ``(offsets int32, chars
uint8)`` columns.

Counterpart of ``spark_rapids_tpu/ops/strings.py`` (``string_lengths``,
``:25``, is ``GpuColumnVector.lengths``): ``gather_window``,
``string_compare``, ``gather_strings`` (``:30,48,82``), and the string
functions of ``:122-264``, written in vectorised torch over the
``(offsets, chars)`` layout where the reference loops over 64-byte
windows in a ``jax.lax.while_loop``:

- ``substring_bytes`` (``substring_tpu``) and ``trim_spaces`` (the
  reference's ``expr/strings._trim_tpu``) compute each row's new start
  and length, then ``assemble_strings`` copies the bytes (one
  ``searchsorted`` an output byte). Their char capacity is the input's,
  a host-known bound, so no size is read back;
- ``case_map_ascii`` (``upper_ascii_tpu``/``lower_ascii_tpu``) maps the
  chars buffer byte for byte;
- ``concat_strings`` (``concat_strings_tpu``) lays the k inputs' rows
  out as n x k pieces over their chars side by side and assembles the
  pieces in one pass; the output's offsets are every k-th piece offset;
- ``char_offsets`` maps a row's character indices to byte offsets
  through a running count of UTF-8 lead bytes (``Length`` counts
  characters with the same count).

``_match_at``, ``starts_with_tpu``, ``ends_with_tpu`` and
``contains_tpu`` have no counterpart here: ``expr/strings`` runs the
three literal shapes on K6 (``ops/regex.compile_literal``).

None of these builds an intermediate that grows with the longest row.

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
           "string_row_parts", "assemble_strings", "gather_strings",
           "utf8_lead_counts", "char_offsets", "substring_bytes",
           "substring_chars", "case_map_ascii", "concat_strings",
           "trim_spaces"]


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


def _i64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64)


def utf8_lead_counts(col: GpuColumnVector) -> torch.Tensor:
    """``counts[i]``: the UTF-8 lead bytes (bytes that start a character)
    in ``chars[:i]``, int64, one longer than the buffer."""
    lead = (col.chars & 0xC0) != 0x80
    out = torch.zeros(col.chars.shape[0] + 1, dtype=torch.int64,
                      device=col.chars.device)
    out[1:] = torch.cumsum(lead.to(torch.int64), 0)
    return out


def char_offsets(col: GpuColumnVector, counts: torch.Tensor,
                 k: torch.Tensor) -> torch.Tensor:
    """The byte offset in each row of its character ``k`` (clamped to
    ``[0, characters]``; the row's length at its end): the first byte
    ``p`` after which ``k + 1`` lead bytes of the row lie, less one."""
    starts = _i64(col.offsets[:-1])
    ends = _i64(col.offsets[1:])
    nchar = counts[ends] - counts[starts]
    k = torch.minimum(k.clamp(min=0), nchar)
    target = counts[starts] + k + 1
    p = torch.searchsorted(counts, target, right=False) - 1
    return torch.where(k >= nchar, ends, p) - starts


def _spark_window(pos: torch.Tensor, length: torch.Tensor,
                  size: torch.Tensor):
    """Spark's ``substringSQL`` window over a row of ``size`` units:
    ``(start, count)``. A positive ``pos`` is 1-based, a negative one
    counts from the end, 0 is the first unit; the window is ``length``
    units from that start, clipped to the row (so a start before the row
    eats into the length)."""
    pos, length = _i64(pos), _i64(length)
    start = torch.where(pos > 0, pos - 1,
                        torch.where(pos < 0, size + pos,
                                    torch.zeros_like(pos)))
    end = torch.minimum(start + length.clamp(min=0), size)
    start = start.clamp(min=0)
    return start, (end - start).clamp(min=0)


def substring_bytes(col: GpuColumnVector, pos: torch.Tensor,
                    length: torch.Tensor,
                    validity: Optional[torch.Tensor]) -> GpuColumnVector:
    """Spark's substring in bytes (exact for ASCII; the device path)."""
    lens = _i64(col.lengths())
    s, n = _spark_window(pos, length, lens)
    starts = _i64(col.offsets[:-1]) + s
    return assemble_strings(col, starts.to(torch.int32),
                            n.to(torch.int32), validity,
                            col.chars.shape[0])


def substring_chars(col: GpuColumnVector, pos: torch.Tensor,
                    length: torch.Tensor,
                    validity: Optional[torch.Tensor]) -> GpuColumnVector:
    """Spark's substring in characters (the CPU path)."""
    counts = utf8_lead_counts(col)
    starts = _i64(col.offsets[:-1])
    nchar = counts[_i64(col.offsets[1:])] - counts[starts]
    s, n = _spark_window(pos, length, nchar)
    b0 = char_offsets(col, counts, s)
    b1 = char_offsets(col, counts, s + n)
    return assemble_strings(col, (starts + b0).to(torch.int32),
                            (b1 - b0).to(torch.int32), validity,
                            col.chars.shape[0])


def case_map_ascii(col: GpuColumnVector, upper: bool) -> GpuColumnVector:
    """ASCII letters to upper (lower) case; every other byte as it is."""
    c = col.chars
    lo, hi, shift = (ord("a"), ord("z"), -32) if upper \
        else (ord("A"), ord("Z"), 32)
    hit = (c >= lo) & (c <= hi)
    chars = torch.where(hit, (c.to(torch.int16) + shift).to(torch.uint8), c)
    return GpuColumnVector(col.dtype, None, col.validity, col.offsets,
                           chars)


def concat_strings(cols: Sequence[GpuColumnVector],
                   validity: Optional[torch.Tensor]) -> GpuColumnVector:
    """Row-wise concatenation of string columns of one capacity: n x k
    pieces over the inputs' chars side by side, assembled at once."""
    k = len(cols)
    base = 0
    starts, lengths = [], []
    for c in cols:
        st, ln = string_row_parts(c)
        starts.append(st + base)
        lengths.append(ln)
        base += c.chars.shape[0]
    both = GpuColumnVector(cols[0].dtype, None, None, None,
                           torch.cat([c.chars for c in cols]))
    piece_starts = torch.stack(starts, 1).reshape(-1)
    piece_lens = torch.stack(lengths, 1).reshape(-1)
    pieces = assemble_strings(both, piece_starts, piece_lens, None, base)
    return GpuColumnVector(cols[0].dtype, None, validity,
                           pieces.offsets[::k].contiguous(), pieces.chars)


def trim_spaces(col: GpuColumnVector, left: bool,
                right: bool) -> GpuColumnVector:
    """Strip ASCII spaces (0x20) from either end of each row: the first
    and last non-space byte of a row come from running extremes over the
    whole buffer."""
    starts = _i64(col.offsets[:-1])
    ends = _i64(col.offsets[1:])
    size = col.chars.shape[0]
    if size == 0:
        return col
    idx = torch.arange(size, dtype=torch.int64, device=starts.device)
    keep = col.chars != 0x20
    big = torch.full_like(idx, size)
    # the next non-space byte at or after i, the last one at or before i
    nxt = torch.flip(torch.cummin(torch.flip(torch.where(keep, idx, big),
                                             [0]), 0).values, [0])
    prv = torch.cummax(torch.where(keep, idx, torch.full_like(idx, -1)),
                       0).values
    new_s, new_e = starts, ends
    if left:
        new_s = torch.minimum(nxt[starts.clamp(max=size - 1)], ends)
        new_s = torch.where(starts < ends, new_s, starts)
    if right:
        last = prv[(ends - 1).clamp(min=0, max=size - 1)]
        new_e = torch.where(ends > new_s, torch.maximum(last + 1, new_s),
                            new_s)
    return assemble_strings(col, new_s.to(torch.int32),
                            (new_e - new_s).to(torch.int32), col.validity,
                            size)
