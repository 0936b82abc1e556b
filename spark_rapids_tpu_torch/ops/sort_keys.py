"""Sort-key normalisation and multi-key permutations.

Counterpart of ``spark_rapids_tpu/ops/sort_keys.py:39-285``. As there,
every key column becomes an orderable lane (floats through the IEEE
total-order bit trick with Spark's NaN and ``-0.0`` semantics), behind a
live lane that puts padding last and a null lane per key. Where the
reference hands the lanes to one ``jax.lax.sort``, the port packs them
into uint64 words, most significant first (live bit, then per key a null
bit and the value lane with its sign bit flipped, so that unsigned order
is Spark's order), and sorts the words with **K3**
(``cuda_kernels.sort_pairs``) with the row position as payload. A key
set wider than 64 bits is sorted word by word, least significant word
first; each pass sorts ``(word, current position)`` pairs, which keeps
it stable, and **K4** (``gather_rows``) carries the other words and the
permutation along. A single int32 key is one pass (1 + 1 + 32 bits).

A string key orders by its dense rank among the live, non-null rows
(``string_order_ranks``, ``:148``; null and dead rows rank INT32_MAX), a
32-bit value lane. The ranks refine pass by pass: each pass sorts
``(rank, the next 7-byte window)`` with ``sort_packed`` on K3, the window
packed 9 bits a byte (past the end 0, a byte b as b + 1, so a shorter
prefix comes first: 63 bits, a non-negative int64), splits the ties
where the sorted words change, and takes the new ranks back to row order
by an inverse permutation (one scatter). **The trip count** is fixed on
the host before the first pass: ``ceil(L / 7)`` passes, L the longest
string among the column's rows, live or not (one readback a column a
sort; every live row is among them, so no live string is cut short, and
the count does not depend on which rows a view keeps). The reference
loops in ``jax.lax.while_loop`` until the longest live string is
consumed or every rank is distinct; further passes leave distinct ranks
as they are, so the ranks are the same. Pass 0's ranks are the live bit
alone, so its key is one 64-bit word (one K3 launch); a later pass packs
``bit_length(n)`` rank bits with the window into two words (two K3
launches and two K4 carries), one word when ``n <= 1``
(``rank_pass_words``, which the engine's packing and the launch counts
of ``chip_smoke.py`` share). The passes run inside a
``torch.profiler.record_function("string_ranks")`` range, which
``tools/nds_trace.py`` reads.

A decimal key orders as its int64 lane (the reference's ``:81``), one
64-bit value lane, so a Decimal64 key costs what a long key costs. A
decimal past 18 digits, which only the host holds, is two 64-bit lanes,
its high word then its low word (``ops/decimals.orderable_words``).
A nested key: the planner places every operator that sorts, groups,
joins or partitions by one on the CPU (the reference's gates). There a
struct key orders as its fields do, one after the other, each a key of
its own under the struct's null lane (``_struct_lanes``), and an array
key by its dense rank among the batch's rows in Spark's order
(``nested_key_ranks``: the reference's ``_nested_cpu_key``, elements
then length, null first, NaN largest), which a CUDA tensor refuses.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch

from .. import datatypes as dt
from ..columnar.column import GpuColumnVector, and_validity, is_string_like
from . import cuda_kernels as ck
from .decimals import orderable_words
from .gather import inclusive_int_cumsum
from .strings import gather_window

__all__ = ["SortSpec", "canonicalize_floats", "normalize_float_key_col",
           "check_key_type", "orderable_int", "key_lane_width",
           "key_lane_bits", "unsigned_lane", "pack_words", "sort_packed",
           "rank_pass_count", "rank_pass_words", "string_order_ranks_multi",
           "string_order_ranks", "change_flags", "sorted_key_words",
           "sort_permutation",
           "sorted_segments", "segment_ids_for_keys", "nested_cpu_key",
           "nested_key_ranks", "key_lane_count"]

_I64_MIN = -(1 << 63)
_I32_MAX = (1 << 31) - 1
_RANK_WINDOW = 7   # bytes a refinement pass reads: 7 x 9 bits = 63
_RANK_BITS = 32    # a string key's value lane
_WIDTHS = {torch.bool: 1, torch.int8: 8, torch.int16: 16, torch.int32: 32,
           torch.int64: 64, torch.float32: 32, torch.float64: 64}
_FIXED_WIDTH = (dt.BooleanType, dt.ByteType, dt.ShortType, dt.IntegerType,
                dt.LongType, dt.FloatType, dt.DoubleType, dt.DateType,
                dt.TimestampType)


@dataclasses.dataclass(frozen=True)
class SortSpec:
    """Per-key direction and null placement (Spark's defaults: ascending
    nulls first; descending nulls last)."""
    ascending: bool = True
    nulls_first: bool = True


def canonicalize_floats(d: torch.Tensor) -> torch.Tensor:
    """``-0.0`` -> ``0.0`` and any NaN -> the canonical NaN (Spark's
    NormalizeFloatingNumbers)."""
    d = torch.where(d == 0, torch.zeros_like(d), d)
    return torch.where(torch.isnan(d), torch.full_like(d, float("nan")), d)


def normalize_float_key_col(col: GpuColumnVector) -> GpuColumnVector:
    """Float key normalisation at column level, for every place a key
    value is compared or emitted (group keys, join keys)."""
    if not dt.is_floating(col.dtype):
        return col
    return GpuColumnVector(col.dtype, canonicalize_floats(col.data),
                           col.validity)


def _contains_map(t: dt.DataType) -> bool:
    if isinstance(t, dt.MapType):
        return True
    if isinstance(t, dt.ArrayType):
        return _contains_map(t.element_type)
    if isinstance(t, dt.StructType):
        return any(_contains_map(f.dtype) for f in t.fields)
    return False


def check_key_type(t: dt.DataType) -> None:
    """Raise for a key type the port cannot order: a map anywhere in it
    (Spark compares no map), or a type without a lane. A struct or array
    key orders on the CPU (``nested_key_ranks``)."""
    if _contains_map(t):
        raise NotImplementedError(
            f"{t.simple_string()} keys: a map cannot be ordered, grouped "
            "or joined on")
    if not (isinstance(t, _FIXED_WIDTH + (dt.DecimalType,))
            or is_string_like(t) or dt.is_nested(t)):
        raise NotImplementedError(
            f"{t.simple_string()} sort/group/join keys are not ported")


def _check_fixed(t: dt.DataType) -> None:
    check_key_type(t)
    if dt.is_nested(t):
        raise NotImplementedError(
            f"a nested key ({t.simple_string()}) has no device lane: it "
            "orders by nested_key_ranks on the CPU")
    if is_string_like(t):
        raise TypeError("a string key orders by string_order_ranks, not "
                        "by its data lane")
    if dt.is_wide_decimal(t):
        raise TypeError("a decimal past 18 digits orders by its two words "
                        "(_key_lanes), not by one lane")


def orderable_int(col: GpuColumnVector) -> torch.Tensor:
    """The data lane as a signed integer lane whose ascending order is
    Spark's ascending order (nulls are the null lane's business). Floats:
    ``-0.0 == 0.0`` and every NaN equal and largest."""
    t = col.dtype
    _check_fixed(t)
    d = col.data
    if isinstance(t, dt.BooleanType):
        return d.to(torch.int8)
    if dt.is_floating(t):
        bits_t, flip = (torch.int32, 0x7FFFFFFF) \
            if d.dtype == torch.float32 else (torch.int64, (1 << 63) - 1)
        bits = canonicalize_floats(d).view(bits_t)
        # positives keep their bits; negatives map to bits ^ INT_MAX,
        # which is ~bits + INT_MIN, so they land ascending below +0.0
        return torch.where(bits < 0, bits ^ flip, bits)
    return d


def key_lane_width(col: GpuColumnVector) -> int:
    """Bits of a key's value lane (a string key's is its rank)."""
    check_key_type(col.dtype)
    if is_string_like(col.dtype):
        return _RANK_BITS
    if isinstance(col.dtype, dt.BooleanType):
        return 1
    return _WIDTHS[col.data.dtype]


def key_lane_bits(col: GpuColumnVector) -> Tuple[torch.Tensor, int]:
    """``(lane, width)``: the orderable lane as an unsigned ``width``-bit
    value held in int64 (the sign bit flipped), so unsigned order is
    Spark's order."""
    width = key_lane_width(col)
    return unsigned_lane(orderable_int(col), width), width


def unsigned_lane(v: torch.Tensor, width: int) -> torch.Tensor:
    """A signed ``width``-bit orderable lane as the unsigned value of the
    same order (the sign bit flipped), held in int64."""
    v = v.to(torch.int64)
    if width == 1:
        return v & 1
    if width == 64:
        return v ^ _I64_MIN
    return v + (1 << (width - 1))


def _mask(bits: int) -> int:
    return -1 if bits == 64 else (1 << bits) - 1


def _shr(v: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    if s == 0:
        return v
    return (v >> s) & _mask(64 - s)


def pack_words(lanes: Sequence[Tuple[torch.Tensor, int]]) \
        -> List[torch.Tensor]:
    """Concatenate ``(lane, width)`` bit fields, most significant first,
    into uint64 words (int64 tensors), most significant word first. The
    last word holds the remaining bits right-aligned; the lexicographic
    order of the words is the order of the whole bit string."""
    n = lanes[0][0].shape[0]
    device = lanes[0][0].device
    words: List[torch.Tensor] = []
    cur = torch.zeros(n, dtype=torch.int64, device=device)
    used = 0
    for v, width in lanes:
        left = width
        while left:
            take = min(left, 64 - used)
            part = _shr(v, left - take) & _mask(take)
            cur = part if used == 0 else (cur << take) | part
            used += take
            left -= take
            if used == 64:
                words.append(cur)
                cur = torch.zeros(n, dtype=torch.int64, device=device)
                used = 0
    if used:
        words.append(cur)
    return words


def sort_packed(words: Sequence[torch.Tensor]) \
        -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``(words in sorted order, perm)``: a stable sort by the words,
    lexicographic and unsigned, with K3 one pass a word, least
    significant first."""
    cur = list(words)
    perm = None
    for k in reversed(range(len(cur))):
        skey, pos = ck.sort_pairs(cur[k].contiguous())
        rest = [i for i in range(len(cur)) if i != k]
        carried = [cur[i] for i in rest] + ([] if perm is None else [perm])
        if carried:
            moved, _ = ck.gather_rows(carried, [None] * len(carried), pos)
            for i, m in zip(rest, moved):
                cur[i] = m
            perm = pos if perm is None else moved[-1]
        else:
            perm = pos
        cur[k] = skey
    return cur, perm


def rank_pass_count(max_len: int) -> int:
    """Refinement passes for strings of at most ``max_len`` bytes."""
    return -(-max_len // _RANK_WINDOW)


def _rank_pass_bits(pass_index: int, n: int) -> int:
    """Rank bits a refinement pass packs before its 63 window bits: the
    live bit alone in pass 0, else enough for ``n`` distinct ranks."""
    return 1 if pass_index == 0 else max(1, n.bit_length())


def rank_pass_words(pass_index: int, n: int) -> int:
    """K3 words of refinement pass ``pass_index`` over ``n`` rows (the
    K4 carries of a pass: this, when it is above one, else none)."""
    return -(-(_rank_pass_bits(pass_index, n) + 63) // 64)


def _window_key(col: GpuColumnVector, chunk: int) -> torch.Tensor:
    """Bytes ``7 chunk .. 7 chunk + 6`` of each string as one
    non-negative int64, 9 bits a byte: past the end 0, byte b as b + 1."""
    w = gather_window(col.offsets, col.chars, chunk,
                      _RANK_WINDOW).to(torch.int64) + 1
    key = torch.zeros(w.shape[0], dtype=torch.int64, device=w.device)
    for b in range(_RANK_WINDOW):
        key = (key << 9) | w[:, b]
    return key


def string_order_ranks_multi(cols: Sequence[GpuColumnVector],
                             lives: Sequence[torch.Tensor]) -> torch.Tensor:
    """Dense order ranks over the columns' rows one after another:
    ``rank[i] < rank[j]`` iff ``bytes(i) < bytes(j)``, unsigned and
    byte-wise; equal strings share a rank, across columns too. Rows
    outside ``lives`` rank INT32_MAX. int32, ``sum(capacities)`` long.
    The trip count is the module docstring's."""
    with torch.profiler.record_function("string_ranks"):
        live = torch.cat([lv for lv in lives])
        n = live.shape[0]
        lens = torch.cat([c.lengths() for c in cols])
        passes = rank_pass_count(int(lens.max()) if n else 0)
        rank = (~live).to(torch.int64)
        for chunk in range(passes):
            key = torch.cat([_window_key(c, chunk) for c in cols])
            words, perm = sort_packed(pack_words(
                [(rank, _rank_pass_bits(chunk, n)), (key, 63)]))
            boundary = change_flags(words)
            rank = torch.empty_like(rank)
            rank[perm.long()] = (inclusive_int_cumsum(boundary) - 1) \
                .to(torch.int64)
        return torch.where(live, rank,
                           torch.full_like(rank, _I32_MAX)).to(torch.int32)


def string_order_ranks(col: GpuColumnVector,
                       live: torch.Tensor) -> torch.Tensor:
    """The one-column case of ``string_order_ranks_multi``."""
    return string_order_ranks_multi([col], [live])


def nested_cpu_key(v):
    """A Python value's comparable in Spark's order (the reference's
    ``exec/sort.py:72``): null first, NaN largest, ``-0.0 == 0.0``, a
    struct field by field, an array element by element and then by
    length."""
    if v is None:
        return (0,)
    if isinstance(v, dict):
        return (1,) + tuple(nested_cpu_key(x) for x in v.values())
    if isinstance(v, (list, tuple)):
        return (1,) + tuple(nested_cpu_key(x) for x in v)
    if isinstance(v, float):
        return (1, (1, 0.0)) if math.isnan(v) else (1, (0, v + 0.0))
    return (1, (0, v))


def nested_key_ranks(col: GpuColumnVector) -> torch.Tensor:
    """Each row's dense rank (int64) among the column's rows in Spark's
    order, on the host: equal values rank equal, so the ranks sort and
    group as the values do."""
    if col.device.type != "cpu":
        raise NotImplementedError(
            f"a nested key ({col.dtype.simple_string()}) has no device "
            "lane: the planner runs its operator on the CPU")
    from ..columnar.arrow_bridge import column_to_arrow
    keys = [nested_cpu_key(v)
            for v in column_to_arrow(col, 0, col.capacity).to_pylist()]
    rank = {k: i for i, k in enumerate(sorted(set(keys)))}
    return torch.tensor([rank[k] for k in keys], dtype=torch.int64)


def _null_rank_lane(validity, n: int, device, spec: SortSpec) \
        -> Tuple[torch.Tensor, int]:
    """Null placement, independent of direction: a one-bit lane."""
    if validity is None:
        valid = torch.ones(n, dtype=torch.int64, device=device)
    else:
        valid = validity.to(torch.int64)
    return (valid if spec.nulls_first else 1 - valid), 1


def _struct_lanes(col: GpuColumnVector, spec: SortSpec, live: torch.Tensor,
                  outer: Optional[torch.Tensor]) \
        -> List[Tuple[torch.Tensor, int]]:
    """A struct key's lanes in Spark's order: its null lane by ``spec``,
    then each field as a key of its own, a null field first (last when
    descending, the whole comparison reversed); a null struct's field
    lanes are all zero, so null structs tie."""
    valid = col.valid_mask() if outer is None \
        else col.valid_mask() & outer
    out = [_null_rank_lane(valid, valid.shape[0], valid.device, spec)]
    inner = SortSpec(spec.ascending, spec.ascending)
    for ch in col.children:
        if isinstance(ch.dtype, dt.StructType):
            lanes = _struct_lanes(ch, inner, live, valid)
        else:
            field = GpuColumnVector(ch.dtype, ch.data, and_validity(
                ch.validity, valid), ch.offsets, ch.chars, ch.children)
            lanes = _key_lanes([field], [inner], live)[1:]
        out.extend((torch.where(valid, v, torch.zeros_like(v)), w)
                   for v, w in lanes)
    return out


def key_lane_count(col: GpuColumnVector) -> int:
    """The lanes ``_key_lanes`` gives one key: its null lane and its
    value lanes (a struct's for each field, a wide decimal's two)."""
    if isinstance(col.dtype, dt.StructType):
        return 1 + sum(key_lane_count(ch) for ch in col.children)
    return 3 if dt.is_wide_decimal(col.dtype) else 2


def _key_lanes(key_cols: Sequence[GpuColumnVector],
               specs: Sequence[SortSpec],
               live: torch.Tensor) -> List[Tuple[torch.Tensor, int]]:
    """Orderable lanes, most significant first: the live lane (padding
    always last), then per key a null lane and a value lane (a struct
    key a lane set for each field, ``_struct_lanes``)."""
    n = live.shape[0]
    lanes = [((~live).to(torch.int64), 1)]
    for col, spec in zip(key_cols, specs):
        if isinstance(col.dtype, dt.StructType):
            lanes.extend(_struct_lanes(col, spec, live, None))
            continue
        if is_string_like(col.dtype):
            ranked = live if col.validity is None else live & col.validity
            parts = [(string_order_ranks(col, ranked).to(torch.int64),
                      _RANK_BITS)]
        elif dt.is_nested(col.dtype):
            parts = [(nested_key_ranks(col), _RANK_BITS)]
        elif dt.is_wide_decimal(col.dtype):
            hi, lo = orderable_words(col)
            parts = [(unsigned_lane(hi, 64), 64), (unsigned_lane(lo, 64), 64)]
        else:
            parts = [key_lane_bits(col)]
        lanes.append(_null_rank_lane(col.validity, n, live.device, spec))
        for vals, width in parts:
            if col.validity is not None:
                # computed expressions leave garbage under nulls, and
                # null == null must hold for ordering and grouping
                vals = torch.where(col.validity, vals,
                                   torch.zeros_like(vals))
            if not spec.ascending:
                vals = ~vals & _mask(width)
            lanes.append((vals, width))
    return lanes


def change_flags(words: Sequence[torch.Tensor],
                 masks: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Boundaries of sorted words: True at row 0 and where a row's words,
    each under its int64 mask (-1, all bits, by default; 0 skips the
    word), differ from the row before."""
    n = words[0].shape[0]
    flag = torch.zeros(n, dtype=torch.bool, device=words[0].device)
    if n:
        flag[0] = True
    for j, w in enumerate(words):
        m = -1 if masks is None else masks[j]
        if m == 0:
            continue
        d = w[1:] ^ w[:-1]
        if m != -1:
            d = d & m
        flag[1:] |= d != 0
    return flag


def sorted_key_words(key_cols: Sequence[GpuColumnVector],
                     specs: Sequence[SortSpec], live: torch.Tensor) \
        -> Tuple[List[int], List[torch.Tensor], torch.Tensor]:
    """``(lane widths, words in sorted order, perm)``: the keys' lanes
    (``_key_lanes``: the live bit, then a null bit and a value lane a
    key), packed and sorted stably; padding rows last."""
    lanes = _key_lanes(key_cols, specs, live)
    words, perm = sort_packed(pack_words(lanes))
    return [w for _, w in lanes], words, perm


def sort_permutation(key_cols: Sequence[GpuColumnVector],
                     specs: Sequence[SortSpec],
                     live: torch.Tensor) -> torch.Tensor:
    """Stable permutation ordering rows by the keys, padding rows
    last."""
    return sorted_key_words(key_cols, specs, live)[2]


def sorted_segments(key_cols: Sequence[GpuColumnVector],
                    live: torch.Tensor):
    """``(perm, seg, num_groups, sorted_live)``: rows permuted so equal
    keys are adjacent (live rows first), int32 segment ids over the
    sorted order, the device count of live groups, and the live mask in
    sorted order (read off the live bit of the sorted words, no
    gather)."""
    n = live.shape[0]
    widths, words, perm = sorted_key_words(
        key_cols, [SortSpec()] * len(key_cols), live)
    seg = inclusive_int_cumsum(change_flags(words)) - 1
    # the live lane is the top bit of the first word
    sorted_live = (_shr(words[0], min(64, sum(widths)) - 1) & 1) == 0
    num_groups = torch.where(sorted_live, seg + 1,
                             torch.zeros_like(seg)).max() if n else \
        torch.zeros((), dtype=torch.int32, device=live.device)
    return perm, seg, num_groups, sorted_live


def segment_ids_for_keys(key_cols: Sequence[GpuColumnVector],
                         live: torch.Tensor):
    """``(perm, seg_ids_sorted, num_groups)`` with Spark's grouping
    equality: null == null, NaN == NaN, ``-0.0 == 0.0``."""
    perm, seg, num_groups, _ = sorted_segments(key_cols, live)
    return perm, seg, num_groups
