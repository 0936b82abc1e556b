"""Window operator.

Counterpart of ``spark_rapids_tpu/exec/window.py:156-641``
(``TpuWindowExec``, its device pass ``_window_batch``), run eagerly on
tensors: one sorted, segmented pass a window spec.

  1. the rows sort once by (partition keys, order keys) through
     ``ops/sort_keys.sorted_key_words``: **K3** a packed word, a string
     key by its rank (``string_order_ranks``, itself K3 passes), float
     partition keys normalised. The reference sorts its lanes with the
     row index as the last key; K3's LSD radix sort is stable, so the
     order is the same, live rows first;
  2. partition and peer changes are read off the sorted words (the
     partition's bits are a prefix of each row's bit string); segment and
     peer bounds are ``torch.cummax`` and a flipped ``torch.cummin`` of
     the change positions;
  3. the rows, and every window argument that is not already a column,
     move into sorted order in one **K4** launch (``gather_columns``);
  4. a function at a time:
     - ranking (row_number, rank, dense_rank, percent_rank, ntile) is
       index arithmetic over the bounds;
     - lag and lead are clamped gathers (K4, one a function);
     - count, sum and avg over any rows or range frame are a prefix
       difference of one ``cumsum`` over the batch; a Decimal64 sum is
       null past its precision (the reference's ``:505-516``), and a
       decimal sum past 18 digits or a decimal avg (on the host, where
       the planner puts them) sums each 32-bit limb's frame in int64 and
       joins them in Python's integers (``_decimal_frame``);
     - min and max take the frame's lexicographic argmin of (invalid
       flag, orderable value, position), then gather the value there
       (K4): a segmented running scan for frames bounded by a segment or
       peer edge on one side (``_argmin_scan``, a log-depth doubling scan
       where the reference uses ``jax.lax.associative_scan``), and the
       sparse-table range argmin (``_sparse_argmin_query``) for rows
       frames bounded on both sides, its depth capped by the frame's
       width, and for RANGE literal offsets. The reference also has an
       ``(n, width)`` windowed gather for rows frames up to 1024 wide;
       the sparse table answers those frames with the same row (the key
       tuple ends in the position, so the argmin is unique) in memory
       that grows with log2 of the width, not with the width.
     RANGE literal offsets become index bounds by a ``torch.searchsorted``
     over an int64 compound key (``_range_literal_bound``).

``execute`` concatenates the child's batches (``ops/concat.py``) and makes
one pass, inside a ``torch.profiler.record_function("window")`` range,
which ``tools/nds_trace.py`` reads. When the batches hold more than half
the memory manager's budget and the window has partition keys, it runs
out of core instead (``_execute_bucketed``, the reference's
``:620-681``): each row is hashed by its partition keys with Spark's
Murmur3 (``shuffle/partitioner.HashPartitioning``, bit for bit the
reference's) into ``max(2, ceil(total / (budget // 4)))`` buckets, each
bucket's rows of each batch compacted on K4 and downloaded, and each
bucket (whole partitions only) uploaded and windowed alone, in bucket
order; its time is ``spillTime``, its bucket count ``windowBuckets``.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import datatypes as dt
from ..columnar.batch import GpuBatch, row_mask
from ..columnar.column import GpuColumnVector, torch_dtype
from ..ops import decimals as dec
from ..expr.aggregates import (Average, Count, Max, Min, Sum,
                               _CentralMoment, _FirstLast)
from ..expr.base import Alias, BoundReference, Expression, bind_expr
from ..expr.window import (DenseRank, NTile, PercentRank, Rank, RowNumber,
                           WindowExpression, _OffsetFunction)
from ..ops.concat import concat_batches_bounded
from ..ops.gather import gather_column, gather_columns
from ..ops.segments import seg_reduce_sorted
from ..ops.strings import assemble_strings
from ..ops.sort_keys import (SortSpec, change_flags, check_key_type,
                             key_lane_count, normalize_float_key_col,
                             orderable_int,
                             sorted_key_words, string_order_ranks)
from .base import ExecCtx, GpuExec, UnaryExec
from .sort import SortOrder

__all__ = ["GpuWindowExec"]

_I64 = torch.int64
_SENTINEL = (1 << 63) - 1


def _prefix_masks(widths: Sequence[int], prefix: int) -> List[int]:
    """For each word ``pack_words`` makes of lanes of ``widths``, the
    int64 mask of its bits that lie in the first ``prefix`` bits of the
    row's bit string (the last word holds its bits right-aligned)."""
    total = sum(widths)
    n_words = -(-total // 64)
    masks = []
    for j in range(n_words):
        bits = 64 if j < n_words - 1 or total % 64 == 0 else total % 64
        c = max(0, min(prefix - 64 * j, bits))
        m = ((1 << bits) - 1) ^ ((1 << (bits - c)) - 1)
        masks.append(m - (1 << 64) if m >= 1 << 63 else m)
    return masks


def _scan_max(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, 0).values


def _scan_min_rev(x: torch.Tensor) -> torch.Tensor:
    """Running minimum from the end (``cummin(reverse=True)``)."""
    return torch.flip(torch.cummin(torch.flip(x, [0]), 0).values, [0])


def _lex_lt(a, b) -> torch.Tensor:
    """Elementwise lexicographic ``a < b`` over tuples of lanes."""
    lt = torch.zeros(a[0].shape, dtype=torch.bool, device=a[0].device)
    eq = torch.ones(a[0].shape, dtype=torch.bool, device=a[0].device)
    for x, y in zip(a, b):
        lt = lt | (eq & (x < y))
        eq = eq & (x == y)
    return lt


def _lex_select(keys, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Of positions a and b, the one whose key tuple is lexicographically
    smaller (ties keep a)."""
    lt = _lex_lt([k[b] for k in keys], [k[a] for k in keys])
    return torch.where(lt, b, a)


def _argmin_scan(keys, reset: torch.Tensor, reverse: bool = False):
    """Segmented running lexicographic minimum over a tuple of key lanes,
    restarting where ``reset`` is True in scan direction (segment-end
    flags with ``reverse``). The reference's ``associative_scan`` as a
    log-depth doubling scan: ceil(log2 n) steps, each combining position
    i with i - 2^k under the same ``comb`` (the segmented min, whose later
    operand wins where it starts a segment). The first lane is an explicit
    invalid flag (0 = a candidate), so no sentinel meets a real extreme
    value."""
    ks = [torch.flip(k, [0]) for k in keys] if reverse else list(keys)
    f = torch.flip(reset, [0]) if reverse else reset
    n = f.shape[0]
    d = 1
    while d < n:
        ak = [k[:-d] for k in ks]
        bk = [k[d:] for k in ks]
        bf = f[d:]
        take_a = ~bf & _lex_lt(ak, bk)
        ks = [torch.cat([k[:d], torch.where(take_a, x, y)])
              for k, x, y in zip(ks, ak, bk)]
        f = torch.cat([f[:d], f[:-d] | bf])
        d *= 2
    return [torch.flip(k, [0]) for k in ks] if reverse else ks


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """Exact floor(log2 x) of positive integers below 2^53 (``clz`` in
    the reference): ``frexp`` gives x = m 2^e with m in [0.5, 1)."""
    _, e = torch.frexp(x.to(torch.float64))
    return e.to(_I64) - 1


def _sparse_argmin_query(keys, lo, hi, nonempty, cap: int,
                         max_len: Optional[int] = None):
    """Range lexicographic argmin over per-row spans [lo, hi]: doubling
    tables T[k][i] = the position of the minimum of [i, i + 2^k), each
    frame answered by the two power-of-two covers [lo, lo + 2^k) and
    [hi - 2^k + 1, hi] with k = floor(log2(len)). An empty frame gives
    the sentinel in every lane. ``max_len`` (a rows frame's width) caps
    the depth."""
    device = lo.device
    pos0 = torch.arange(cap, dtype=_I64, device=device)
    levels = [pos0]
    K = max(1, (max(cap, 2) - 1).bit_length())
    if max_len is not None:
        K = min(K, max(1, (max(max_len, 2) - 1).bit_length()))
    for k in range(1, K + 1):
        half = 1 << (k - 1)
        prev = levels[-1]
        b = prev[torch.clamp(pos0 + half, 0, cap - 1)]
        levels.append(_lex_select(keys, prev, b))
    flat = torch.stack(levels).reshape(-1)
    length = torch.clamp(hi - lo + 1, min=1)
    k = torch.clamp(_floor_log2(length), 0, K)
    t_lo = flat[k * cap + lo]
    t_hi = flat[k * cap + torch.clamp(hi - (torch.ones_like(k) << k) + 1,
                                      0, cap - 1)]
    win = _lex_select(keys, t_lo, t_hi)
    return [torch.where(nonempty, kl[win], torch.full_like(kl, _SENTINEL))
            for kl in keys]


def _decimal_frame(f, vcol: GpuColumnVector, valid: torch.Tensor,
                   cnt: torch.Tensor, ok: torch.Tensor,
                   prefix_frame) -> GpuColumnVector:
    """A decimal ``SUM`` or ``AVG`` over each row's frame (the
    reference's ``:505-516``). A Decimal64 sum is a prefix difference of
    the int64 lane, null past the result's precision. Past 18 digits
    (on the host, where the planner puts such a window and every decimal
    ``AVG``) each 32-bit limb's frame sum is exact in int64 and the limbs
    join in Python's integers; the average divides ``HALF_UP``."""
    sum_t = f.dtype if isinstance(f, Sum) else f._sum_type
    d = vcol.data
    if not dt.is_wide_decimal(sum_t) and d.dim() == 1 \
            and isinstance(f, Sum):
        s = prefix_frame(torch.where(valid, d, torch.zeros_like(d)))
        return GpuColumnVector(sum_t, s, ok & dec.fits(s, sum_t.precision))
    total = dec.join_limbs([
        prefix_frame(torch.where(valid, limb, torch.zeros_like(limb)))
        for limb in dec.limbs(d)])
    keep = ok.cpu().numpy() & dec.fits_ints(total, sum_t.precision)
    sums = dec.column_from_ints(sum_t, total, keep, vcol.device)
    if isinstance(f, Sum):
        return sums
    from ..expr.aggregates import _decimal_average
    return _decimal_average(f.dtype, sums, cnt, sums.valid_mask())


def _host_range_bound(ok_col: GpuColumnVector, perm: torch.Tensor,
                      sorted_live: torch.Tensor, seg_start: torch.Tensor,
                      seg_end: torch.Tensor, peer_start: torch.Tensor,
                      peer_end: torch.Tensor, order: SortOrder, delta: int,
                      side: str) -> torch.Tensor:
    """RANGE <delta> PRECEDING/FOLLOWING over the first order key of any
    type and direction, on the host (the reference's CPU path,
    ``:740-791``): the target is the row's value plus ``delta`` against
    the direction (in float64 for a float key, exact for an integer one),
    and the bound a ``numpy.searchsorted`` over the partition's non-null
    values, one call a partition and side. A null row takes its peer
    bounds. Float keys follow Spark's order: NaN is the greatest value
    and equals NaN."""
    cap = perm.shape[0]
    live = sorted_live.numpy()
    valid = ok_col.valid_mask()[perm.long()].numpy() & live
    raw = ok_col.data[perm.long()].numpy()
    floating = dt.is_floating(ok_col.dtype)
    vals = raw.astype(np.float64) if floating else raw.astype(np.int64)
    # the target a row's frame reaches, against the sort's direction
    step = delta if order.ascending else -delta
    if floating:
        target = vals + float(step)
    else:
        # saturate instead of wrapping: past the range nothing lies
        info = np.iinfo(np.int64)
        target = np.where(
            (step > 0) & (vals > info.max - step), info.max,
            np.where((step < 0) & (vals < info.min - step), info.min,
                     vals + step))
    s_np, e_np = seg_start.numpy(), seg_end.numpy()
    out = (peer_start if side == "lo" else peer_end).numpy().copy()
    for s0 in np.unique(s_np[live]):
        s0 = int(s0)
        e0 = int(e_np[s0])
        rows = np.arange(s0, e0 + 1)
        rows = rows[valid[s0:e0 + 1]]
        if not len(rows):
            continue
        v = vals[rows]
        t = target[rows]
        if order.ascending:
            idx = np.searchsorted(v, t, side="left" if side == "lo"
                                  else "right")
            b = idx if side == "lo" else idx - 1
        else:
            # descending: search the reversed (ascending) values
            rv = v[::-1]
            idx = np.searchsorted(rv, t, side="right" if side == "lo"
                                  else "left")
            b = len(v) - idx if side == "lo" else len(v) - 1 - idx
        # past either end of the non-null run: an empty side
        pos = np.where(b < 0, rows[0] - 1,
                       np.where(b >= len(rows), rows[-1] + 1,
                                rows[np.clip(b, 0, len(rows) - 1)]))
        out[rows] = pos
    return torch.from_numpy(out).to(torch.int64).clamp(-1, cap)


def _string_default(out: GpuColumnVector, ok: torch.Tensor,
                    sorted_live: torch.Tensor,
                    default: Optional[bytes]) -> GpuColumnVector:
    """A string lag/lead: the gathered value where the offset row
    exists, else the default string (null for a NULL default): the
    default's bytes appended to the chars once, and each row's start
    and length taken from one or the other."""
    starts, lengths = out.offsets[:-1], out.offsets[1:] - out.offsets[:-1]
    raw = default or b""
    base = out.chars.shape[0]
    chars = torch.cat([out.chars, torch.frombuffer(
        bytearray(raw), dtype=torch.uint8) if raw
        else torch.zeros(0, dtype=torch.uint8)])
    use_default = sorted_live & ~ok
    starts = torch.where(use_default, torch.full_like(starts, base), starts)
    lengths = torch.where(use_default,
                          torch.full_like(lengths, len(raw)), lengths)
    lengths = torch.where(sorted_live, lengths, torch.zeros_like(lengths))
    valid = out.valid_mask() & ok
    if default is not None:
        valid = valid | use_default
    src = GpuColumnVector(out.dtype, None, None, None, chars)
    return assemble_strings(src, starts.to(torch.int32),
                            lengths.to(torch.int32), valid,
                            int(lengths.sum()))


# a rows frame bounded on both sides up to this width takes its moments
# by the exact two-pass sum over its rows
_EXACT_FRAME_ROWS = 64
_EPS = 2.0 ** -53


def _segmented_cumsum(x: torch.Tensor, seg_start: torch.Tensor,
                      pos: torch.Tensor) -> torch.Tensor:
    """Inclusive running sums that restart at each partition (a
    Hillis-Steele doubling scan): no earlier partition's values enter a
    sum, and each sum is rounded at most ceil(log2 n) times."""
    out = x
    d = 1
    n = x.shape[0]
    while d < n:
        prev = torch.cat([torch.zeros(d, dtype=x.dtype, device=x.device),
                          out[:-d]])
        out = out + torch.where(pos - d >= seg_start, prev,
                                torch.zeros_like(prev))
        d *= 2
    return out


def _frame_moment(dev: torch.Tensor, ok: torch.Tensor, fr, lo, hi,
                  seg_start, pos, cap: int):
    """``(count, m2)`` of each row's frame over the values ``dev``
    (already centered by the partition's mean) where ``ok``. A rows
    frame bounded on both sides and at most ``_EXACT_FRAME_ROWS`` wide
    takes the two-pass sum over its rows (the reference's group-by form:
    relative error a few ulps times the width). Any other frame takes
    segmented running sums of d and d^2 (``_segmented_cumsum``) and
    ``m2 = S2 - S^2 / n``, whose absolute error is at most about
    (2 ceil(log2 n) + 4) eps times the partition's sum of d^2 up to the
    frame's end."""
    zero = torch.zeros((), dtype=torch.float64, device=dev.device)
    d = torch.where(ok, dev, zero)
    if fr.frame_type == "rows" and fr.lower is not None \
            and fr.upper is not None \
            and fr.upper - fr.lower + 1 <= _EXACT_FRAME_ROWS:
        shifts = []
        for k in range(fr.lower, fr.upper + 1):
            j = pos + k
            jc = j.clamp(0, cap - 1)
            shifts.append(((j >= lo) & (j <= hi) & ok[jc], jc))
        n = sum(m.to(torch.float64) for m, _ in shifts)
        s = sum(torch.where(m, d[jc], zero) for m, jc in shifts)
        mean = s / torch.where(n > 0, n, torch.ones_like(n))
        m2 = sum(torch.where(m, (d[jc] - mean) ** 2, zero)
                 for m, jc in shifts)
        return n, m2
    hic = hi.clamp(0, cap - 1)
    before = (lo - 1).clamp(0, cap - 1)
    has_before = lo > seg_start

    def frame_sum(v):
        c = _segmented_cumsum(v, seg_start, pos)
        return c[hic] - torch.where(has_before, c[before], zero)
    n = frame_sum(ok.to(torch.float64))
    s = frame_sum(d)
    m2 = frame_sum(d * d) - s * s / torch.where(n > 0, n,
                                                 torch.ones_like(n))
    return n, m2.clamp(min=0.0)


class GpuWindowExec(UnaryExec):
    """Computes the window expressions of one partition and order spec;
    output = the child's columns (in sorted order) + one column a window
    expression."""

    def __init__(self, window_exprs: Sequence[Expression], child: GpuExec):
        super().__init__(child)
        self.win_exprs: List[WindowExpression] = []
        self.win_names: List[str] = []
        for e in window_exprs:
            bound = bind_expr(e, child.output_schema)
            if isinstance(bound, Alias):
                name, we = bound.name, bound.child
            else:
                we, name = bound, None
            if not isinstance(we, WindowExpression):
                raise TypeError(f"not a window expression: {e!r}")
            if name is None:
                name = we.func.pretty_name().lower()
            self.win_exprs.append(we)
            self.win_names.append(name)
        if not self.win_exprs:
            raise ValueError("window exec needs at least one expression")
        sig = self.win_exprs[0].spec_signature()
        for we in self.win_exprs[1:]:
            if we.spec_signature() != sig:
                raise ValueError(
                    "one GpuWindowExec handles one window spec; plan one "
                    f"exec a spec ({sig!r} vs {we.spec_signature()!r})")
        self.part_exprs = list(self.win_exprs[0].partition_by)
        self.orders: List[SortOrder] = self.win_exprs[0].order_by
        for e in self.part_exprs + [o.child for o in self.orders]:
            check_key_type(e.dtype)
        wfields = [dt.StructField(n, we.dtype, we.nullable)
                   for we, n in zip(self.win_exprs, self.win_names)]
        self._schema = dt.Schema(list(child.output_schema.fields) + wfields)
        # the arguments gathered into sorted order beside the rows: each
        # distinct expression that is not a plain column, once
        self._args: List[Expression] = list({
            repr(a): a for we in self.win_exprs
            for a in self._arg_exprs(we.func)
            if not isinstance(a, BoundReference)}.values())

    @staticmethod
    def _arg_exprs(f: Expression) -> List[Expression]:
        if isinstance(f, _OffsetFunction):
            return [f.child]
        if isinstance(f, (Count, Sum, Average, Min, Max, _FirstLast,
                          _CentralMoment)):
            return list(f.children)
        return []

    @property
    def output_schema(self):
        return self._schema

    def expected_output_schema(self):
        wfields = [dt.StructField(n, we.dtype, we.nullable)
                   for we, n in zip(self.win_exprs, self.win_names)]
        return dt.Schema(list(self.child.output_schema.fields) + wfields)

    def describe(self):
        ws = "; ".join(f"{we!r} AS {n}"
                       for we, n in zip(self.win_exprs, self.win_names))
        return f"WindowExec [{ws}]"

    def expressions(self):
        return list(self.win_exprs)

    # --- the device pass -------------------------------------------------

    def _window_batch(self, batch: GpuBatch, ectx) -> GpuBatch:
        live = batch.live_mask()
        cap = batch.capacity
        device = batch.device
        n_live = batch.row_count if batch.selection is None \
            else int(live.sum())
        pkeys = [normalize_float_key_col(e.eval_gpu(batch, ectx))
                 for e in self.part_exprs]
        okeys = [o.child.eval_gpu(batch, ectx) for o in self.orders]
        specs = [SortSpec()] * len(pkeys) + [o.spec for o in self.orders]
        widths, words, perm = sorted_key_words(pkeys + okeys, specs, live)
        # the live lane and each partition key's (null, value...) lanes
        npl = 1 + sum(key_lane_count(k) for k in pkeys)
        part_flag = change_flags(words,
                                 _prefix_masks(widths, sum(widths[:npl])))
        peer_flag = change_flags(words) \
            if len(widths) > npl else part_flag
        end_flag = torch.cat([part_flag[1:],
                              torch.ones(1, dtype=torch.bool,
                                         device=device)])
        sorted_live = row_mask(cap, n_live, device)
        pos = torch.arange(cap, dtype=_I64, device=device)
        capv = torch.full((1,), cap, dtype=_I64, device=device)
        seg_start = _scan_max(torch.where(part_flag, pos, -1))
        seg_end = torch.cat([_scan_min_rev(
            torch.where(part_flag, pos, cap))[1:], capv]) - 1
        peer_start = _scan_max(torch.where(peer_flag, pos, -1))
        peer_end = torch.cat([_scan_min_rev(
            torch.where(peer_flag, pos, cap))[1:], capv]) - 1
        seg_rows = seg_end - seg_start + 1

        # the rows and the computed arguments in sorted order: one K4
        args = [a.eval_gpu(batch, ectx) for a in self._args]
        moved = gather_columns(list(batch.columns) + args, perm,
                               sorted_live)
        ncols = len(batch.columns)
        sorted_cols = moved[:ncols]
        sorted_args = {repr(a): c for a, c in zip(self._args,
                                                  moved[ncols:])}

        def sgather(expr: Expression) -> GpuColumnVector:
            if isinstance(expr, BoundReference):
                return sorted_cols[expr.ordinal]
            return sorted_args[repr(expr)]

        def valid_of(col: GpuColumnVector) -> torch.Tensor:
            return col.valid_mask() & sorted_live

        def range_literal_bound(delta: int, side: str) -> torch.Tensor:
            """Frame bound for RANGE <delta> PRECEDING/FOLLOWING: a
            searchsorted over the compound key (segment << 33 | region
            << 32 | orderable 32-bit value), ascending over the live rows
            by construction, padded with INT64_MAX past them. NULL order
            values form their own band where the sort put them, and a
            null row takes its peer bounds (Spark: a null row's frame is
            the null rows). Any other order key runs on the host
            (``_host_range_bound``)."""
            ok_col = okeys[0]
            t = ok_col.dtype
            if len(okeys) != 1 or not self.orders[0].ascending \
                    or t.np_dtype is None \
                    or np.dtype(t.np_dtype).itemsize > 4 \
                    or dt.is_floating(t):
                if ectx.host:
                    return _host_range_bound(
                        ok_col, perm, sorted_live, seg_start, seg_end,
                        peer_start, peer_end, self.orders[0], delta, side)
                raise NotImplementedError(
                    "RANGE literal offsets need one ascending integer or "
                    "date order key of at most 32 bits on the device; "
                    "others run on the CPU, where the planner places "
                    "them")
            permi = perm.long()
            sval = ok_col.data[permi]
            snull = ~ok_col.valid_mask()[permi]
            lane_t = sval.dtype
            bias = 1 << 31

            def enc32(vals):
                return orderable_int(GpuColumnVector(t, vals)).to(_I64) \
                    + bias
            val_region = 1 if self.orders[0].nulls_first else 0
            region = snull.to(_I64) ^ val_region
            base = seg_start << 33
            comp = torch.where(sorted_live, base + (region << 32)
                               + enc32(sval),
                               torch.full_like(base, _SENTINEL))
            # saturating offset arithmetic in the key's type
            info = torch.iinfo(lane_t)
            tv = torch.clamp(sval.to(_I64) + int(delta), info.min,
                             info.max).to(lane_t)
            q = base + (val_region << 32) + enc32(tv)
            if side == "lo":
                b = torch.searchsorted(comp, q, right=False)
                return torch.where(snull, peer_start, b)
            b = torch.searchsorted(comp, q, right=True) - 1
            return torch.where(snull, peer_end, b)

        def frame_bounds(fr):
            if fr.frame_type == "rows":
                lo = seg_start if fr.lower is None \
                    else torch.maximum(seg_start, pos + fr.lower)
                hi = seg_end if fr.upper is None \
                    else torch.minimum(seg_end, pos + fr.upper)
            else:  # range: value offsets (0 = the peer group)
                lo = (seg_start if fr.lower is None else
                      peer_start if fr.lower == 0 else
                      torch.maximum(seg_start,
                                    range_literal_bound(fr.lower, "lo")))
                hi = (seg_end if fr.upper is None else
                      peer_end if fr.upper == 0 else
                      torch.minimum(seg_end,
                                    range_literal_bound(fr.upper, "hi")))
            return lo, hi

        def prefix_frame(contrib, lo, hi, empty):
            """Frame totals by inclusive prefix difference, valid for any
            [lo, hi] inside one segment."""
            loc = torch.clamp(lo, 0, cap - 1)
            hic = torch.clamp(hi, 0, cap - 1)
            p = torch.cumsum(contrib, 0)
            total = p[hic] - p[loc] + contrib[loc]
            return torch.where(empty, torch.zeros_like(total), total)

        def argmin_frame(keys, fr, lo, hi):
            """Every key lane's value at each row's frame minimum,
            lexicographic over ``keys`` (first lane the invalid flag, last
            the position)."""
            loc = torch.clamp(lo, 0, cap - 1)
            hic = torch.clamp(hi, 0, cap - 1)
            if fr.frame_type == "range":
                if fr.lower is None:  # [seg_start, hi]
                    return [r[hic] for r in _argmin_scan(keys, part_flag)]
                if fr.upper is None:  # [lo, seg_end]
                    return [r[loc] for r in
                            _argmin_scan(keys, end_flag, reverse=True)]
                if fr.lower == 0 and fr.upper == 0:  # the peer group
                    return [r[hic] for r in _argmin_scan(keys, peer_flag)]
                return _sparse_argmin_query(keys, loc, hic, hi >= lo, cap)
            if fr.lower is None:
                return [r[hic] for r in _argmin_scan(keys, part_flag)]
            if fr.upper is None:
                return [r[loc] for r in
                        _argmin_scan(keys, end_flag, reverse=True)]
            return _sparse_argmin_query(keys, loc, hic, hi >= lo, cap,
                                        max_len=fr.upper - fr.lower + 1)

        def int32_col(data):
            return GpuColumnVector(dt.INT32, data.to(torch.int32),
                                   sorted_live)

        win_cols: List[GpuColumnVector] = []
        for we in self.win_exprs:
            f = we.func
            fr = we.frame
            if isinstance(f, RowNumber):
                win_cols.append(int32_col(pos - seg_start + 1))
                continue
            if isinstance(f, Rank):
                win_cols.append(int32_col(peer_start - seg_start + 1))
                continue
            if isinstance(f, DenseRank):
                peer_ord = torch.cumsum(peer_flag.to(_I64), 0)
                win_cols.append(int32_col(
                    peer_ord - peer_ord[torch.clamp(seg_start, 0, cap - 1)]
                    + 1))
                continue
            if isinstance(f, PercentRank):
                rank = (peer_start - seg_start).to(torch.float64)
                den = torch.clamp(seg_rows - 1, min=1).to(torch.float64)
                pr = torch.where(seg_rows > 1, rank / den,
                                 torch.zeros_like(rank))
                win_cols.append(GpuColumnVector(dt.FLOAT64, pr,
                                                sorted_live))
                continue
            if isinstance(f, NTile):
                n = f.buckets
                r = pos - seg_start
                q = seg_rows // n
                rem = seg_rows % n
                thr = rem * (q + 1)
                qd = torch.clamp(q, min=1)
                bucket = torch.where(
                    r < thr, r // torch.clamp(q + 1, min=1),
                    torch.where(q > 0, rem + (r - thr) // qd, r))
                win_cols.append(int32_col(bucket + 1))
                continue
            if isinstance(f, _OffsetFunction):
                scol = sgather(f.child)
                src = pos + f.direction * f.offset
                ok = (src >= seg_start) & (src <= seg_end) & sorted_live
                out = gather_column(scol, torch.clamp(src, 0, cap - 1), ok)
                if f.default is not None and out.is_string_like:
                    if not ectx.host:
                        raise NotImplementedError(
                            "a string lag/lead default runs on the CPU, "
                            "where the planner places it")
                    out = _string_default(out, ok, sorted_live,
                                          f.default.string_bytes)
                elif f.default is not None:
                    dcol = f.default.eval_gpu(batch, ectx)
                    out = GpuColumnVector(
                        out.dtype, torch.where(ok, out.data, dcol.data),
                        torch.where(ok, out.valid_mask(),
                                    dcol.valid_mask() & sorted_live))
                win_cols.append(out)
                continue
            # --- aggregates over the frame ---------------------------------
            lo, hi = frame_bounds(fr)
            empty = (lo > hi) | ~sorted_live
            if isinstance(f, Count):
                if f.children:
                    contrib = valid_of(sgather(f.children[0])).to(_I64)
                else:
                    contrib = sorted_live.to(_I64)
                win_cols.append(GpuColumnVector(
                    dt.INT64, prefix_frame(contrib, lo, hi, empty),
                    sorted_live))
                continue
            if isinstance(f, (Sum, Average)):
                vcol = sgather(f.children[0])
                valid = valid_of(vcol)
                if dt.is_floating(f.children[0].dtype):
                    # NaN and inf poison a prefix difference: scan the
                    # finite part and exact counts of the specials, and
                    # rebuild the IEEE result a frame (any NaN, or both
                    # infinities, is NaN; else +-inf)
                    d = vcol.data.to(torch.float64)
                    nan_c = prefix_frame((torch.isnan(d) & valid).to(_I64),
                                         lo, hi, empty)
                    pinf_c = prefix_frame(((d == float("inf")) & valid)
                                          .to(_I64), lo, hi, empty)
                    ninf_c = prefix_frame(((d == float("-inf")) & valid)
                                          .to(_I64), lo, hi, empty)
                    fin = torch.where(valid & torch.isfinite(d), d,
                                      torch.zeros_like(d))
                    s = prefix_frame(fin, lo, hi, empty)
                    s = torch.where(
                        (nan_c > 0) | ((pinf_c > 0) & (ninf_c > 0)),
                        torch.full_like(s, float("nan")),
                        torch.where(pinf_c > 0,
                                    torch.full_like(s, float("inf")),
                                    torch.where(ninf_c > 0,
                                                torch.full_like(
                                                    s, float("-inf")), s)))
                elif isinstance(f.children[0].dtype, dt.DecimalType):
                    cnt = prefix_frame(valid.to(_I64), lo, hi, empty)
                    ok = (cnt > 0) & ~empty & sorted_live
                    win_cols.append(_decimal_frame(
                        f, vcol, valid, cnt, ok,
                        lambda v: prefix_frame(v, lo, hi, empty)))
                    continue
                else:
                    # int64 wrap-around addition is associative and
                    # invertible: prefix differences stay exact through
                    # overflow (Java long semantics)
                    contrib = torch.where(valid, vcol.data.to(_I64),
                                          torch.zeros((), dtype=_I64,
                                                      device=device))
                    s = prefix_frame(contrib, lo, hi, empty)
                    if isinstance(f, Average):
                        s = s.to(torch.float64)
                cnt = prefix_frame(valid.to(_I64), lo, hi, empty)
                ok = (cnt > 0) & ~empty & sorted_live
                if isinstance(f, Sum):
                    win_cols.append(GpuColumnVector(
                        f.dtype, s.to(torch_dtype(f.dtype)), ok))
                else:
                    den = torch.where(cnt > 0, cnt, torch.ones_like(cnt)) \
                        .to(torch.float64)
                    win_cols.append(GpuColumnVector(dt.FLOAT64, s / den,
                                                    ok))
                continue
            if isinstance(f, (Min, Max)):
                vcol = sgather(f.children[0])
                valid = valid_of(vcol)
                if vcol.is_string_like:
                    lane = string_order_ranks(vcol, valid).to(_I64)
                else:
                    lane = orderable_int(GpuColumnVector(vcol.dtype,
                                                         vcol.data)).to(_I64)
                if isinstance(f, Max):
                    lane = ~lane
                inv, _, bt = argmin_frame(
                    [(~valid).to(_I64), lane, pos], fr, lo, hi)
                found = (inv == 0) & ~empty & sorted_live
                win_cols.append(gather_column(
                    vcol, torch.clamp(bt, 0, cap - 1), found))
                continue
            if isinstance(f, _FirstLast):
                vcol = sgather(f.children[0])
                if f.ignore_nulls:
                    # the frame's first (last) valid position: the
                    # lexicographic minimum of (invalid, +-position)
                    tb = -pos if f.take_last else pos
                    inv, bt = argmin_frame(
                        [(~valid_of(vcol)).to(_I64), tb], fr, lo, hi)
                    at = -bt if f.take_last else bt
                    ok = (inv == 0) & ~empty & sorted_live
                else:
                    at = hi if f.take_last else lo
                    ok = ~empty & sorted_live
                win_cols.append(gather_column(
                    vcol, torch.clamp(at, 0, cap - 1), ok))
                continue
            if isinstance(f, _CentralMoment):
                vcol = sgather(f.children[0])
                valid = valid_of(vcol)
                x = dec.as_double(vcol)
                finite = torch.isfinite(x)
                # center by the partition's mean (a shift leaves a
                # variance as it is and keeps the squares small)
                zero = torch.zeros((), dtype=torch.float64, device=device)
                seg_ix = torch.cumsum(part_flag.to(_I64), 0) - 1
                fin = torch.where(valid & finite, x, zero)
                seg_n = seg_reduce_sorted((valid & finite).to(
                    torch.float64), seg_ix, cap, "sum")
                seg_s = seg_reduce_sorted(fin, seg_ix, cap, "sum")
                mu = (seg_s / torch.where(seg_n > 0, seg_n,
                                          torch.ones_like(seg_n)))[seg_ix]
                dev_ok = valid & finite
                _, m2 = _frame_moment(fin - mu, dev_ok, fr, lo, hi,
                                      seg_start, pos, cap)
                # a frame of one value has m2 exactly 0: its lowest and
                # highest value agree
                lane = orderable_int(GpuColumnVector(dt.FLOAT64, fin)) \
                    .to(_I64)
                inv = (~dev_ok).to(_I64)
                lo_v = argmin_frame([inv, lane, pos], fr, lo, hi)[1]
                hi_v = argmin_frame([inv, ~lane, pos], fr, lo, hi)[1]
                m2 = torch.where(lo_v == ~hi_v, torch.zeros_like(m2), m2)
                # a non-finite value makes its frames NaN
                bad = prefix_frame((valid & ~finite).to(_I64), lo, hi,
                                   empty)
                cnt = prefix_frame(valid.to(_I64), lo, hi, empty) \
                    .to(torch.float64)
                outv, defined = f.finish(cnt, m2)
                outv = torch.where(bad > 0, torch.full_like(outv,
                                                            float("nan")),
                                   outv)
                win_cols.append(GpuColumnVector(
                    dt.FLOAT64, outv, defined & ~empty & sorted_live))
                continue
            raise NotImplementedError(
                f"window function {f!r} is not ported yet (ROADMAP item "
                "2)")  # the planner's gate refuses it first

        return GpuBatch(sorted_cols + win_cols, self._schema, n_live)

    def execute(self, ctx: ExecCtx):
        batches = list(self.child.execute(ctx))
        if not batches:
            return
        total = sum(b.device_size_bytes() for b in batches)
        if self.part_exprs and len(batches) > 1 \
                and total > ctx.mm.budget // 2:
            # halving a batch at its midpoint would cut partitions:
            # bucket whole partitions instead
            yield from self._execute_bucketed(batches, total, ctx)
            return
        op_time = ctx.metric(self, "opTime")
        t0 = time.perf_counter()
        with torch.profiler.record_function("window"):
            out = self._window_batch(concat_batches_bounded(batches),
                                     ctx.eval_ctx)
        op_time.value += time.perf_counter() - t0
        yield out

    def _execute_bucketed(self, batches: List[GpuBatch], total: int,
                          ctx: ExecCtx):
        """The out-of-core window (module docstring)."""
        import math
        from ..columnar.arrow_bridge import arrow_to_device, device_to_arrow
        from ..ops.gather import compact_batch
        from ..shuffle.partitioner import HashPartitioning
        spill = ctx.metric(self, "spillTime")
        k = max(2, math.ceil(total / max(1, ctx.mm.budget // 4)))
        ctx.metric(self, "windowBuckets").set(k)
        part = HashPartitioning(self.part_exprs, k)  # bound already
        hosts: List[List] = [[] for _ in range(k)]
        t0 = time.perf_counter()
        while batches:
            b = batches.pop(0)
            pids = part.partition_ids(b, ctx.eval_ctx)
            for p in range(k):
                piece = compact_batch(b, pids == p)
                if piece.row_count:
                    hosts[p].append(device_to_arrow(piece))
            del b, pids
        spill.value += time.perf_counter() - t0
        schema = self.child.output_schema
        for p in range(k):
            if not hosts[p]:
                continue
            t0 = time.perf_counter()
            parts = [arrow_to_device(rb, schema, ctx.device)
                     for rb in hosts[p]]
            hosts[p] = []
            with torch.profiler.record_function("window"):
                out = self._window_batch(concat_batches_bounded(parts),
                                         ctx.eval_ctx)
            del parts
            spill.value += time.perf_counter() - t0
            yield out
