"""Equi-join kernels: the staged join and the unique-build fast path.

Counterpart of ``spark_rapids_tpu/ops/join.py``. SQL semantics: a row
with a null key never matches (outer and anti sides still emit it); NaN
== NaN and ``-0.0 == 0.0`` for keys (Spark's normalisation).

**The staged join** (``:1-20,45-222,330-409``) sizes its output from the
data: both sides' keys become dense group ids shared across the sides
(``union_group_ids``: one sort over both sides' capacities of a live
bit and, a key, a validity bit and the key's lane, packed into words for
**K3**; a string key's lane is its rank over both sides,
``sort_keys.string_order_ranks_multi``), the build rows are ordered by
group (``perm_r``, K3's stable sort of the group ids alone), and each
stream row's matches are a run of that order found from per-group counts
and offsets (``join_counts``). ``join_total`` and ``join_output_bytes``
(int64) size the output, which the operator reads back once a stream
batch; ``join_indices`` builds every output row's source rows and
``join_gather`` moves both sides with one **K4** launch each. The group
ids go back to row order by one scatter (``index_put_``) where the
reference sorts a second time, and the counts are scatter-adds: the port
may use Hopper's forms where the results match.

**The fast path** (``:224-327``) serves a build side whose keys are
unique with no size readback a stream batch: a single fixed-width build
key is presorted once a build by K3 (``unique_build_probe``) and every
stream batch finds its match by binary search (``probe_unique``), a
reusable sorted array in place of a hash table; several keys or a string
key take ``unique_union_lookup``, the group ids with at most one build
row a group.

**The cross join** (``join_counts(..., cross=True)``, the reference's
``cross`` mode) matches every live stream row with every live build row.
It needs no group ids and no scatter into a shared slot: each live
stream row has ``live_r.sum()`` matches, every live build row is matched
when any stream row is live, and the build order (live rows first, in
position order) comes from the live mask's running count. The
nested-loop join's matched masks come from the pairs' layout
(``pair_matched_stream``, ``pair_matched_build``). ``join_total``,
``join_output_bytes`` and ``join_indices`` carry every type's math,
right and full outer included; the operator ORs the build's matched mask
across stream batches (``exec/joins.py``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import dataclasses

import torch

from ..columnar.batch import GpuBatch
from ..columnar.column import GpuColumnVector
from . import cuda_kernels as ck
from .gather import exclusive_cumsum, gather_columns, inclusive_int_cumsum
from .segments import seg_reduce_sorted
from .sort_keys import (change_flags, key_lane_bits, key_lane_width,
                        normalize_float_key_col, orderable_int, pack_words,
                        sort_packed, sorted_segments,
                        string_order_ranks_multi, unsigned_lane)

__all__ = ["JOIN_TYPES", "union_group_ids", "JoinPlanA",
           "join_counts", "join_total", "join_output_bytes",
           "join_indices", "join_gather", "pair_matched_stream",
           "pair_matched_build", "unique_build_analysis",
           "unique_build_probe", "build_dup_flag", "probe_unique",
           "unique_union_lookup"]

JOIN_TYPES = ("inner", "left_outer", "right_outer", "full_outer",
              "left_semi", "left_anti", "cross")

_norm_key_col = normalize_float_key_col


def _any_null_key(keys: Sequence[GpuColumnVector], cap: int,
                  device) -> torch.Tensor:
    bad = torch.zeros(cap, dtype=torch.bool, device=device)
    for k in keys:
        if k.validity is not None:
            bad |= ~k.validity
    return bad


def union_group_ids(left_keys: Sequence[GpuColumnVector],
                    right_keys: Sequence[GpuColumnVector],
                    live_l: torch.Tensor, live_r: torch.Tensor) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense int32 group ids shared across the sides: ``g_l[i] ==
    g_r[j]`` iff the rows are equally live and their key tuples equal
    (null == null at this layer; the callers keep null keys from
    matching). The ids are the ranks of the sorted lanes, the
    reference's (``:45``): dead rows and nulls keep their place in the
    order."""
    nl, nr = live_l.shape[0], live_r.shape[0]
    live = torch.cat([live_l, live_r])
    lanes = [((~live).to(torch.int64), 1)]
    for lk, rk in zip(left_keys, right_keys):
        lk, rk = _norm_key_col(lk), _norm_key_col(rk)
        valid = torch.cat([lk.valid_mask(), rk.valid_mask()])
        lanes.append((valid.to(torch.int64), 1))
        if lk.is_string_like:
            vals = string_order_ranks_multi(
                [lk, rk], [live_l & lk.valid_mask(),
                           live_r & rk.valid_mask()]).to(torch.int64)
            width = key_lane_width(lk)
        else:
            (vl, width), (vr, _) = key_lane_bits(lk), key_lane_bits(rk)
            vals = torch.where(valid, torch.cat([vl, vr]),
                               torch.zeros((), dtype=torch.int64,
                                           device=valid.device))
        lanes.append((vals, width))
    words, perm = sort_packed(pack_words(lanes))
    seg = inclusive_int_cumsum(change_flags(words)) - 1
    g = torch.empty_like(seg)
    g[perm.long()] = seg
    return g[:nl], g[nl:]


@dataclasses.dataclass
class JoinPlanA:
    """Stage A's results (the reference's ``:97``), device tensors."""
    g_l: torch.Tensor          # stream rows' group ids
    g_r: torch.Tensor          # build rows' group ids
    matches: torch.Tensor      # a stream row's build matches (0: none)
    starts_g: torch.Tensor     # a group's first position in perm_r
    perm_r: torch.Tensor       # build rows by (group, position)
    eligible_l: torch.Tensor   # live, no null key
    eligible_r: torch.Tensor
    matched_r: torch.Tensor    # build rows with a stream match
    live_l: torch.Tensor
    live_r: torch.Tensor
    times_r: torch.Tensor      # a build row's stream matches


def _group_counts(eligible: torch.Tensor, g: torch.Tensor,
                  gcap: int) -> torch.Tensor:
    """int32 eligible rows a group id (``gcap`` ids)."""
    idx = torch.where(eligible, g, torch.full_like(g, gcap - 1)).long()
    return torch.zeros(gcap, dtype=torch.int32, device=g.device) \
        .index_add_(0, idx, eligible.to(torch.int32))


def _build_order(g_r: torch.Tensor, eligible_r: torch.Tensor, gcap: int):
    """``(perm_r, counts, starts_g)``: the build rows by group (K3's
    stable sort of the ids, ineligible rows last), each group's eligible
    rows and its first position in that order."""
    g_r_sort = torch.where(eligible_r, g_r, torch.full_like(g_r, gcap))
    _, perm_r = ck.sort_pairs(g_r_sort.to(torch.int64))
    counts = _group_counts(eligible_r, g_r, gcap)
    return perm_r, counts, exclusive_cumsum(counts)


def _live_first_order(live: torch.Tensor) -> torch.Tensor:
    """int32 permutation of the rows, the live ones first and each part
    in position order (a stable partition by the live bit): each row's
    place from the running counts, then one scatter onto distinct
    places."""
    n = live.shape[0]
    live_pos = inclusive_int_cumsum(live) - 1
    dead_pos = inclusive_int_cumsum(~live) - 1 + live.sum(dtype=torch.int32)
    place = torch.where(live, live_pos, dead_pos).long()
    perm = torch.empty(n, dtype=torch.int32, device=live.device)
    perm[place] = torch.arange(n, dtype=torch.int32, device=live.device)
    return perm


def _cross_counts(live_l: torch.Tensor, live_r: torch.Tensor) -> JoinPlanA:
    """Stage A of a cross join (the reference's ``cross=True``): one
    group, every live row eligible. The arrays equal the reference's."""
    nl, nr = live_l.shape[0], live_r.shape[0]
    dev = live_l.device
    n_l = live_l.sum(dtype=torch.int32)
    n_r = live_r.sum(dtype=torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    # group 0 starts at 0; every later group (empty) after the n_r rows
    starts_g = torch.where(torch.arange(nl + nr, device=dev) > 0, n_r, zero)
    return JoinPlanA(
        g_l=torch.zeros(nl, dtype=torch.int32, device=dev),
        g_r=torch.zeros(nr, dtype=torch.int32, device=dev),
        matches=torch.where(live_l, n_r, zero), starts_g=starts_g,
        perm_r=_live_first_order(live_r), eligible_l=live_l,
        eligible_r=live_r, matched_r=live_r & (n_l > 0), live_l=live_l,
        live_r=live_r, times_r=torch.where(live_r, n_l, zero))


def join_counts(left_keys: Sequence[GpuColumnVector],
                right_keys: Sequence[GpuColumnVector],
                live_l: torch.Tensor, live_r: torch.Tensor,
                cross: bool = False) -> JoinPlanA:
    """Stage A (``:130``): the shared group ids, the build rows ordered
    by group (K3's stable sort of the ids, ineligible rows last) and the
    per-row match counts of both sides; with ``cross``, every live pair
    matches (``_cross_counts``, no keys read)."""
    if cross:
        return _cross_counts(live_l, live_r)
    nl, nr = live_l.shape[0], live_r.shape[0]
    gcap = nl + nr
    g_l, g_r = union_group_ids(left_keys, right_keys, live_l, live_r)
    eligible_l = live_l & ~_any_null_key(left_keys, nl, live_l.device)
    eligible_r = live_r & ~_any_null_key(right_keys, nr, live_r.device)
    perm_r, counts, starts_g = _build_order(g_r, eligible_r, gcap)
    zero = torch.zeros((), dtype=torch.int32, device=g_l.device)
    matches = torch.where(eligible_l, counts[g_l.long()], zero)
    counts_l = _group_counts(eligible_l, g_l, gcap)[g_r.long()]
    matched_r = eligible_r & (counts_l > 0)
    times_r = torch.where(eligible_r, counts_l, zero)
    return JoinPlanA(g_l, g_r, matches, starts_g, perm_r, eligible_l,
                     eligible_r, matched_r, live_l, live_r, times_r)


def _emitted_left(plan: JoinPlanA, join_type: str) -> torch.Tensor:
    """int64 output rows a stream row emits (its matches, or one)."""
    m = plan.matches.to(torch.int64)
    zero = torch.zeros((), dtype=torch.int64, device=m.device)
    if join_type in ("inner", "cross", "right_outer"):
        return m
    if join_type in ("left_outer", "full_outer"):
        return torch.where(plan.live_l, m.clamp(min=1), zero)
    if join_type == "left_semi":
        return (plan.live_l & (m > 0)).to(torch.int64)
    if join_type == "left_anti":
        return (plan.live_l & (m == 0)).to(torch.int64)
    raise ValueError(join_type)


def _unmatched_r(plan: JoinPlanA) -> torch.Tensor:
    return plan.live_r & ~plan.matched_r


def join_total(plan: JoinPlanA, join_type: str) -> torch.Tensor:
    """Output rows (``:164``), an int64 device scalar."""
    total = _emitted_left(plan, join_type).sum()
    if join_type in ("right_outer", "full_outer"):
        total = total + _unmatched_r(plan).sum(dtype=torch.int64)
    return total


def join_output_bytes(plan: JoinPlanA, left: GpuBatch, right: GpuBatch,
                      join_type: str) -> torch.Tensor:
    """The output's bytes of each string column (``:185``), int64: the
    stream's string columns, then (except semi and anti joins) the
    build's, the order the gather's char capacities take."""
    emit_l = _emitted_left(plan, join_type)
    counts = [(emit_l * c.lengths().to(torch.int64)).sum()
              for c in left.columns if c.is_string_like]
    if join_type not in ("left_semi", "left_anti"):
        times = plan.times_r.to(torch.int64)
        if join_type in ("right_outer", "full_outer"):
            times = times + _unmatched_r(plan).to(torch.int64)
        counts += [(times * c.lengths().to(torch.int64)).sum()
                   for c in right.columns if c.is_string_like]
    if not counts:
        return torch.zeros(0, dtype=torch.int64, device=emit_l.device)
    return torch.stack(counts)


def unique_build_analysis(right_keys: Sequence[GpuColumnVector],
                          live_r: torch.Tensor,
                          payload: Sequence[GpuColumnVector] = ()) \
        -> torch.Tensor:
    """Build-side facts for the fast path, one small int64 device vector
    (one readback a build): ``[max_dup, longest live string of each
    string column of payload...]``. ``max_dup`` is the most eligible
    build rows sharing one key; at most 1 means a stream batch of
    capacity N joins into capacity N."""
    cap = live_r.shape[0]
    eligible = live_r & ~_any_null_key(right_keys, cap, live_r.device)
    keys = [_norm_key_col(k) for k in right_keys]
    _, seg, _, sorted_live = sorted_segments(keys, eligible)
    counts = seg_reduce_sorted(sorted_live.to(torch.int32), seg, cap, "sum")
    parts = [counts.max().to(torch.int64)]
    for c in payload:
        if c.is_string_like:
            lens = c.lengths()
            parts.append(torch.where(live_r, lens, torch.zeros_like(lens))
                         .max().to(torch.int64))
    return torch.stack(parts)


def build_dup_flag(right_keys: Sequence[GpuColumnVector],
                   live_r: torch.Tensor) -> torch.Tensor:
    """Device bool scalar: some eligible build key is duplicated (the
    union lookup's hint check)."""
    return unique_build_analysis(right_keys, live_r)[0] > 1


def unique_build_probe(rkey: GpuColumnVector, live_r: torch.Tensor) \
        -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Presort a single fixed-width build key once per build:
    ``(rk_sorted, perm, n_eligible, dup_flag)``. Ineligible rows take the
    lane's maximum and sort last behind an eligibility bit, so the whole
    sorted array ascends (searchsorted needs that) and a real key equal
    to the maximum still matches through ``pos < n_eligible``.
    ``dup_flag`` is a device bool: some eligible key appears twice."""
    rk = _norm_key_col(rkey)
    eligible = live_r if rk.validity is None else live_r & rk.validity
    v = orderable_int(rk)
    v = torch.where(eligible, v, torch.full_like(v, torch.iinfo(v.dtype).max))
    width = key_lane_width(rk)
    _, perm = sort_packed(pack_words([((~eligible).to(torch.int64), 1),
                                      (unsigned_lane(v, width), width)]))
    (rk_sorted,), _ = ck.gather_rows([v.contiguous()], [None], perm)
    n_elig = eligible.sum(dtype=torch.int32)
    pos1 = torch.arange(1, v.shape[0], device=v.device)
    dup = ((rk_sorted[1:] == rk_sorted[:-1]) & (pos1 < n_elig)).any()
    return rk_sorted, perm, n_elig, dup


def probe_unique(lkey: GpuColumnVector, eligible_l: torch.Tensor,
                 rk_sorted: torch.Tensor, perm_r: torch.Tensor,
                 n_elig: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ridx, matched)`` for a unique build by binary search into the
    presorted keys."""
    v = orderable_int(_norm_key_col(lkey))
    if v.dtype != rk_sorted.dtype:
        common = torch.promote_types(v.dtype, rk_sorted.dtype)
        v, rk_sorted = v.to(common), rk_sorted.to(common)
    pos = torch.searchsorted(rk_sorted, v, right=False)
    pos_c = pos.clamp(0, rk_sorted.shape[0] - 1)
    matched = eligible_l & (pos < n_elig) & (rk_sorted[pos_c] == v)
    return perm_r[pos_c], matched


def unique_union_lookup(left_keys: Sequence[GpuColumnVector],
                        right_keys: Sequence[GpuColumnVector],
                        live_l: torch.Tensor, live_r: torch.Tensor,
                        eligible_l: torch.Tensor, eligible_r: torch.Tensor) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ridx, matched)`` for a unique build on several keys or a
    string key (``:308``): the shared group ids, where the first (only)
    build row of a group is the match; no size readback."""
    nl, nr = live_l.shape[0], live_r.shape[0]
    gcap = nl + nr
    g_l, g_r = union_group_ids(left_keys, right_keys, live_l, live_r)
    perm_r, counts, starts_g = _build_order(g_r, eligible_r, gcap)
    matched = eligible_l & (counts[g_l.long()] > 0)
    ridx = perm_r[starts_g[g_l.long()].clamp(0, nr - 1).long()]
    return ridx, matched


def join_indices(plan: JoinPlanA, join_type: str, out_cap: int) \
        -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage B (``:330``): each output row's ``(left index, right index,
    left valid, right valid)``, int32 indices over ``out_cap`` rows; the
    rows past the total have neither side valid. A semi or anti join's
    j-th output row is its j-th kept stream row, found by searching the
    kept rows' running count (the reference sorts them out)."""
    nl, nr = plan.live_l.shape[0], plan.live_r.shape[0]
    dev = plan.live_l.device
    j = torch.arange(out_cap, dtype=torch.int64, device=dev)
    if join_type in ("left_semi", "left_anti"):
        keep = _emitted_left(plan, join_type)
        kept = torch.cumsum(keep, 0)
        count = kept[-1] if nl else torch.zeros((), dtype=torch.int64,
                                                 device=dev)
        lidx = torch.searchsorted(kept, j, right=True).clamp(0, nl - 1)
        live_out = j < count
        return (lidx.to(torch.int32), torch.zeros_like(lidx, dtype=torch.int32),
                live_out, torch.zeros_like(live_out))
    emit = _emitted_left(plan, join_type)
    ends = torch.cumsum(emit, 0)
    out_start = ends - emit
    pairs_total = ends[-1] if nl else torch.zeros((), dtype=torch.int64,
                                                   device=dev)
    lidx = torch.searchsorted(ends, j, right=True).clamp(0, nl - 1)
    k = j - out_start[lidx]
    is_pair = k < plan.matches[lidx]
    g = plan.g_l[lidx].long()
    rpos = (plan.starts_g[g] + k).clamp(0, nr - 1)
    ridx = plan.perm_r[rpos].to(torch.int64)
    left_valid = j < pairs_total
    right_valid = left_valid & is_pair
    total = pairs_total
    if join_type in ("right_outer", "full_outer"):
        unmatched = _unmatched_r(plan)
        ucount = unmatched.sum(dtype=torch.int64)
        total = pairs_total + ucount
        in_extra = (j >= pairs_total) & (j < total)
        seen = torch.cumsum(unmatched.to(torch.int64), 0)
        extra_r = torch.searchsorted(seen, j - pairs_total,
                                     right=True).clamp(0, nr - 1)
        ridx = torch.where(in_extra, extra_r, ridx)
        right_valid = right_valid | in_extra
    live_out = j < total
    return (lidx.to(torch.int32), ridx.to(torch.int32),
            left_valid & live_out, right_valid & live_out)


def pair_matched_stream(plan: JoinPlanA, ok: torch.Tensor) -> torch.Tensor:
    """Stream rows with a pair that passed (``ok``, over the output rows
    of ``join_indices``'s layout): stream row ``i`` owns the contiguous
    pairs ``[ends[i] - matches[i], ends[i])``, so a running count of
    ``ok`` differenced at those edges counts its passes. The reference
    takes a ``segment_max`` onto the pairs' stream indices (``exec/
    joins.py:727-732``), where every dead pair lands on one row."""
    m = plan.matches.to(torch.int64)
    ends = torch.cumsum(m, 0)
    passed = torch.cumsum(ok.to(torch.int64), 0)
    zero = torch.zeros((), dtype=torch.int64, device=ok.device)

    def upto(e):
        return torch.where(e > 0, passed[(e - 1).clamp(min=0)], zero)

    return upto(ends) - upto(ends - m) > 0


def pair_matched_build(plan: JoinPlanA, ok: torch.Tensor, pairs: int,
                       live_r: int) -> torch.Tensor:
    """Build rows with a pair that passed, for a cross plan's pairs
    (``pairs`` of them, ``live_r`` live build rows): every live stream
    row meets the same live build rows in the same order (``perm_r``'s
    first ``live_r``), so the passes are a ``(stream rows, live_r)``
    matrix and a build row's is an ``any`` down its column, put back
    onto the build rows by one scatter onto distinct rows."""
    out = torch.zeros(plan.live_r.shape[0], dtype=torch.bool,
                      device=ok.device)
    if pairs:
        by_place = ok[:pairs].reshape(pairs // live_r, live_r).any(0)
        out[plan.perm_r[:live_r].long()] = by_place
    return out


def join_gather(left: GpuBatch, right: GpuBatch, lidx: torch.Tensor,
                ridx: torch.Tensor, lvalid: torch.Tensor,
                rvalid: torch.Tensor, total: int, out_schema,
                char_caps: Sequence[int]) -> GpuBatch:
    """Stage C (``:385``): both sides gathered into the output batch, one
    K4 launch a side; ``lvalid``/``rvalid`` null a whole side (outer
    joins). ``char_caps`` gives each column's chars, stream side first
    (0 for fixed-width columns)."""
    nl = len(left.columns)
    cols = gather_columns(left.columns, lidx, lvalid, char_caps[:nl],
                          repeat=True) \
        + gather_columns(right.columns, ridx, rvalid, char_caps[nl:],
                         repeat=True)
    return GpuBatch(cols, out_schema, total)
