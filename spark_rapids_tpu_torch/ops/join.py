"""Equi-join kernels for a unique build side.

Counterpart of ``spark_rapids_tpu/ops/join.py:42-97,224-305``: the
sync-free fast path for a build side whose keys are unique. The build
key is presorted once per build by **K3** (``unique_build_probe``) and
every stream batch finds its match by binary search (``probe_unique``):
a reusable sorted array in place of a hash table. SQL semantics: a row
with a null key never matches; NaN == NaN and ``-0.0 == 0.0`` for keys
(Spark's normalisation).

The staged join for duplicated build keys (``join_counts``,
``join_indices``, ``join_gather``) and the multi-column union lookup
wait for ROADMAP item 9.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..columnar.column import GpuColumnVector
from . import cuda_kernels as ck
from .segments import seg_reduce_sorted
from .sort_keys import (key_lane_width, normalize_float_key_col,
                        orderable_int, pack_words, sort_packed,
                        sorted_segments, unsigned_lane)

__all__ = ["JOIN_TYPES", "unique_build_analysis", "unique_build_probe",
           "build_dup_flag", "probe_unique"]

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


def unique_build_analysis(right_keys: Sequence[GpuColumnVector],
                          live_r: torch.Tensor) -> torch.Tensor:
    """Build-side facts for the fast path, one small device vector:
    ``[max_dup]``, the most eligible build rows sharing one key. At most
    1 means a stream batch of capacity N joins into capacity N."""
    cap = live_r.shape[0]
    eligible = live_r & ~_any_null_key(right_keys, cap, live_r.device)
    keys = [_norm_key_col(k) for k in right_keys]
    _, seg, _, sorted_live = sorted_segments(keys, eligible)
    counts = seg_reduce_sorted(sorted_live.to(torch.int32), seg, cap, "sum")
    return counts.max().reshape(1)


def build_dup_flag(right_keys: Sequence[GpuColumnVector],
                   live_r: torch.Tensor) -> torch.Tensor:
    """Device bool scalar: some eligible build key is duplicated."""
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
