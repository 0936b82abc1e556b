"""Reductions over sorted segments.

Counterpart of ``spark_rapids_tpu/ops/segments.py:42-128``. The grouped
aggregate presents sorted segment ids, so a segment's sum is a difference
of prefix sums at its edges (found with ``torch.searchsorted``), and its
min or max sits at an edge once the rows are sorted by
``(segment, value)``. The prefix sums and lookups are plain torch, as the
reference's are XLA ops; the sort for min/max is **K3**
(``sort_keys.sort_packed``) and the gather of the sorted values **K4**.

Float sums keep the reference's ``blocked_float_sum``: prefixes restart
every 1024 rows, so a small segment after a large running total keeps
its own precision, and NaN and +-inf are counted apart with exact
integer prefixes and recomposed on top. Empty segments read the
operation's identity.
"""
from __future__ import annotations

import math

import torch

from ..columnar.column import GpuColumnVector
from .. import datatypes as dt
from . import cuda_kernels as ck
from .sort_keys import key_lane_bits, pack_words, sort_packed

__all__ = ["seg_reduce_sorted", "segment_starts_sorted"]

_BLOCK = 1024
_DT_OF = {torch.int8: dt.INT8, torch.int16: dt.INT16, torch.int32: dt.INT32,
          torch.int64: dt.INT64, torch.float32: dt.FLOAT32,
          torch.float64: dt.FLOAT64}


def _identity(kind: str, dtype: torch.dtype, device) -> torch.Tensor:
    if kind == "sum":
        return torch.zeros((), dtype=dtype, device=device)
    if dtype.is_floating_point:
        v = math.inf if kind == "min" else -math.inf
    else:
        info = torch.iinfo(dtype)
        v = info.max if kind == "min" else info.min
    return torch.tensor(v, dtype=dtype, device=device)


def _edges(seg: torch.Tensor, cap: int):
    g = torch.arange(cap, dtype=seg.dtype, device=seg.device)
    right = torch.searchsorted(seg, g, right=True).to(torch.int64)
    left = torch.searchsorted(seg, g, right=False).to(torch.int64)
    return left, right


def _prefix_diff(v: torch.Tensor, left, right) -> torch.Tensor:
    """Exact for integers: one global prefix sum, edge differences."""
    n = v.shape[0]
    ps = torch.cumsum(v, 0)
    hi = ps[(right - 1).clamp(0, n - 1)]
    lo = torch.where(left > 0, ps[(left - 1).clamp(0, n - 1)],
                     torch.zeros((), dtype=ps.dtype, device=ps.device))
    return hi - lo


def _blocked_float_sum(v: torch.Tensor, left, right) -> torch.Tensor:
    """Float segment sums from block-local prefixes (the reference's
    ``blocked_float_sum``): an in-block segment's rounding error scales
    with its block, not with the whole running total. A one-row segment
    is its row's value, exact (the reference takes the prefix
    difference), so merging partials that hold one row a group, round
    after round, adds no rounding."""
    n = v.shape[0]
    k = min(_BLOCK, n)
    nb = -(-n // k)
    vp = torch.nn.functional.pad(v, (0, nb * k - n))
    p2 = torch.cumsum(vp.view(nb, k), 1)
    pflat = p2.reshape(-1)
    t = p2[:, -1]
    bt = torch.cumsum(t, 0)
    l = left.clamp(0, n - 1)
    r = (right - 1).clamp(0, n - 1)
    bl, br = l // k, r // k
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    p_last = pflat[r]
    p_before = torch.where(l % k == 0, zero, pflat[(l - 1).clamp(0, n - 1)])
    head = t[bl] - p_before
    mid = torch.where(br - bl >= 2, bt[(br - 1).clamp(0, nb - 1)] - bt[bl],
                      zero)
    return torch.where(right - left == 1, v[l],
                       torch.where(bl == br, p_last - p_before,
                                   head + mid + p_last))


def _float_sum(vals: torch.Tensor, left, right) -> torch.Tensor:
    finite = torch.isfinite(vals)
    base = _blocked_float_sum(
        torch.where(finite, vals, torch.zeros_like(vals)), left, right)
    nan_c = _prefix_diff(torch.isnan(vals).to(torch.int32), left, right)
    pos_c = _prefix_diff((vals == math.inf).to(torch.int32), left, right)
    neg_c = _prefix_diff((vals == -math.inf).to(torch.int32), left, right)

    def full(x):
        return torch.full_like(base, x)

    return torch.where(
        (nan_c > 0) | ((pos_c > 0) & (neg_c > 0)), full(math.nan),
        torch.where(pos_c > 0, full(math.inf),
                    torch.where(neg_c > 0, full(-math.inf), base)))


def _min_max(vals: torch.Tensor, seg: torch.Tensor, left, right,
             kind: str) -> torch.Tensor:
    """Sort by ``(segment, value)`` in ``jax.lax.sort``'s order, then read
    each segment's edge."""
    if vals.dtype == torch.bool:
        raise TypeError("sort-based min/max needs an orderable lane")
    n = vals.shape[0]
    val_lane = key_lane_bits(GpuColumnVector(_DT_OF[vals.dtype], vals))
    words = pack_words([(seg.to(torch.int64), 32), val_lane])
    _, perm = sort_packed(words)
    (sval,), _ = ck.gather_rows([vals], [None], perm)
    edge = left if kind == "min" else right - 1
    return sval[edge.clamp(0, n - 1)]


def seg_reduce_sorted(vals: torch.Tensor, seg: torch.Tensor, cap: int,
                      kind: str) -> torch.Tensor:
    """Reduce ``vals`` per segment for sorted (non-decreasing) ``seg``
    ids, output length ``cap`` indexed by segment id. kind: sum, min or
    max."""
    left, right = _edges(seg, cap)
    empty = right == left
    if kind == "sum":
        if vals.dtype.is_floating_point:
            out = _float_sum(vals, left, right)
        else:
            out = _prefix_diff(vals, left, right).to(vals.dtype)
    elif kind in ("min", "max"):
        out = _min_max(vals, seg, left, right, kind)
    else:
        raise ValueError(f"unknown segment reduction {kind!r}")
    return torch.where(empty, _identity(kind, vals.dtype, vals.device), out)


def segment_starts_sorted(seg: torch.Tensor, cap: int) -> torch.Tensor:
    """``starts[g]`` = first position of segment g in the sorted order
    (``cap`` entries; empty segments clamp into ``[0, n - 1]``)."""
    g = torch.arange(cap, dtype=seg.dtype, device=seg.device)
    n = seg.shape[0]
    return torch.searchsorted(seg, g, right=False).clamp(
        0, max(n - 1, 0)).to(torch.int32)
