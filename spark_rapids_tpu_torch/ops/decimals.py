"""Decimal arithmetic on int64 lanes, and the host's exact decimal path.

The port's counterpart of the reference's decimal helpers
(``spark_rapids_tpu/expr/cast.py`` ``_rescale_tpu``/``_div_trunc_j``,
``expr/arithmetic.py:339-354`` ``_div_half_up_j``). A decimal of
precision <= 18 (Decimal64) is its unscaled value in an int64 lane. On
that lane:

- ``fits(x, p)``: ``|x| <= 10^p - 1``, Spark's overflow test;
- ``div_half_up(num, den)``: the quotient rounded ``HALF_UP`` (half away
  from zero, Spark's decimal rounding): torch's integer division floors
  or truncates, so the magnitude is rounded and the sign put back;
- ``rescale(x, from_scale, to_scale)``: more fraction digits by a
  multiply, fewer by ``HALF_UP``.

None of these ever sees a value past 18 digits, so no product or
quotient here can wrap. Where an operation needs more digits than that
(a wider result, an operand rescaled past 18 digits), the planner puts
its operator on the CPU, and there it runs on Python's unbounded
integers: ``to_ints`` reads a column's unscaled values (a narrow lane or
a wide column's two words, ``columnar/column.py``) as an object array,
``column_from_ints`` builds the result column back, narrow or wide.
"""
from __future__ import annotations

import decimal
from typing import Optional

import numpy as np
import torch

from .. import datatypes as dt
from ..columnar.column import GpuColumnVector, lane_shape

__all__ = ["POW10", "MAX_LANE_DIGITS", "EXACT", "fits", "div_half_up",
           "rescale", "to_ints", "column_from_ints", "round_ints",
           "div_half_up_ints", "fits_ints", "to_decimals", "orderable_words", "limbs", "join_limbs",
           "as_double"]

MAX_LANE_DIGITS = dt.DecimalType.MAX_INT64_PRECISION
POW10 = [10 ** k for k in range(2 * dt.DecimalType.MAX_PRECISION + 2)]
_MASK64 = (1 << 64) - 1
#: a context wide enough that no decimal of 38 digits at any scale
#: rounds (Python's default keeps 28 digits)
EXACT = decimal.Context(prec=2 * dt.DecimalType.MAX_PRECISION + 2)


def fits(x: torch.Tensor, precision: int) -> torch.Tensor:
    """``|x| <= 10^precision - 1`` (always true past 18 digits)."""
    if precision > MAX_LANE_DIGITS:
        return torch.ones_like(x, dtype=torch.bool)
    lim = POW10[precision] - 1
    return (x <= lim) & (x >= -lim)


def div_half_up(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` rounded half away from zero; ``den`` never 0 and
    both under 2^62 in magnitude."""
    q = torch.div(num, den, rounding_mode="trunc")
    r = (num - q * den).abs()
    up = (r != 0) & (r >= den.abs() - r)
    step = torch.where((num < 0) != (den < 0), -1, 1).to(num.dtype)
    return q + torch.where(up, step, torch.zeros_like(step))


def rescale(x: torch.Tensor, from_scale: int, to_scale: int) \
        -> torch.Tensor:
    """The unscaled values at ``to_scale``: up by a multiply (the caller
    checks the digits fit), down ``HALF_UP``."""
    if to_scale == from_scale:
        return x
    if to_scale > from_scale:
        return x * POW10[to_scale - from_scale]
    return div_half_up(x, torch.full_like(x, POW10[from_scale - to_scale]))


# --- the host's exact path ------------------------------------------------

def to_ints(col: GpuColumnVector) -> np.ndarray:
    """The unscaled values of a decimal (or integral) column as Python
    ints (an object array over the whole capacity; null rows hold
    whatever their lane holds)."""
    data = col.data.cpu().numpy()
    if data.ndim == 2:
        lo = data[:, 0].view(np.uint64).astype(object)
        hi = data[:, 1].astype(object)
        return hi * (1 << 64) + lo
    return data.astype(np.int64).astype(object)


def fits_ints(values: np.ndarray, precision: int) -> np.ndarray:
    """``|v| <= 10^precision - 1`` over Python ints."""
    lim = POW10[precision] - 1
    return np.asarray((values >= -lim) & (values <= lim), dtype=np.bool_)


def div_half_up_ints(num: np.ndarray, den) -> np.ndarray:
    """``num / den`` over Python ints (``den`` an int or an array, never
    0), rounded half away from zero."""
    a, d = np.abs(num), np.abs(den)
    q = a // d
    q = q + (2 * (a - q * d) >= d)
    return np.where((num < 0) != (np.asarray(den) < 0), -q, q)


def round_ints(values: np.ndarray, from_scale: int, to_scale: int) \
        -> np.ndarray:
    """Python-int rescale, ``HALF_UP`` when the scale falls."""
    if to_scale >= from_scale:
        return values * POW10[to_scale - from_scale]
    return div_half_up_ints(values, POW10[from_scale - to_scale])


def column_from_ints(t: dt.DecimalType, values: np.ndarray,
                     valid: Optional[np.ndarray],
                     device: torch.device) -> GpuColumnVector:
    """A decimal column from Python ints that fit ``t`` where ``valid``
    (other rows are stored as 0)."""
    n = len(values)
    vals = np.array(values, dtype=object)
    if valid is not None:
        vals = np.where(valid, vals, 0)
    shape, _ = lane_shape(t, n, device)
    if len(shape) == 2:
        words = np.empty((n, 2), np.int64)
        words[:, 0] = (vals & _MASK64).astype(np.uint64).view(np.int64) \
            if n else 0
        words[:, 1] = (vals >> 64).astype(np.int64) if n else 0
        data = torch.from_numpy(words)
    else:
        data = torch.from_numpy(np.array(vals, dtype=np.int64)
                                if n else np.zeros(0, np.int64))
    vt = None if valid is None else torch.from_numpy(
        np.ascontiguousarray(valid, dtype=np.bool_))
    return GpuColumnVector(t, data.to(device), None if vt is None
                           else vt.to(device))


def to_decimals(col: GpuColumnVector, scale: int) -> list:
    """Each row as a ``decimal.Decimal`` (None where null)."""
    ints = to_ints(col)
    valid = col.valid_mask().cpu().numpy()
    return [decimal.Decimal(int(v)).scaleb(-scale, EXACT) if ok else None
            for v, ok in zip(ints, valid)]


def orderable_words(col: GpuColumnVector):
    """A wide decimal's value as two int64 words whose lexicographic
    order (high, then low) is the values' order: the high word as it
    is, the low word's unsigned order moved to signed."""
    d = col.data
    return d[:, 1], d[:, 0] ^ torch.tensor(-(1 << 63), dtype=torch.int64)


def limbs(data: torch.Tensor):
    """A decimal lane's values (``(n,)`` or a wide column's ``(n, 2)``
    words) as four int64 lanes of 32-bit limbs, least significant first,
    the top one signed: ``v = sum(limb_k << 32k)``. A sum of each limb in
    int64 is exact up to 2^31 rows."""
    lo, hi = (data[:, 0], data[:, 1]) if data.dim() == 2 \
        else (data, data >> 63)
    m = 0xFFFFFFFF
    return (lo & m, (lo >> 32) & m, hi & m, hi >> 32)


def join_limbs(sums) -> np.ndarray:
    """Python ints from the four limb sums (tensors of one length)."""
    total = None
    for k, s in enumerate(sums):
        part = s.cpu().numpy().astype(object) * (1 << (32 * k))
        total = part if total is None else total + part
    return total


def as_double(col: GpuColumnVector) -> torch.Tensor:
    """A numeric column's values as doubles: a decimal's value, as
    Spark's implicit cast gives it (past 18 digits through ``decimal``,
    on the host)."""
    t = col.dtype
    if dt.is_wide_decimal(t):
        # a Python int's true division rounds once, as float(Decimal)
        x = torch.from_numpy((to_ints(col) / POW10[t.scale])
                             .astype(np.float64)).to(col.device)
        return torch.where(col.valid_mask(), x, torch.zeros_like(x))
    if isinstance(t, dt.DecimalType):
        return col.data.to(torch.float64) / float(POW10[t.scale])
    return col.data.to(torch.float64)
