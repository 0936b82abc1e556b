"""String -> number, boolean and date parsing on the device.

Counterpart of ``spark_rapids_tpu/ops/string_parse.py`` (``parse_int_tpu``
``:107``, ``parse_float_tpu`` ``:155``, ``parse_bool_tpu`` ``:231``,
``parse_date_tpu`` ``:255``, ``days_from_civil``), in vectorised torch
over the flat ``(offsets, chars)`` lanes as there: every byte knows its
row (one ``searchsorted`` over the offsets), and a row's facts are
segment reductions over its bytes (``scatter_reduce``), so the work and
the memory grow with the bytes, never with the longest row. Nothing is
read back. These are the plain formulations; a CUDA kernel for them
waits until a trace shows one holding time.

The accepted forms are the reference's (Spark's UTF8String rules):
whitespace-trimmed (``_WS``), an optional sign, plain decimal digits
(an integer accepts a trailing ``.ddd``, truncated), a float adds an
exponent and the case-insensitive ``nan``/``inf``/``infinity``
specials, a boolean ``t true y yes 1`` / ``f false n no 0``, a date
``YYYY-M-D`` with an optional ``T`` or space tail. An invalid row is
null (``ok`` False). A float is ``int_digits x 10^e + frac_digits x
10^(e - frac_len)`` in float64, as the reference computes it: exact to
15 significant digits and moderate exponents, an ulp off strtod beyond.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import datatypes as dt

__all__ = ["parse_int", "parse_float", "parse_bool", "parse_date",
           "days_from_civil", "civil_from_days"]

_WS = (0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20)  # str.strip()'s ASCII set
_BIG = 1 << 40
_I64 = torch.int64


class _Rows:
    """The per-byte machinery every parser shares: each byte's row and
    position, and each row's whitespace-trimmed window ``[ts, te)``."""

    def __init__(self, col):
        offs = col.offsets.to(_I64)
        self.n = offs.shape[0] - 1
        dev = offs.device
        c = col.chars if col.chars.shape[0] else \
            torch.zeros(1, dtype=torch.uint8, device=dev)
        self.c = c.to(_I64)
        size = c.shape[0]
        self.i = torch.arange(size, dtype=_I64, device=dev)
        self.rid = (torch.searchsorted(offs, self.i, right=True) - 1) \
            .clamp(0, max(self.n - 1, 0))
        s, e = offs[:-1], offs[1:]
        in_row = (self.i >= s[self.rid]) & (self.i < e[self.rid])
        ws = torch.zeros_like(in_row)
        for w in _WS:
            ws |= self.c == w
        nonws = in_row & ~ws
        ts = self.seg_min(torch.where(nonws, self.i, _BIG))
        te_last = self.seg_max(torch.where(nonws, self.i, -1))
        self.ts = torch.where(ts > te_last, e, ts)  # blank or empty
        self.te = torch.where(te_last < 0, e, te_last + 1)
        self.is_digit = (self.c >= ord("0")) & (self.c <= ord("9"))

    def _reduce(self, v, how, init):
        out = torch.full((self.n,), init, dtype=_I64, device=v.device)
        return out.scatter_reduce(0, self.rid, v, how, include_self=True)

    def seg_min(self, v):
        return self._reduce(v, "amin", _BIG)

    def seg_max(self, v):
        return self._reduce(v, "amax", -1)

    def inside(self, lo, hi):
        return (self.i >= lo[self.rid]) & (self.i < hi[self.rid])

    def first_pos(self, pred, lo, hi, default):
        """Each row's first position in ``[lo, hi)`` where ``pred``, else
        ``default``."""
        pos = self.seg_min(torch.where(pred & self.inside(lo, hi), self.i,
                                       _BIG))
        return torch.where(pos >= _BIG, default, pos)

    def all_in(self, pred, lo, hi):
        """Every position of ``[lo, hi)`` satisfies ``pred`` (true when
        the range is empty)."""
        bad = self.seg_max((self.inside(lo, hi) & ~pred).to(_I64))
        return bad <= 0

    def at(self, pos):
        """The byte at each row's ``pos`` (clamped into the buffer)."""
        return self.c[pos.clamp(0, self.c.shape[0] - 1)]

    def digits_value(self, lo, hi):
        """``(value, fits)``: the digit run ``[lo, hi)`` as an integer
        (its caller has checked that it is all digits) and whether it
        has at most 19 significant digits. The value wraps past 2^63,
        as the reference's uint64 does, and ``fits`` then says no."""
        inside = self.inside(lo, hi)
        nonzero = inside & (self.c != ord("0"))
        first_sig = self.seg_min(torch.where(nonzero, self.i, _BIG))
        first_sig = torch.where(first_sig >= _BIG, hi, first_sig)
        fits = (hi - first_sig) <= 19
        exp = hi[self.rid] - 1 - self.i
        pow10 = torch.tensor([10 ** k if k < 19 else 0 for k in range(20)],
                             dtype=_I64, device=self.c.device)
        # 10^19 passes int64: its digit is only ever 0 within 19
        # significant digits, so it adds nothing
        term = (self.c - ord("0")) * pow10[exp.clamp(0, 19)]
        term = torch.where(inside & (exp < 19), term, torch.zeros_like(term))
        total = self._reduce(term, "sum", 0)
        return total, fits


def parse_int(col, target: dt.DataType) -> Tuple[torch.Tensor,
                                                 torch.Tensor]:
    """``(int64 values, ok)`` for a cast to an integral type:
    ``[ws][+-]digits[.digits][ws]``, the fraction truncated, the value
    inside the target's range."""
    r = _Rows(col)
    at_ts = r.at(r.ts)
    has_sign = (at_ts == ord("+")) | (at_ts == ord("-"))
    neg = at_ts == ord("-")
    ds = r.ts + has_sign.to(_I64)
    dot = r.first_pos(r.c == ord("."), ds, r.te, r.te)
    ok = (r.te > r.ts) & (dot > ds)
    ok &= r.all_in(r.is_digit, ds, dot)
    ok &= r.all_in(r.is_digit, torch.minimum(dot + 1, r.te), r.te)
    val, fits = r.digits_value(ds, dot)
    ok &= fits
    # the magnitude's limit: 2^63 - 1, or 2^63 for a negative value; in
    # int64 a magnitude of 2^63 (or more within 19 digits) wraps below 0
    over = (val < 0) & ~(neg & (val == -(1 << 63)))
    ok &= ~over
    v = torch.where(neg, -val, val)  # -(2^63) wraps to INT64_MIN
    if not isinstance(target, dt.LongType):
        info = torch.iinfo({dt.IntegerType: torch.int32,
                            dt.ShortType: torch.int16,
                            dt.ByteType: torch.int8}[type(target)])
        ok &= (v >= info.min) & (v <= info.max)
    return v, ok


_POW10 = [float(10.0 ** k) if abs(k) < 309 else
          (float("inf") if k > 0 else 0.0) for k in range(-350, 351)]


def _pow10_table(device) -> torch.Tensor:
    """10^k for k in [-350, 350], the host's correctly rounded doubles
    (the reference's table)."""
    return torch.tensor(_POW10, dtype=torch.float64).to(device)


def _unsigned(v: torch.Tensor) -> torch.Tensor:
    """A digit run's value (19 digits may pass 2^63 and wrap) as a
    double."""
    return v.to(torch.float64) + torch.where(
        v < 0, torch.full((), 2.0 ** 64, dtype=torch.float64,
                          device=v.device),
        torch.zeros((), dtype=torch.float64, device=v.device))


def _match_literal(r: _Rows, lit: bytes, offset):
    """Each row's trimmed window from ``ts + offset`` equals ``lit``,
    case-insensitively, and ends at ``te``."""
    lower = torch.where((r.c >= ord("A")) & (r.c <= ord("Z")), r.c + 32,
                        r.c)
    m = torch.ones(r.n, dtype=torch.bool, device=r.c.device)
    for k, ch in enumerate(lit):
        pos = r.ts + offset + k
        m &= (lower[pos.clamp(0, r.c.shape[0] - 1)] == ch) & (pos < r.te)
    return m & (r.te == r.ts + offset + len(lit))


def parse_float(col, target: dt.DataType) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """``(values in the target's lane, ok)`` for a cast to float or
    double (module docstring)."""
    r = _Rows(col)
    at_ts = r.at(r.ts)
    has_sign = (at_ts == ord("+")) | (at_ts == ord("-"))
    neg = at_ts == ord("-")
    ds = r.ts + has_sign.to(_I64)
    is_e = (r.c == ord("e")) | (r.c == ord("E"))
    epos = r.first_pos(is_e, ds, r.te, r.te)
    dot = r.first_pos(r.c == ord("."), ds, epos, epos)
    frac_lo = torch.minimum(dot + 1, epos)
    frac_len = (epos - frac_lo).clamp(min=0)
    ok = (r.te > r.ts) & ((dot - ds + frac_len) > 0)
    ok &= r.all_in(r.is_digit, ds, dot)
    ok &= r.all_in(r.is_digit, frac_lo, epos)
    iv, ok_i = r.digits_value(ds, dot)
    fv, ok_f = r.digits_value(frac_lo, epos)
    ok &= ok_i & ok_f
    e_ds = epos + 1
    at_e = r.at(e_ds)
    e_sign = (at_e == ord("+")) | (at_e == ord("-"))
    e_lo = e_ds + e_sign.to(_I64)
    has_exp = epos < r.te
    ok &= ~has_exp | (r.te > e_lo)
    ok &= r.all_in(r.is_digit, e_lo, r.te)
    ev, ok_e = r.digits_value(e_lo, r.te)
    ev = torch.where(ok_e & (ev >= 0), ev, torch.full_like(ev, 400)) \
        .clamp(0, 400)
    exp = torch.where(has_exp, torch.where(at_e == ord("-"), -ev, ev),
                      torch.zeros_like(ev))
    pow10 = _pow10_table(r.c.device)
    zero = torch.zeros((), dtype=torch.float64, device=iv.device)
    int_mag = torch.where(iv == 0, zero, _unsigned(iv)
                          * pow10[exp.clamp(-350, 350) + 350])
    frac_mag = torch.where(fv == 0, zero, _unsigned(fv)
                           * pow10[(exp - frac_len).clamp(-350, 350)
                                   + 350])
    mag = int_mag + frac_mag
    val = torch.where(neg, -mag, mag)
    nan_m = _match_literal(r, b"nan", 0)
    inf_m = _match_literal(r, b"inf", 0) | _match_literal(r, b"infinity",
                                                          0)
    inf_s = (_match_literal(r, b"inf", 1)
             | _match_literal(r, b"infinity", 1)) & has_sign
    special = nan_m | inf_m | inf_s
    sval = torch.where(nan_m, torch.full_like(val, float("nan")),
                       torch.where(neg, torch.full_like(val, -float("inf")),
                                   torch.full_like(val, float("inf"))))
    out = torch.where(special, sval, val)
    lane = torch.float32 if isinstance(target, dt.FloatType) \
        else torch.float64
    return out.to(lane), ok | special


_BOOL_TRUE = (b"t", b"true", b"y", b"yes", b"1")
_BOOL_FALSE = (b"f", b"false", b"n", b"no", b"0")


def parse_bool(col) -> Tuple[torch.Tensor, torch.Tensor]:
    r = _Rows(col)
    t = torch.zeros(r.n, dtype=torch.bool, device=r.c.device)
    f = torch.zeros_like(t)
    for lit in _BOOL_TRUE:
        t |= _match_literal(r, lit, 0)
    for lit in _BOOL_FALSE:
        f |= _match_literal(r, lit, 0)
    return t, t | f


def days_from_civil(y, m, d):
    """(year, month, day) -> days since 1970-01-01 (Hinnant's civil
    calendar, any year); the inverse of ``civil_from_days``."""
    y = y.to(_I64) - (m <= 2).to(_I64)
    # Hinnant's (y >= 0 ? y : y - 399) / 400 truncates; a floor
    # division is the same without the branch (the reference floors the
    # shifted value, which is a year early before year 0)
    era = torch.div(y, 400, rounding_mode="floor")
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9).to(_I64)
    doy = torch.div(153 * mp + 2, 5, rounding_mode="floor") + d - 1
    doe = yoe * 365 + torch.div(yoe, 4, rounding_mode="floor") \
        - torch.div(yoe, 100, rounding_mode="floor") + doy
    return era * 146097 + doe - 719468


def civil_from_days(z):
    """days since 1970-01-01 -> (year, month, day), int64 each."""
    z = z.to(_I64) + 719468
    era = torch.div(z, 146097, rounding_mode="floor")
    doe = z - era * 146097
    yoe = torch.div(doe - torch.div(doe, 1460, rounding_mode="floor")
                    + torch.div(doe, 36524, rounding_mode="floor")
                    - torch.div(doe, 146096, rounding_mode="floor"), 365,
                    rounding_mode="floor")
    y = yoe + era * 400
    doy = doe - (365 * yoe + torch.div(yoe, 4, rounding_mode="floor")
                 - torch.div(yoe, 100, rounding_mode="floor"))
    mp = torch.div(5 * doy + 2, 153, rounding_mode="floor")
    d = doy - torch.div(153 * mp + 2, 5, rounding_mode="floor") + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def parse_date(col) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(int32 days, ok)`` for a cast to date: ``YYYY-M-D`` with an
    optional ``T`` or space tail; an impossible calendar date
    (2000-02-30) is not ok."""
    r = _Rows(col)
    dash = r.c == ord("-")
    d1 = r.first_pos(dash, r.ts + 1, r.te, r.te)
    d2 = r.first_pos(dash, d1 + 1, r.te, r.te)
    tail = r.first_pos((r.c == ord("T")) | (r.c == ord(" ")), d2 + 1, r.te,
                       r.te)
    ok = (d1 == r.ts + 4) & (d2 > d1 + 1) & (d2 <= d1 + 3) \
        & (tail > d2 + 1) & (tail <= d2 + 3)
    ok &= r.all_in(r.is_digit, r.ts, d1)
    ok &= r.all_in(r.is_digit, d1 + 1, d2)
    ok &= r.all_in(r.is_digit, d2 + 1, tail)
    y, _ = r.digits_value(r.ts, d1)
    m, _ = r.digits_value(d1 + 1, d2)
    d, _ = r.digits_value(d2 + 1, tail)
    ok &= (m >= 1) & (m <= 12) & (d >= 1) & (d <= 31)
    days = days_from_civil(y, m.clamp(1, 12), d.clamp(1, 31))
    ry, rm, rd = civil_from_days(days)
    ok &= (ry == y) & (rm == m) & (rd == d)
    return days.to(torch.int32), ok
