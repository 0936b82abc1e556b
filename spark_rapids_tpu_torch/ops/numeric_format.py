"""Integer, boolean, date, timestamp and decimal -> string on the device.

Counterpart of ``spark_rapids_tpu/ops/numeric_format.py``
(``int_to_string_tpu`` ``:59``, ``bool_to_string_tpu``,
``date_to_string_tpu`` ``:117``, ``timestamp_to_string_tpu`` ``:135``,
``decimal_to_string_tpu`` ``:181``, ``ragged_from_fixed``) in torch: each row's bytes are generated into a
fixed-width window by integer arithmetic, then the windows are packed
into the ``(offsets, chars)`` layout (``ragged_from_fixed``, one
``ops/strings.assemble_strings``). The output's char capacity is the
windows' total (rows x width), a host-known bound, so nothing is read
back; it can be several times the bytes the rows hold (ROADMAP item
20). These are the plain formulations; a CUDA kernel waits until a trace
shows one holding time.

Formats are the reference's: Java's ``Long.toString`` (INT64_MIN
included), ``true``/``false``, ``YYYY-MM-DD`` and ``YYYY-MM-DD
HH:MM:SS[.ffffff]`` (UTC, the fraction's trailing zeros trimmed, no
fraction when it is zero). A year is printed with four digits, as there
(a year past 9999 or before 1 wraps modulo 10000; Spark prints a sign
and more digits, ROADMAP "Things to know"). A Decimal64 prints in plain
notation, as Java's ``BigDecimal.toPlainString``: a sign, at least one
integral digit, and with a scale the dot and exactly ``scale`` fraction
digits (``decimal_to_string``); its window is the reference's widest
form, 19 digits and 3 bytes for the sign, the dot and a leading ``0``.
"""
from __future__ import annotations

import torch

from .. import datatypes as dt
from ..columnar.column import GpuColumnVector
from .string_parse import civil_from_days
from .strings import assemble_strings

__all__ = ["ragged_from_fixed", "int_to_string", "bool_to_string",
           "date_to_string", "timestamp_to_string",
           "timestamp_parts_to_string", "decimal_to_string"]

_I64 = torch.int64
_MAX_DIGITS = 19
_US_PER_DAY = 86400 * 1_000_000


def ragged_from_fixed(mat: torch.Tensor, lens: torch.Tensor,
                      validity) -> GpuColumnVector:
    """``(n, W)`` bytes, each row left-aligned, and each row's length ->
    a string column of ``n`` rows and ``n x W`` chars."""
    n, w = mat.shape
    flat = GpuColumnVector(dt.STRING, None, None, None,
                           mat.reshape(-1).to(torch.uint8))
    starts = (torch.arange(n, dtype=_I64, device=mat.device) * w) \
        .to(torch.int32)
    return assemble_strings(flat, starts, lens.to(torch.int32), validity,
                            n * w)


def _digit(v: torch.Tensor, p: int) -> torch.Tensor:
    return torch.div(v, p, rounding_mode="floor") % 10 + ord("0")


def int_to_string(col: GpuColumnVector) -> GpuColumnVector:
    """Java's ``Long.toString`` of any integral lane."""
    v = col.data.to(_I64)
    dev = v.device
    neg = v < 0
    is_min = v == -(1 << 63)
    digs, ndig = _digit_matrix(torch.where(is_min, torch.zeros_like(v),
                                           v.abs()))
    width = _MAX_DIGITS + 1
    posj = torch.arange(width, dtype=_I64, device=dev)[None, :]
    src = (_MAX_DIGITS - ndig[:, None] + posj - neg[:, None].to(_I64)) \
        .clamp(0, _MAX_DIGITS - 1)
    mat = torch.gather(digs, 1, src) + ord("0")
    mat = torch.where((posj == 0) & neg[:, None],
                      torch.full_like(mat, ord("-")), mat)
    lens = ndig + neg.to(_I64)
    lit = torch.tensor(list(b"-9223372036854775808"), dtype=_I64,
                       device=dev)
    mat = torch.where(is_min[:, None], lit[None, :], mat)
    lens = torch.where(is_min, torch.full_like(lens, 20), lens)
    return ragged_from_fixed(mat, lens, col.validity)


def _digit_matrix(mag: torch.Tensor):
    """``(n, 19)`` decimal digits of non-negative int64 values, most
    significant first, and each value's digit count (at least 1)."""
    dev = mag.device
    powers = torch.tensor([10 ** (_MAX_DIGITS - 1 - i)
                           for i in range(_MAX_DIGITS)], dtype=_I64,
                          device=dev)
    digs = torch.div(mag[:, None], powers[None, :],
                     rounding_mode="floor") % 10
    thresholds = torch.tensor([10 ** k for k in range(1, _MAX_DIGITS)],
                              dtype=_I64, device=dev)
    return digs, 1 + (mag[:, None] >= thresholds[None, :]).sum(1)


def decimal_to_string(col: GpuColumnVector, scale: int) -> GpuColumnVector:
    """A Decimal64's unscaled int64 lane at ``scale`` -> its plain
    string (module docstring); ``|v| < 10^18``, so the magnitude never
    wraps."""
    v = col.data.to(_I64)
    dev = v.device
    neg = (v < 0).to(_I64)
    digs, ndig = _digit_matrix(v.abs())
    int_digits = (ndig - scale).clamp(min=1)
    shown = int_digits + scale
    width = _MAX_DIGITS + 3
    posj = torch.arange(width, dtype=_I64, device=dev)[None, :]
    p = posj - neg[:, None]
    intd = int_digits[:, None]
    k = torch.where(p < intd, p, p - 1) if scale else p
    src = (_MAX_DIGITS - shown[:, None] + k).clamp(0, _MAX_DIGITS - 1)
    mat = torch.gather(digs, 1, src) + ord("0")
    if scale:
        mat = torch.where(p == intd, torch.full_like(mat, ord(".")), mat)
    mat = torch.where((posj == 0) & (neg[:, None] == 1),
                      torch.full_like(mat, ord("-")), mat)
    lens = neg + shown + (1 if scale else 0)
    return ragged_from_fixed(mat, lens, col.validity)


def bool_to_string(col: GpuColumnVector) -> GpuColumnVector:
    dev = col.data.device
    t = torch.tensor(list(b"true\x00"), dtype=_I64, device=dev)
    f = torch.tensor(list(b"false"), dtype=_I64, device=dev)
    b = col.data.to(torch.bool)
    mat = torch.where(b[:, None], t[None, :], f[None, :])
    lens = torch.where(b, 4, 5)
    return ragged_from_fixed(mat, lens, col.validity)


def _date_bytes(days: torch.Tensor):
    """The ten bytes ``YYYY-MM-DD`` of each day number."""
    y, m, d = civil_from_days(days)
    dash = torch.full_like(y, ord("-"))
    return [_digit(y, 1000), _digit(y, 100), _digit(y, 10), _digit(y, 1),
            dash, _digit(m, 10), _digit(m, 1), dash, _digit(d, 10),
            _digit(d, 1)]


def date_to_string(col: GpuColumnVector) -> GpuColumnVector:
    """``YYYY-MM-DD``."""
    mat = torch.stack(_date_bytes(col.data), 1)
    lens = torch.full((mat.shape[0],), 10, dtype=_I64, device=mat.device)
    return ragged_from_fixed(mat, lens, col.validity)


def timestamp_parts_to_string(days: torch.Tensor, secs_of_day: torch.Tensor,
                              frac: torch.Tensor, validity,
                              with_fraction: bool) -> GpuColumnVector:
    """``YYYY-MM-DD HH:MM:SS`` and, with ``with_fraction``, ``.ffffff``
    with its trailing zeros trimmed (none when it is zero)."""
    hh = torch.div(secs_of_day, 3600, rounding_mode="floor")
    mm = torch.div(secs_of_day, 60, rounding_mode="floor") % 60
    ss = secs_of_day % 60
    colon = torch.full_like(hh, ord(":"))
    cols = _date_bytes(days) + [
        torch.full_like(hh, ord(" ")), _digit(hh, 10), _digit(hh, 1), colon,
        _digit(mm, 10), _digit(mm, 1), colon, _digit(ss, 10),
        _digit(ss, 1)]
    n = hh.shape[0]
    lens = torch.full((n,), 19, dtype=_I64, device=hh.device)
    if with_fraction:
        cols += [torch.full_like(hh, ord("."))] + [
            _digit(frac, 10 ** (5 - k)) for k in range(6)]
        trailing = torch.zeros_like(frac)
        for k in range(1, 6):
            trailing += (frac % (10 ** k) == 0).to(_I64)
        lens = torch.where(frac == 0, lens, 26 - trailing)
    return ragged_from_fixed(torch.stack(cols, 1), lens, validity)


def timestamp_to_string(col: GpuColumnVector) -> GpuColumnVector:
    """Microseconds since the epoch (UTC) -> Spark's cast format."""
    v = col.data.to(_I64)
    days = torch.div(v, _US_PER_DAY, rounding_mode="floor")
    us = v - days * _US_PER_DAY
    return timestamp_parts_to_string(
        days, torch.div(us, 1_000_000, rounding_mode="floor"),
        us % 1_000_000, col.validity, with_fraction=True)
