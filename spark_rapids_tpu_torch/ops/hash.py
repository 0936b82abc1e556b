"""Spark's Murmur3 hash (seed 42) and ``pmod``.

Counterpart of ``spark_rapids_tpu/ops/hash.py:34-203,285``
(``murmur3_int32``/``murmur3_int64``, ``_hash_fixed``,
``hash_column_device``, ``murmur3_bytes_device_seeded``,
``hash_columns_device``, ``pmod``): Murmur3_x86_32 with Spark's seed 42,
a running seed threaded through the key columns, null rows leaving the
seed unchanged, floats hashed by their bits after ``-0.0 -> 0.0`` and
NaN canonicalisation, 8-byte values low word first (a decimal of
precision <= 18 as its unscaled long, ``:95,240-247``), and strings
hashed over their bytes with Spark's sign-extended tail bytes. A wider
decimal (host only) raises: Spark hashes its BigInteger's bytes, which
neither package does yet. Partition ids
are bit for bit those of the reference and of CPU Spark.

torch has no uint32 add, multiply, shift or compare on the CPU (ROADMAP
item 1), so every uint32 value lives in the low 32 bits of an int64
lane and each step masks with ``& 0xFFFFFFFF``: an int64 product of two
such values may wrap, but its low 32 bits are the uint32 product. The
string loop runs to the longest row's block count, one readback a
string column. A struct hashes its fields in order into the running
seed, an array its elements in order, a map each key then its value
(Spark's ``HashExpression``): one step an element position, up to the
longest row (one readback a column; nested keys partition on the CPU,
where the planner places them). xxhash64 waits (ROADMAP item 10).
"""
from __future__ import annotations

from typing import Sequence

import torch

from .. import datatypes as dt
from ..columnar.column import GpuColumnVector

__all__ = ["SEED", "murmur3_int32", "murmur3_int64", "hash_column",
           "hash_columns", "murmur3_bytes_seeded", "pmod"]

_M = 0xFFFFFFFF
_C1 = 0xcc9e2d51
_C2 = 0x1b873593
SEED = 42


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M


def _mix_k1(k1: torch.Tensor) -> torch.Tensor:
    k1 = (k1 * _C1) & _M
    return (_rotl(k1, 15) * _C2) & _M


def _mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    h1 = _rotl(h1 ^ k1, 13)
    return (h1 * 5 + 0xe6546b64) & _M


def _fmix(h1: torch.Tensor, length) -> torch.Tensor:
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = (h1 * 0x85ebca6b) & _M
    h1 = h1 ^ (h1 >> 13)
    h1 = (h1 * 0xc2b2ae35) & _M
    return h1 ^ (h1 >> 16)


def murmur3_int32(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """``v``: the 4-byte values as uint32 in int64 lanes."""
    return _fmix(_mix_h1(seed, _mix_k1(v)), 4)


def murmur3_int64(lo: torch.Tensor, hi: torch.Tensor,
                  seed: torch.Tensor) -> torch.Tensor:
    """An 8-byte value as its low and high uint32 words, low first."""
    h = _mix_h1(seed, _mix_k1(lo))
    return _fmix(_mix_h1(h, _mix_k1(hi)), 8)


def _u32(v: torch.Tensor) -> torch.Tensor:
    """A 32-bit lane's bits as uint32 in int64."""
    return v.to(torch.int64) & _M


def _split64(v: torch.Tensor):
    v = v.to(torch.int64)
    return v & _M, (v >> 32) & _M


def _canonical(d: torch.Tensor) -> torch.Tensor:
    """``-0.0 -> 0.0`` and every NaN to the canonical NaN."""
    d = torch.where(d == 0, torch.zeros_like(d), d)
    return torch.where(torch.isnan(d), torch.full_like(d, float("nan")), d)


def _hash_fixed(col: GpuColumnVector, seed: torch.Tensor) -> torch.Tensor:
    t, d = col.dtype, col.data
    if isinstance(t, dt.BooleanType):
        return murmur3_int32(d.to(torch.int64), seed)
    if isinstance(t, (dt.ByteType, dt.ShortType, dt.IntegerType,
                      dt.DateType)):
        return murmur3_int32(_u32(d.to(torch.int32)), seed)
    if isinstance(t, (dt.LongType, dt.TimestampType)) or (
            isinstance(t, dt.DecimalType) and not dt.is_wide_decimal(t)):
        # a decimal of precision <= 18 hashes as its unscaled long (Spark
        # and the reference's ``:95,240-247``)
        return murmur3_int64(*_split64(d), seed)
    if isinstance(t, dt.FloatType):
        return murmur3_int32(_u32(_canonical(d).view(torch.int32)), seed)
    if isinstance(t, dt.DoubleType):
        return murmur3_int64(*_split64(_canonical(d).view(torch.int64)),
                             seed)
    raise NotImplementedError(
        f"hash of {t.simple_string()} is not ported yet (ROADMAP item 2: "
        "a decimal past 18 digits hashes its BigInteger's bytes in Spark)")


def murmur3_bytes_seeded(offsets: torch.Tensor, chars: torch.Tensor,
                         seed: torch.Tensor) -> torch.Tensor:
    """Each row's bytes hashed with its own running seed: 4-byte
    little-endian blocks, then each tail byte sign-extended on its own
    (Spark's ``hashUnsafeBytes``), then the length mixed in."""
    n = offsets.shape[0] - 1
    starts = offsets[:-1].to(torch.int64)
    lens = offsets[1:].to(torch.int64) - starts
    nblocks = lens // 4
    limit = chars.shape[0] - 1

    def byte(pos: torch.Tensor) -> torch.Tensor:
        if limit < 0:
            return torch.zeros_like(pos)
        return chars[pos.clamp(0, limit)].to(torch.int64)

    h = seed
    max_blocks = int(nblocks.max()) if n else 0
    for b in range(max_blocks):
        base = starts + 4 * b
        w = byte(base) | (byte(base + 1) << 8) | (byte(base + 2) << 16) \
            | (byte(base + 3) << 24)
        h = torch.where(b < nblocks, _mix_h1(h, _mix_k1(w)), h)
    for t in range(3):
        pos = nblocks * 4 + t
        k = byte(starts + pos)
        k = torch.where(k >= 128, k - 256, k) & _M
        h = torch.where(pos < lens, _mix_h1(h, _mix_k1(k)), h)
    return _fmix(h, lens & _M)


def hash_column(col: GpuColumnVector, seed: torch.Tensor) -> torch.Tensor:
    """One column's step of the running hash; a null row keeps the
    incoming seed."""
    if col.is_string_like:
        h = murmur3_bytes_seeded(col.offsets, col.chars, seed)
    elif col.is_list:
        h = _hash_elements(col, seed)
    elif col.children is not None:
        h = seed
        for ch in col.children:
            h = hash_column(ch, h)
    else:
        h = _hash_fixed(col, seed)
    if col.validity is None:
        return h
    return torch.where(col.validity, h, seed)


def _hash_elements(col: GpuColumnVector, seed: torch.Tensor) \
        -> torch.Tensor:
    """An array's or a map's elements folded into the running seed in
    order, position by position."""
    from .gather import gather_columns
    starts = col.offsets[:-1]
    lens = col.offsets[1:] - starts
    h = seed
    ecap = col.children[0].capacity
    for k in range(int(lens.max()) if lens.numel() and ecap else 0):
        has = lens > k
        idx = (starts + k).clamp(0, ecap - 1).to(torch.int32)
        for elem in gather_columns(col.children, idx, has):
            h = hash_column(elem, h)
    return h


def hash_columns(cols: Sequence[GpuColumnVector]) -> torch.Tensor:
    """Spark's ``hash(cols...)`` as int32: seed 42 threaded through the
    columns."""
    n = cols[0].capacity
    h = torch.full((n,), SEED, dtype=torch.int64, device=cols[0].device)
    for c in cols:
        h = hash_column(c, h)
    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)


def pmod(h: torch.Tensor, n: int) -> torch.Tensor:
    """Spark's positive modulo of int32 hashes: partition ids in
    ``[0, n)``."""
    r = torch.remainder(h.to(torch.int64), n)
    return r.to(torch.int32)
