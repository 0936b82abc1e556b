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
where the planner places them).
"""
from __future__ import annotations

import ctypes
import datetime
import decimal
from typing import Optional, Sequence

import numpy as np
import torch

from .. import datatypes as dt
from ..columnar.column import GpuColumnVector

__all__ = ["SEED", "murmur3_int32", "murmur3_int64", "hash_column",
           "hash_columns", "murmur3_bytes_seeded", "pmod", "XXSEED",
           "xxhash64_long", "xxhash64_int", "xxhash64_column",
           "xxhash64_columns", "xxhash64_strings", "xxhash64_strings_torch",
           "xxhash64_columns_numpy", "xxhash64_long_np", "murmur3_long_np",
           "murmur3_bytes_np"]

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


# --- xxhash64 ---------------------------------------------------------------

_U64 = (1 << 64) - 1
_XP1 = 0x9E3779B185EBCA87
_XP2 = 0xC2B2AE3D27D4EB4F
_XP3 = 0x165667B19E3779F9
_XP4 = 0x85EBCA77C2B2AE63
_XP5 = 0x27D4EB2F165667C5
XXSEED = 42


def _s64(v: int) -> int:
    """A uint64 constant as the int64 with its bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


_SP1, _SP2, _SP3, _SP4, _SP5 = (_s64(v) for v in (_XP1, _XP2, _XP3, _XP4,
                                                  _XP5))


def _lsr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int64 lanes holding uint64 bits."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _lsr(x, 64 - r)


def _xx_avalanche(h: torch.Tensor) -> torch.Tensor:
    h = (h ^ _lsr(h, 33)) * _SP2
    h = (h ^ _lsr(h, 29)) * _SP3
    return h ^ _lsr(h, 32)


def xxhash64_long(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Spark's ``hashLong``: ``v`` the 8 bytes as int64 bits."""
    h = seed + (_SP5 + 8)
    h = h ^ (_rotl64(v * _SP2, 31) * _SP1)
    return _xx_avalanche(_rotl64(h, 27) * _SP1 + _SP4)


def xxhash64_int(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Spark's ``hashInt``: ``v`` the 4 bytes zero-extended to int64."""
    h = seed + (_SP5 + 4)
    h = h ^ (v * _SP1)
    return _xx_avalanche(_rotl64(h, 23) * _SP2 + _SP3)


def _xx_fixed(col: GpuColumnVector, seed: torch.Tensor) -> torch.Tensor:
    t, d = col.dtype, col.data
    if isinstance(t, dt.BooleanType):
        return xxhash64_int(d.to(torch.int64), seed)
    if isinstance(t, (dt.ByteType, dt.ShortType, dt.IntegerType,
                      dt.DateType)):
        return xxhash64_int(_u32(d.to(torch.int32)), seed)
    if isinstance(t, (dt.LongType, dt.TimestampType)) or (
            isinstance(t, dt.DecimalType) and not dt.is_wide_decimal(t)):
        return xxhash64_long(d.to(torch.int64), seed)
    if isinstance(t, dt.FloatType):
        return xxhash64_int(_u32(_canonical(d).view(torch.int32)), seed)
    if isinstance(t, dt.DoubleType):
        return xxhash64_long(_canonical(d).view(torch.int64), seed)
    raise NotImplementedError(
        f"xxhash64 of {t.simple_string()} is not ported yet (ROADMAP item "
        "2: a decimal past 18 digits hashes its BigInteger's bytes in "
        "Spark)")


def xxhash64_strings_torch(offsets: torch.Tensor, chars: torch.Tensor,
                           seed: torch.Tensor,
                           validity: Optional[torch.Tensor] = None) \
        -> torch.Tensor:
    """K7's function in plain PyTorch, the reference's masked loops: each
    row's XXH64 from its incoming ``seed``, ``seed`` itself where
    ``validity`` is False. One readback (the longest row's stripes)."""
    n = offsets.shape[0] - 1
    starts = offsets[:-1].to(torch.int64)
    lens = offsets[1:].to(torch.int64) - starts
    limit = chars.shape[0] - 1

    def byte(pos: torch.Tensor) -> torch.Tensor:
        if limit < 0:
            return torch.zeros_like(pos)
        return chars[pos.clamp(0, limit)].to(torch.int64)

    def word(base: torch.Tensor, size: int) -> torch.Tensor:
        w = torch.zeros_like(base)
        for k in range(size):
            w = w | (byte(base + k) << (8 * k))
        return w

    sd = seed.to(torch.int64)
    a = [sd + _s64(_XP1 + _XP2), sd + _SP2, sd.clone(),
         sd - _SP1]
    nstripes = lens >> 5
    for s in range(int(nstripes.max()) if n else 0):
        on = s < nstripes
        for k in range(4):
            w = word(starts + 32 * s + 8 * k, 8)
            a[k] = torch.where(on, _rotl64(a[k] + w * _SP2, 31) * _SP1, a[k])
    merged = (_rotl64(a[0], 1) + _rotl64(a[1], 7) + _rotl64(a[2], 12)
              + _rotl64(a[3], 18))
    for acc in a:
        merged = (merged ^ (_rotl64(acc * _SP2, 31) * _SP1)) * _SP1 + _SP4
    h = torch.where(lens >= 32, merged, sd + _SP5) + lens
    pos = nstripes << 5
    for _ in range(3):
        on = pos + 8 <= lens
        k = word(starts + pos, 8)
        h2 = _rotl64(h ^ (_rotl64(k * _SP2, 31) * _SP1), 27) * _SP1 + _SP4
        h = torch.where(on, h2, h)
        pos = torch.where(on, pos + 8, pos)
    on = pos + 4 <= lens
    h2 = _rotl64(h ^ (word(starts + pos, 4) * _SP1), 23) * _SP2 + _SP3
    h = torch.where(on, h2, h)
    pos = torch.where(on, pos + 4, pos)
    for _ in range(3):
        on = pos < lens
        h2 = _rotl64(h ^ (byte(starts + pos) * _SP5), 11) * _SP1
        h = torch.where(on, h2, h)
        pos = torch.where(on, pos + 1, pos)
    h = _xx_avalanche(h)
    return h if validity is None else torch.where(validity, h, sd)


def _xx_library():
    from ._build import load
    lib = load("xxhash64")
    if not getattr(lib, "_spark_ready", False):
        lib.spark_xxhash64_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p]
        lib.spark_xxhash64_launch.restype = ctypes.c_int
        lib._spark_ready = True
    return lib


def xxhash64_strings(offsets: torch.Tensor, chars: torch.Tensor,
                     seed: torch.Tensor,
                     validity: Optional[torch.Tensor] = None) \
        -> torch.Tensor:
    """K7: ``(n,)`` int64, each row's XXH64 over its bytes from its
    incoming ``seed`` (int64 bits), the seed itself on a null row.
    ``offsets`` int32 ``(n + 1,)``, ``chars`` uint8. A CPU input takes
    the plain version; a CUDA input launches the kernel once."""
    from .cuda_kernels import _on_cpu
    if _on_cpu([offsets, chars, seed, validity]):
        return xxhash64_strings_torch(offsets, chars, seed, validity)
    n = offsets.shape[0] - 1
    for t, want in ((offsets, torch.int32), (chars, torch.uint8),
                    (seed, torch.int64), (validity, torch.bool)):
        if t is None:
            continue
        if t.dtype != want or t.dim() != 1 or t.device != offsets.device:
            raise ValueError(f"K7 takes 1-D {want} on one device, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if seed.shape[0] != n or (validity is not None
                              and validity.shape[0] != n):
        raise ValueError(f"K7's seed and validity must hold {n} rows")
    offsets, seed = offsets.contiguous(), seed.contiguous()
    chars = chars.contiguous()
    validity = None if validity is None else validity.contiguous()
    out = torch.empty(n, dtype=torch.int64, device=offsets.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(offsets.device).cuda_stream
    err = _xx_library().spark_xxhash64_launch(
        offsets.data_ptr(), chars.data_ptr() if chars.shape[0] else None,
        seed.data_ptr(), None if validity is None else validity.data_ptr(),
        out.data_ptr(), n, chars.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"xxhash64 kernel launch failed: cudaError {err}")
    xxhash64_strings.launches += 1
    return out


xxhash64_strings.launches = 0


def xxhash64_column(col: GpuColumnVector,
                    seed: torch.Tensor) -> torch.Tensor:
    """One column's step of the running xxhash64; a null row keeps the
    incoming seed."""
    if col.is_string_like:
        return xxhash64_strings(col.offsets, col.chars, seed, col.validity)
    if isinstance(col.dtype, dt.NullType):
        return seed
    h = _xx_fixed(col, seed)
    return h if col.validity is None else torch.where(col.validity, h, seed)


def xxhash64_columns(cols: Sequence[GpuColumnVector]) -> torch.Tensor:
    """Spark's ``xxhash64(cols...)`` as int64: seed 42 threaded through
    the columns."""
    h = torch.full((cols[0].capacity,), XXSEED, dtype=torch.int64,
                   device=cols[0].device)
    for c in cols:
        h = xxhash64_column(c, h)
    return h


# --- the host oracles ---------------------------------------------------------
# numpy and Python ints, independent of the torch paths and the kernels:
# the reference's pure-Python XXH64 (``:469-598``) and Murmur3 over
# numpy uint32 lanes

def _fmix32_np(h, length):
    with np.errstate(over="ignore"):
        h = h ^ np.asarray(length, np.uint32)
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85ebca6b)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xc2b2ae35)
        return h ^ (h >> np.uint32(16))


def _mix_np(h, k):
    def rotl(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))
    k = rotl(k * np.uint32(_C1), 15) * np.uint32(_C2)
    return rotl(h ^ k, 13) * np.uint32(5) + np.uint32(0xe6546b64)


def murmur3_long_np(v, seed) -> np.ndarray:
    """Murmur3_x86_32 (Spark's hashLong: low word, then high) of int64
    values under a uint32 seed, a scalar or an array, as uint32."""
    u = np.asarray(v, np.int64).view(np.uint64)
    with np.errstate(over="ignore"):
        h = np.broadcast_to(np.asarray(seed, np.uint32), u.shape).copy()
        h = _mix_np(h, (u & np.uint64(_M)).astype(np.uint32))
        h = _mix_np(h, (u >> np.uint64(32)).astype(np.uint32))
        return _fmix32_np(h, 8)


def murmur3_bytes_np(b: bytes, seed: int) -> int:
    """Spark's hashUnsafeBytes of one string's bytes from ``seed``: whole
    4-byte words, then each tail byte sign-extended."""
    h = np.uint32(seed)
    nb = len(b) // 4
    with np.errstate(over="ignore"):
        for i in range(nb):
            h = _mix_np(h, np.uint32(int.from_bytes(b[4 * i:4 * i + 4],
                                                    "little")))
        for t in range(nb * 4, len(b)):
            h = _mix_np(h, np.uint32((b[t] - 256 if b[t] >= 128 else b[t])
                                     & _M))
    return int(_fmix32_np(h, len(b)))


def _rotl64_np(x, r):
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def xxhash64_long_np(v, seed) -> np.ndarray:
    """Spark's hashLong of 64-bit values (int64 or uint64, a scalar or
    an array) from a uint64 seed, a scalar or an array, as uint64."""
    p1, p2, p3, p4 = (np.uint64(x) for x in (_XP1, _XP2, _XP3, _XP4))
    with np.errstate(over="ignore"):
        v = np.asarray(v)
        v = v.view(np.uint64) if v.dtype == np.int64 else v.astype(np.uint64)
        h = np.asarray(seed, np.uint64) + np.uint64(_XP5 + 8)
        h = h ^ (_rotl64_np(v * p2, 31) * p1)
        h = _rotl64_np(h, 27) * p1 + p4
        h = (h ^ (h >> np.uint64(33))) * p2
        h = (h ^ (h >> np.uint64(29))) * p3
        return h ^ (h >> np.uint64(32))


def _rotl_int(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _U64


def _avalanche_int(h: int) -> int:
    h ^= h >> 33
    h = (h * _XP2) & _U64
    h ^= h >> 29
    h = (h * _XP3) & _U64
    return h ^ (h >> 32)


def _xx_bytes_np(b: bytes, seed: int) -> int:
    ln = len(b)
    if ln >= 32:
        accs = [(seed + _XP1 + _XP2) & _U64, (seed + _XP2) & _U64,
                seed & _U64, (seed - _XP1) & _U64]
        s = 0
        while s + 32 <= ln:
            for i in range(4):
                k = int.from_bytes(b[s + 8 * i: s + 8 * i + 8], "little")
                accs[i] = (_rotl_int((accs[i] + k * _XP2) & _U64, 31)
                           * _XP1) & _U64
            s += 32
        h = (_rotl_int(accs[0], 1) + _rotl_int(accs[1], 7)
             + _rotl_int(accs[2], 12) + _rotl_int(accs[3], 18)) & _U64
        for acc in accs:
            k = (_rotl_int((acc * _XP2) & _U64, 31) * _XP1) & _U64
            h = (((h ^ k) * _XP1) + _XP4) & _U64
        pos = (ln // 32) * 32
    else:
        h = (seed + _XP5) & _U64
        pos = 0
    h = (h + ln) & _U64
    while pos + 8 <= ln:
        k = int.from_bytes(b[pos: pos + 8], "little")
        h = (_rotl_int(h ^ ((_rotl_int((k * _XP2) & _U64, 31) * _XP1)
                            & _U64), 27) * _XP1 + _XP4) & _U64
        pos += 8
    if pos + 4 <= ln:
        k = int.from_bytes(b[pos: pos + 4], "little")
        h = ((_rotl_int(h ^ ((k * _XP1) & _U64), 23) * _XP2) + _XP3) & _U64
        pos += 4
    while pos < ln:
        h = (_rotl_int(h ^ ((b[pos] * _XP5) & _U64), 11) * _XP1) & _U64
        pos += 1
    return _avalanche_int(h)


def _xx_scalar_np(v, t: dt.DataType, seed: int) -> int:
    def hash_int(i32):
        h = (seed + _XP5 + 4) & _U64
        h = h ^ ((i32 & 0xFFFFFFFF) * _XP1) & _U64
        return _avalanche_int(((_rotl_int(h, 23) * _XP2) + _XP3) & _U64)

    def hash_long(l64):
        return int(xxhash64_long_np(l64 & _U64, seed))

    if isinstance(t, dt.BooleanType):
        return hash_int(1 if v else 0)
    if isinstance(t, (dt.ByteType, dt.ShortType, dt.IntegerType)):
        return hash_int(int(v) & 0xFFFFFFFF)
    if isinstance(t, dt.DateType):
        days = (v - datetime.date(1970, 1, 1)).days \
            if isinstance(v, datetime.date) else int(v)
        return hash_int(days & 0xFFFFFFFF)
    if isinstance(t, (dt.LongType, dt.TimestampType, dt.DecimalType)):
        if isinstance(t, dt.TimestampType) \
                and isinstance(v, datetime.datetime):
            if v.tzinfo is None:
                v = v.replace(tzinfo=datetime.timezone.utc)
            epoch = datetime.datetime(1970, 1, 1,
                                      tzinfo=datetime.timezone.utc)
            v = (v - epoch) // datetime.timedelta(microseconds=1)
        elif isinstance(t, dt.DecimalType):
            v = int(decimal.Decimal(v).scaleb(t.scale))
        return hash_long(int(v))
    if isinstance(t, dt.FloatType):
        f = np.float32(0.0) if v == 0 else np.float32(v)
        if np.isnan(f):
            f = np.float32(np.nan)
        return hash_int(int(f.view(np.uint32)))
    if isinstance(t, dt.DoubleType):
        f = np.float64(0.0) if v == 0 else np.float64(v)
        if np.isnan(f):
            f = np.float64(np.nan)
        return hash_long(int(f.view(np.uint64)))
    raise NotImplementedError(t.simple_string())


def xxhash64_columns_numpy(arrays, types: Sequence[dt.DataType],
                           n: int) -> np.ndarray:
    """Host oracle: the running-seed xxhash64 over pyarrow arrays, int64,
    one Python call a value."""
    h = [XXSEED] * n
    for arr, t in zip(arrays, types):
        vals = arr.to_pylist()
        stringy = isinstance(t, (dt.StringType, dt.BinaryType))
        for i in range(n):
            v = vals[i]
            if v is None:
                continue
            if stringy:
                b = v.encode() if isinstance(v, str) else bytes(v)
                h[i] = _xx_bytes_np(b, h[i])
            else:
                h[i] = _xx_scalar_np(v, t, h[i])
    return np.array(h, np.uint64).view(np.int64)
