"""``hash`` (Murmur3) and ``xxhash64`` on the CPU against the JAX
package: ``Murmur3Hash`` and ``XxHash64`` of each package over one
seeded Arrow batch (``torch_function_cases.eval_both``: the port's
``eval_gpu`` on CPU tensors, which takes K7's plain version, against the
reference's ``eval_tpu`` on JAX's CPU backend, and both host paths),
over every fixed-width type (booleans, bytes, shorts, ints, dates,
longs, timestamps, ``decimal(12,2)``, floats and doubles with -0.0 and
NaN), strings of 0-100 bytes (under and over the 32-byte stripe,
non-ASCII) and nulls, chained in one running seed; bit for bit. K7's
plain version and the port's numpy host copy
(``ops/hash.xxhash64_columns_numpy``) are held to each other, to the
reference's host oracle and, where the ``xxhash`` package is installed,
to XXH64 itself.
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.datatypes as jdt
import spark_rapids_tpu.expr as jexpr
import spark_rapids_tpu_torch.datatypes as tdt
import spark_rapids_tpu_torch.expr as texpr
from spark_rapids_tpu.ops import hash as jhash
from spark_rapids_tpu_torch.ops import hash as thash
from torch_function_cases import batch, days, eval_both, floats, ints

N = 400

FIXED = {
    "b": (pa.bool_(), None),
    "i8": (pa.int8(), (-128, 127)),
    "i16": (pa.int16(), (-(1 << 15), (1 << 15) - 1)),
    "i32": (pa.int32(), (-(1 << 31), (1 << 31) - 1)),
    "i64": (pa.int64(), (-(1 << 63), (1 << 63) - 1)),
    "f32": (pa.float32(), None),
    "f64": (pa.float64(), None),
    "d": (pa.date32(), None),
    "ts": (pa.timestamp("us", tz="UTC"), None),
    "dec": (pa.decimal128(12, 2), None),
}


def _strings(rng, n):
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 101))
        raw = bytes(rng.integers(32, 127, k, dtype=np.uint8))
        if rng.random() < 0.2:
            raw = (raw[:k // 2].decode() + "é日").encode()
        out.append(raw.decode())
    out[:4] = ["", "a" * 31, "b" * 32, "c" * 33]
    return out


def _columns(seed=0):
    rng = np.random.default_rng(seed)
    cols = {}
    for name, (t, rng_bounds) in FIXED.items():
        if name == "b":
            v = rng.random(N) < 0.5
        elif name in ("f32", "f64"):
            v = floats(N, rng)
            if name == "f32":
                v = np.clip(v, -3e38, 3e38).astype(np.float32)
        elif name == "d":
            # within Python's dates, which the host oracles read
            v = np.clip(days(N, rng), -719162, 2932896)
        elif name == "ts":
            v = rng.integers(-(1 << 50), 1 << 50, N)
        elif name == "dec":
            import decimal
            v = [decimal.Decimal(int(x)).scaleb(-2)
                 for x in rng.integers(-10**12 + 1, 10**12, N)]
        else:
            lo, hi = rng_bounds
            v = ints(N, rng, lo, hi)
        cols[name] = (t, v)
    cols["s"] = (pa.string(), _strings(rng, N))
    return batch(cols, seed=seed + 1)


@pytest.fixture(scope="module")
def rb():
    return _columns()


NAMES = list(FIXED) + ["s"]


def _normal_rows(rb):
    """Rows whose floats are not subnormal: the reference's device path
    (XLA on the CPU) flushes a subnormal to zero before it hashes, where
    Spark and the reference's host path hash its bits (ROADMAP queue
    C); the port hashes its bits on either path."""
    keep = np.ones(rb.num_rows, bool)
    for name, tiny in (("f32", np.finfo(np.float32).tiny),
                       ("f64", np.finfo(np.float64).tiny)):
        v = rb.column(name).to_numpy(zero_copy_only=False)
        keep &= ~((v != 0) & (np.abs(v) < tiny))
    return pa.array(keep)


@pytest.mark.parametrize("fn", ["Murmur3Hash", "XxHash64"])
@pytest.mark.parametrize("name", NAMES)
def test_one_column_matches_the_reference(rb, fn, name):
    """The host paths on every row; the device paths on every row but a
    subnormal float's (``_normal_rows``)."""
    for host in (False, True):
        got, want = eval_both(
            rb, lambda c: getattr(texpr, fn)(c(name)),
            lambda c: getattr(jexpr, fn)(c(name)), host=host)
        assert got.type == want.type
        keep = pa.array(np.ones(rb.num_rows, bool)) if host \
            else _normal_rows(rb)
        assert got.filter(keep).equals(want.filter(keep)), (fn, name, host)


@pytest.mark.parametrize("fn", ["Murmur3Hash", "XxHash64"])
def test_every_column_in_one_running_seed(rb, fn):
    """All the columns, strings in the middle: each null keeps the seed
    it meets; the device path's every row equal to the reference's host
    path."""
    order = NAMES[:5] + ["s"] + NAMES[5:-1]
    for host in (False, True):
        got, want = eval_both(
            rb, lambda c: getattr(texpr, fn)(*[c(n) for n in order]),
            lambda c: getattr(jexpr, fn)(*[c(n) for n in order]),
            host=host)
        keep = _normal_rows(rb)
        assert got.filter(keep).equals(want.filter(keep)), (fn, host)
        assert got.null_count == 0
    device, _ = eval_both(
        rb, lambda c: getattr(texpr, fn)(*[c(n) for n in order]), None)
    assert device.equals(want)


@pytest.mark.parametrize("fn", ["Murmur3Hash", "XxHash64"])
def test_a_subnormal_float_hashes_its_bits(fn):
    """Spark hashes a subnormal by its bits, as the reference's host path
    does; the port's device path does too (the reference's flushes it to
    zero)."""
    rb = pa.record_batch([pa.array([5e-324, -2.2e-308, 0.0, None]),
                          pa.array([1e-45, 0.0, -1e-40, 1.0],
                                   pa.float32())], names=["f64", "f32"])
    for cols in (["f64"], ["f32"], ["f64", "f32"]):
        device, _ = eval_both(
            rb, lambda c: getattr(texpr, fn)(*[c(n) for n in cols]), None)
        _, host = eval_both(
            rb, lambda c: getattr(texpr, fn)(*[c(n) for n in cols]),
            lambda c: getattr(jexpr, fn)(*[c(n) for n in cols]), host=True)
        assert device.equals(host), (fn, cols)


def test_hash_refuses_a_nested_column():
    from spark_rapids_tpu_torch.expr.base import BoundReference
    e = texpr.XxHash64(BoundReference(0, tdt.ArrayType(tdt.INT32)))
    with pytest.raises(TypeError):
        e.validate()


def _string_parts(values, shift=0):
    raw = [v.encode() if v is not None else b"" for v in values]
    offsets = shift + np.concatenate([[0], np.cumsum([len(r) for r in raw])])
    chars = np.frombuffer(b"x" * shift + b"".join(raw) + b"yz", np.uint8)
    return (torch.from_numpy(offsets.astype(np.int32)),
            torch.from_numpy(chars.copy()))


@pytest.mark.parametrize("shift", [0, 3, 7])
def test_k7_plain_version_matches_the_host_copies(shift):
    """K7's plain version, from a running seed, against the port's numpy
    host copy and the reference's host oracle, with rows inside an
    inherited buffer (the first offset past 0) and nulls."""
    rng = np.random.default_rng(shift)
    vals = [None if rng.random() < 0.1 else v for v in _strings(rng, 300)]
    ints32 = pa.array(rng.integers(-(1 << 31), 1 << 31, 300, dtype=np.int64)
                      .astype(np.int32))
    seed = torch.from_numpy(thash.xxhash64_columns_numpy(
        [ints32], [tdt.INT32], 300))
    offsets, chars = _string_parts(vals, shift)
    valid = torch.tensor([v is not None for v in vals])
    got = thash.xxhash64_strings_torch(offsets, chars, seed, valid).numpy()
    arrays = [ints32, pa.array(vals, pa.string())]
    port = thash.xxhash64_columns_numpy(arrays, [tdt.INT32, tdt.STRING], 300)
    ref = jhash.xxhash64_columns_numpy(arrays, [jdt.INT32, jdt.STRING], 300)
    assert (got == port).all()
    assert (port == ref).all()
    assert thash.xxhash64_strings(offsets, chars, seed, valid).equal(
        torch.from_numpy(got))  # a CPU tensor takes the plain version


def test_xxh64_itself():
    """The host copy against the xxhash package's XXH64 (seed 42), bytes
    of every length around the stripe and the tails."""
    xxhash = pytest.importorskip("xxhash")
    rng = np.random.default_rng(5)
    for n in list(range(0, 70)) + [100, 255, 1000]:
        b = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        assert thash._xx_bytes_np(b, 42) == xxhash.xxh64(b, seed=42) \
            .intdigest()
        offsets = torch.tensor([0, n], dtype=torch.int32)
        chars = torch.from_numpy(np.frombuffer(b, np.uint8).copy())
        h = thash.xxhash64_strings_torch(
            offsets, chars, torch.tensor([42], dtype=torch.int64))
        assert int(h[0]) & ((1 << 64) - 1) == xxhash.xxh64(
            b, seed=42).intdigest()


def test_host_oracles_equal_the_torch_paths():
    """``murmur3_long_np``/``murmur3_bytes_np`` and ``xxhash64_long_np``
    (the numpy host oracles the sample and the DataFrame texts' checks
    share) against the torch hashes, over int64 extremes and running seeds, and strings of 0-100 bytes with
    non-ASCII tails; bit for bit."""
    rng = np.random.default_rng(11)
    v = np.concatenate([rng.integers(-(1 << 63), (1 << 63) - 1, 500,
                                     dtype=np.int64),
                        np.array([0, -1, 1 << 62, -(1 << 63),
                                  (1 << 63) - 1], np.int64)])
    seed = rng.integers(0, 1 << 32, len(v), dtype=np.int64)
    tv, ts = torch.from_numpy(v), torch.from_numpy(seed)
    m = thash.murmur3_int64(tv & 0xFFFFFFFF, (tv >> 32) & 0xFFFFFFFF, ts)
    assert (thash.murmur3_long_np(v, seed.astype(np.uint32)).astype(np.int64)
            == m.numpy()).all()
    xs = rng.integers(-(1 << 63), (1 << 63) - 1, len(v), dtype=np.int64)
    x = thash.xxhash64_long(tv, torch.from_numpy(xs))
    assert (thash.xxhash64_long_np(v, xs.view(np.uint64)).view(np.int64)
            == x.numpy()).all()
    strs = [s.encode() for s in _strings(rng, 200)]
    offsets = np.concatenate([[0], np.cumsum([len(s) for s in strs])])
    h = thash.murmur3_bytes_seeded(
        torch.from_numpy(offsets.astype(np.int32)),
        torch.from_numpy(np.frombuffer(b"".join(strs), np.uint8).copy()),
        torch.from_numpy(seed[:200]))
    assert [thash.murmur3_bytes_np(s, int(sd))
            for s, sd in zip(strs, seed[:200])] == \
        [int(x) & 0xFFFFFFFF for x in h.tolist()]
