"""Shared inputs and the dual evaluation of the SQL function tests
(``tests/test_torch_functions_*.py``, ``tests/test_torch_moments.py``).

``eval_both(rb, build_port, build_ref, host=False)`` binds one
expression of each package over the same Arrow batch and evaluates it:
the port's ``eval_gpu`` on CPU tensors (its device path) against the
reference's ``eval_tpu`` on JAX's CPU backend, or with ``host`` the
port's ``eval_cpu`` (its host path) against the reference's
``eval_cpu``. ``same`` compares two Arrow arrays: equal types, nulls
where the other has them, values exact, or for floats within ``rtol``
(NaN equal to NaN, ``-0.0`` equal to ``0.0``).

The inputs come from numpy with a seed and carry the edges the SQL
functions meet: NaN, +-inf, -0.0, huge and tiny magnitudes, the integer
lanes' bounds (INT64_MIN), empty strings, spaces, non-ASCII strings,
leap days, dates before 1970 and years past 9999, and nulls.
"""
import math

import numpy as np
import pyarrow as pa
import torch

import spark_rapids_tpu.datatypes as jdt
import spark_rapids_tpu_torch.datatypes as tdt
from spark_rapids_tpu.columnar import TpuBatch
from spark_rapids_tpu.columnar import arrow_to_device as j_upload
from spark_rapids_tpu.columnar import device_to_arrow as j_download
from spark_rapids_tpu.expr.base import EvalCtx as JEval
from spark_rapids_tpu.expr.base import UnresolvedColumn as JCol
from spark_rapids_tpu.expr.base import bind_expr as jbind
from spark_rapids_tpu_torch.columnar import GpuBatch
from spark_rapids_tpu_torch.columnar import arrow_to_device as t_upload
from spark_rapids_tpu_torch.columnar import device_to_arrow as t_download
from spark_rapids_tpu_torch.expr.base import EvalCtx as TEval
from spark_rapids_tpu_torch.expr.base import UnresolvedColumn as TCol
from spark_rapids_tpu_torch.expr.base import bind_expr as tbind

#: floats: relative tolerance unless a test says why not
FLOAT_RTOL = 1e-9

SPECIAL_FLOATS = [math.nan, math.inf, -math.inf, 0.0, -0.0, 1.0, -1.0, 0.5,
                  -0.5, 1.5, 2.5, -2.5, 0.125, 1e-300, -1e-300, 5e-324,
                  1e19, -1e19, 9.3e18, -9.3e18, 1e300, -1e300, 0.1, 0.7,
                  1.005, 2.675, 12345.6789, -98765.4321]

SPECIAL_INTS = [0, 1, -1, 5, -5, 15, -15, 25, -25, 95, 1000, 123456789,
                -(1 << 63), (1 << 63) - 1, (1 << 31) - 1, -(1 << 31)]

SPECIAL_STRINGS = ["", " ", "  a  ", "abc", "Books", "Electronics", "é",
                   "café", "naïve résumé", "日本語", "ÀÉÎ", "a\tb",
                   "x" * 80, "MiXeD cAsE", "  leading", "trailing  ",
                   "ab" * 40 + "é", "Sports", "🙂ok"]

#: leap days, month ends, dates before 1970 and past 9999 (days since
#: 1970-01-01)
SPECIAL_DAYS = [0, -1, 59, 789, 10956, 11016, 11017, 11047, -25567, -719162,
                2932896, 2932897, 11322, 11323, 10987, 10988, -3653, 18321,
                18322, 19417, 19782]


def floats(n: int, rng, specials=True) -> np.ndarray:
    v = rng.normal(size=n) * 10.0 ** rng.integers(-3, 8, n)
    if specials:
        pick = rng.random(n) < 0.35
        v[pick] = rng.choice(np.array(SPECIAL_FLOATS), int(pick.sum()))
    return v


def ints(n: int, rng, lo=-(1 << 63), hi=(1 << 63) - 1) -> np.ndarray:
    v = rng.integers(lo, hi, n, endpoint=True, dtype=np.int64)
    pick = rng.random(n) < 0.4
    v[pick] = rng.choice(np.array(SPECIAL_INTS, np.int64), int(pick.sum()))
    small = rng.random(n) < 0.3
    v[small] = rng.integers(-200, 201, int(small.sum()))
    return np.clip(v, lo, hi)


def strings(n: int, rng) -> list:
    words = SPECIAL_STRINGS + ["Jewelry", "Home", "Music", "o", "oo"]
    return [str(w) for w in rng.choice(np.array(words, dtype=object), n)]


def days(n: int, rng) -> np.ndarray:
    v = rng.integers(-30000, 40000, n)
    pick = rng.random(n) < 0.4
    v[pick] = rng.choice(np.array(SPECIAL_DAYS), int(pick.sum()))
    return v.astype(np.int32)


def batch(columns: dict, seed: int = 0, null_share: float = 0.15):
    """An Arrow batch of ``{name: (arrow type, values)}`` with nulls at
    random (``null_share``)."""
    rng = np.random.default_rng(seed)
    arrays = []
    for t, v in columns.values():
        mask = rng.random(len(v)) < null_share
        if pa.types.is_date32(t):
            arrays.append(pa.array(np.asarray(v, np.int32), pa.int32(),
                                   mask=mask).view(pa.date32()))
        elif pa.types.is_timestamp(t):
            arrays.append(pa.array(np.asarray(v, np.int64), pa.int64(),
                                   mask=mask).view(t))
        else:
            arrays.append(pa.array(list(v) if pa.types.is_string(t) else v,
                                   t, mask=mask))
    return pa.record_batch(arrays, names=list(columns))


def eval_both(rb: pa.RecordBatch, build_port, build_ref, host=False,
              ansi=False):
    """(the port's Arrow array, the reference's): ``build_*(col)`` gets a
    function from a column name to a bound column reference."""
    tb = t_upload(rb, None, torch.device("cpu"))
    te = tbind(build_port(lambda name: tbind(TCol(name), tb.schema)),
               tb.schema)
    if host:
        got = te.eval_cpu(rb, TEval(ansi=ansi))
    else:
        tc = te.eval_gpu(tb, TEval(ansi=ansi))
        got = t_download(GpuBatch([tc], tdt.Schema(
            [tdt.StructField("r", te.dtype, True)]), rb.num_rows)).column(0)
    if build_ref is None:
        return got, None
    jb = j_upload(rb)
    je = jbind(build_ref(lambda name: jbind(JCol(name), jb.schema)),
               jb.schema)
    if host:
        want = je.eval_cpu(rb, JEval(ansi=ansi))
    else:
        jc = je.eval_tpu(jb, JEval(ansi=ansi))
        want = j_download(TpuBatch([jc], jdt.Schema(
            [jdt.StructField("r", je.dtype, True)]), rb.num_rows)).column(0)
    return got, want


def port_only(rb, build_port, host=False, ansi=False) -> pa.Array:
    return eval_both(rb, build_port, None, host, ansi)[0]


def _values(arr) -> list:
    """Python values; a date as its day number (Python's dates stop at
    year 9999)."""
    if pa.types.is_date32(arr.type):
        return arr.cast(pa.int32()).to_pylist()
    if pa.types.is_timestamp(arr.type):
        return arr.cast(pa.int64()).to_pylist()
    return arr.to_pylist()


def _close(a, b, rtol) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b or (rtol > 0 and math.isclose(a, b, rel_tol=rtol))
    return a == b


def same(got: pa.Array, want, rtol: float = FLOAT_RTOL, where=None):
    """``got`` against ``want`` (an Arrow array or a list of Python
    values), row by row; ``where`` (a list of bools) restricts the rows
    compared."""
    if isinstance(want, (pa.Array, pa.ChunkedArray)):
        assert got.type == want.type, (got.type, want.type)
        want = _values(want)
    g = _values(got)
    assert len(g) == len(want), (len(g), len(want))
    for i, (a, b) in enumerate(zip(g, want)):
        if where is not None and not where[i]:
            continue
        if a is None or b is None:
            assert a is None and b is None, (i, a, b)
        else:
            assert _close(a, b, rtol), (i, a, b)
