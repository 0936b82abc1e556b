"""The port's q6 expressions and operators against the JAX package's, on
the CPU, over one batch made with numpy from a seed: the five
comparisons (NaN, +-0.0, nulls), Kleene AND, Multiply, and the ungrouped
Sum/Count (all rows filtered included). Booleans, products and counts
must be exact; sums agree to rel 1e-12 (float64, another order)."""
import numpy as np
import pytest
import torch
from torch_dual_run import assert_same_rows

import spark_rapids_tpu.datatypes as jdt
import spark_rapids_tpu.expr as jexpr
import spark_rapids_tpu_torch.datatypes as tdt
import spark_rapids_tpu_torch.expr as texpr
from spark_rapids_tpu.columnar import TpuBatch, TpuColumnVector
from spark_rapids_tpu.exec.aggregate import TpuHashAggregateExec
from spark_rapids_tpu.exec.base import (DeviceBatchSourceExec as JSource,
                                        ExecCtx as JCtx,
                                        collect_arrow as jcollect)
from spark_rapids_tpu.exec.basic import TpuFilterExec, TpuProjectExec
from spark_rapids_tpu.expr.aggregates import Count as JCount, Sum as JSum
from spark_rapids_tpu_torch.columnar import batch_from_numpy
from spark_rapids_tpu_torch.exec import (DeviceBatchSourceExec as TSource,
                                         ExecCtx as TCtx,
                                         GpuFilterExec, GpuHashAggregateExec,
                                         GpuProjectExec,
                                         collect_arrow as tcollect)

N = 1000
COLUMNS = [("f", "FLOAT32"), ("g", "FLOAT32"), ("x", "FLOAT64"),
           ("y", "FLOAT64"), ("p", "FLOAT32"), ("q", "FLOAT64"),
           ("i", "INT32"), ("j", "INT32"),
           ("d", "DATE"), ("b", "INT8"), ("c", "INT8"), ("l", "INT64"),
           ("m", "INT64")]
CMPS = ["EqualTo", "LessThan", "LessThanOrEqual", "GreaterThan",
        "GreaterThanOrEqual"]

JAX = dict(dt=jdt, E=jexpr, Sum=JSum, Count=JCount,
           Project=TpuProjectExec, Filter=TpuFilterExec,
           Agg=TpuHashAggregateExec)
TORCH = dict(dt=tdt, E=texpr, Sum=texpr.Sum, Count=texpr.Count,
             Project=GpuProjectExec, Filter=GpuFilterExec,
             Agg=GpuHashAggregateExec)


def _lanes(seed=7):
    rng = np.random.default_rng(seed)
    special = np.array([np.nan, 0.0, -0.0, 1.5, -1.5, np.inf, -np.inf])
    lanes = {}
    for name, t in COLUMNS:
        if name in ("p", "q"):  # finite, for the sums
            v = rng.normal(size=N) * 1000
            v = v.astype(np.float32 if t == "FLOAT32" else np.float64)
        elif t.startswith("FLOAT"):  # NaN, +-0.0, +-inf and ties
            v = rng.choice(special, N)
            some = rng.random(N) < 0.5
            v[some] = rng.normal(size=int(some.sum())).round(1)
            v = v.astype(np.float32 if t == "FLOAT32" else np.float64)
        elif t == "INT8":
            v = rng.integers(-128, 128, N).astype(np.int8)
        elif t == "INT64":
            v = rng.integers(-2**62, 2**62, N)
        else:
            v = rng.integers(-3, 4, N).astype(np.int32)
        lanes[name] = (v, rng.random(N) > 0.15)
    return lanes


def _schema(pkg):
    dt = pkg["dt"]
    return dt.Schema([dt.StructField(n, getattr(dt, t), True)
                      for n, t in COLUMNS])


def _jax_source(lanes):
    schema = _schema(JAX)
    cols = [TpuColumnVector.from_numpy(f.dtype, *lanes[f.name], 1024)
            for f in schema.fields]
    batch = TpuBatch(cols, schema, N)
    return JSource([batch], schema), batch


def _torch_source(jbatch):
    """The JAX batch's own lanes, padding included, fed to the port."""
    arrays = {f.name: (np.asarray(c.data), np.asarray(c.validity))
              for f, c in zip(jbatch.schema.fields, jbatch.columns)}
    schema = _schema(TORCH)
    return TSource([batch_from_numpy(arrays, schema, N, "cpu")], schema)


def _run(pkg, build):
    lanes = _lanes()
    jsrc, jbatch = _jax_source(lanes)
    if pkg is JAX:
        return jcollect(build(JAX, jsrc), JCtx())
    return tcollect(build(TORCH, _torch_source(jbatch)), TCtx(device="cpu"))


def _same_columns(a, b):
    """The reference's table ``a`` against the port's ``b``: names,
    Arrow types, nulls and every value exactly, in row order (the
    dual-run assert with floats exact)."""
    assert_same_rows(b, a, ordered=True, rtol=0.0)


def _literal(pkg, value, t):
    return pkg["E"].Literal(value, getattr(pkg["dt"], t))


@pytest.mark.parametrize("cmp", CMPS)
def test_comparisons_match_reference(cmp):
    def build(pkg, src):
        E, col = pkg["E"], pkg["E"].UnresolvedColumn
        op = getattr(E, cmp)
        exprs = [op(col("f"), col("g")), op(col("x"), col("y")),
                 op(col("i"), col("j")), op(col("b"), col("c")),
                 op(col("l"), col("m")),
                 op(col("f"), _literal(pkg, np.float32(0.0), "FLOAT32")),
                 op(col("f"), _literal(pkg, np.float32(-0.0), "FLOAT32")),
                 op(col("x"), _literal(pkg, float("nan"), "FLOAT64")),
                 op(_literal(pkg, 1.5, "FLOAT64"), col("y")),
                 op(col("d"), _literal(pkg, 1, "DATE")),
                 op(_literal(pkg, 0, "INT32"), col("i"))]
        return pkg["Project"]([E.Alias(e, f"e{k}")
                               for k, e in enumerate(exprs)], src)

    _same_columns(_run(JAX, build), _run(TORCH, build))


def test_and_is_kleene_like_reference():
    def build(pkg, src):
        E, col = pkg["E"], pkg["E"].UnresolvedColumn
        lt = E.LessThan(col("f"), col("g"))
        ge = E.GreaterThanOrEqual(col("i"), col("j"))
        eq = E.EqualTo(col("x"), _literal(pkg, 0.0, "FLOAT64"))
        exprs = [E.And(lt, ge), E.And(ge, eq), E.And(E.And(lt, ge), eq)]
        return pkg["Project"]([E.Alias(e, f"e{k}")
                               for k, e in enumerate(exprs)], src)

    _same_columns(_run(JAX, build), _run(TORCH, build))


def test_multiply_matches_reference():
    def build(pkg, src):
        E, col = pkg["E"], pkg["E"].UnresolvedColumn
        exprs = [E.Multiply(col("f"), col("g")),
                 E.Multiply(col("x"), col("y")),
                 E.Multiply(col("i"), col("j")),
                 E.Multiply(col("b"), col("c")),   # int8 wraps
                 E.Multiply(col("l"), col("m"))]   # int64 wraps
        return pkg["Project"]([E.Alias(e, f"p{k}")
                               for k, e in enumerate(exprs)], src)

    _same_columns(_run(JAX, build), _run(TORCH, build))


@pytest.mark.parametrize("bound", [0, 99])
def test_filtered_sum_and_count_match_reference(bound):
    """bound=99 filters every row out: sums are null, counts 0."""
    def build(pkg, src):
        E, col = pkg["E"], pkg["E"].UnresolvedColumn
        cond = E.LessThan(col("i"), _literal(pkg, 3 - bound, "INT32"))
        filt = pkg["Filter"](cond, src)
        return pkg["Agg"]([], [
            E.Alias(pkg["Sum"](col("f")), "sf"),
            E.Alias(pkg["Sum"](col("p")), "sp"),
            E.Alias(pkg["Sum"](col("q")), "sq"),
            E.Alias(pkg["Sum"](col("l")), "sl"),
            E.Alias(pkg["Count"](col("g")), "cg"),
            E.Alias(pkg["Count"](), "n")], filt)

    want, got = _run(JAX, build), _run(TORCH, build)
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows == 1
    w, g = want.to_pylist()[0], got.to_pylist()[0]
    assert (g["cg"], g["n"], g["sl"]) == (w["cg"], w["n"], w["sl"])
    for k in ("sf", "sp", "sq"):
        if w[k] is None or w[k] != w[k] or abs(w[k]) == float("inf"):
            assert repr(g[k]) == repr(w[k]), k
        else:
            assert abs(g[k] - w[k]) <= 1e-12 * max(1.0, abs(w[k])), k
    if bound:
        assert g["sp"] is None and g["n"] == 0
    else:
        assert g["sp"] is not None and g["sf"] != g["sf"]  # NaN kept


def test_q6_chain_over_batch_matches_reference():
    """Filter -> Project(a * b) -> Sum over one device batch: the chain
    the port routes to K1's wrapper."""
    def build(pkg, src):
        E, col = pkg["E"], pkg["E"].UnresolvedColumn
        cond = E.And(
            E.GreaterThanOrEqual(col("f"), _literal(pkg, np.float32(-1.5),
                                                    "FLOAT32")),
            E.LessThan(col("i"), _literal(pkg, 2, "INT32")))
        proj = pkg["Project"]([E.Alias(E.Multiply(col("p"), col("p")),
                                       "rev")], pkg["Filter"](cond, src))
        return pkg["Agg"]([], [E.Alias(pkg["Sum"](col("rev")), "s")],
                          proj)

    want = _run(JAX, build).column("s")[0].as_py()
    lanes = _lanes()
    _, jbatch = _jax_source(lanes)
    ctx = TCtx(device="cpu")
    got = tcollect(build(TORCH, _torch_source(jbatch)), ctx)
    dispatches = [m["kernelDispatches"].value for m in ctx.metrics.values()
                  if "kernelDispatches" in m]
    assert dispatches == [1]
    got = got.column("s")[0].as_py()
    assert np.isfinite(want)
    assert abs(got - want) <= 1e-12 * max(1.0, abs(want))


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        assert TCtx().device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TCtx()
