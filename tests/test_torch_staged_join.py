"""The staged join on the CPU: the port's ``GpuShuffledHashJoinExec`` and
its stage functions (``ops/join.py``: ``join_counts``, ``join_total``,
``join_output_bytes``, ``join_indices``) held to the JAX package's
``TpuShuffledHashJoinExec`` and ``spark_rapids_tpu.ops.join`` on the same
batches, made from a seed (``tests/data_gen.py``).

The cases are ``tests/test_join.py``'s matrix for the four join types
the port covers (inner, left_outer, left_semi, left_anti): int keys with
duplicates, null keys, string keys, long, date, timestamp and double
keys, float keys with NaN, -0.0 and nulls, several keys (one a string),
empty sides, a multi-batch stream, duplicate-heavy keys, a string
payload on both sides, an inner join with a condition, and the unique
hint: false with a build string column (it warns and goes staged), false
without one (the deferred check raises), and unchecked under
``verifyUniqueHint=false``. Tolerance: every value exact, floats
included (a join moves values, it does not add them), NaN equal to NaN,
the row order exact (both packages emit a stream row's matches in the
build's group order). The stage arrays are compared exactly: the group
ids, counts, build order and match flags whole, the output indices
where their valid masks are set, and the masks, totals and string bytes
whole."""
import math

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.exec.base as jbase
import spark_rapids_tpu.ops.join as jjoin
from spark_rapids_tpu.columnar.arrow_bridge import \
    arrow_to_device as j_to_device
from spark_rapids_tpu.exec.joins import TpuShuffledHashJoinExec
from spark_rapids_tpu.expr import GreaterThan as JGreaterThan
from spark_rapids_tpu.expr import UnresolvedColumn as jcol
from spark_rapids_tpu_torch.columnar.arrow_bridge import \
    arrow_to_device as t_to_device
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exec import base as tbase
from spark_rapids_tpu_torch.exec.joins import GpuShuffledHashJoinExec
from spark_rapids_tpu_torch.expr import GreaterThan as TGreaterThan
from spark_rapids_tpu_torch.expr import UnresolvedColumn as tcol
from spark_rapids_tpu_torch.ops import join as tjoin

from data_gen import (DateGen, DoubleGen, IntegerGen, LongGen, StringGen,
                      TimestampGen, gen_table)

JOIN_TYPES = ["inner", "left_outer", "left_semi", "left_anti"]


def _exact(got: pa.Table, want: pa.Table, label=""):
    """Names, types and every value equal (NaN equal to NaN), in
    order."""
    assert got.column_names == want.column_names, label
    assert got.schema.types == want.schema.types, label
    assert got.num_rows == want.num_rows, (label, got.num_rows,
                                           want.num_rows)
    for name in got.column_names:
        for i, (a, b) in enumerate(zip(got.column(name).to_pylist(),
                                       want.column(name).to_pylist())):
            same = (a is None and b is None) or (
                a is not None and b is not None
                and (a == b or (isinstance(a, float) and math.isnan(a)
                                and math.isnan(b))))
            assert same, (label, name, i, a, b)


def run_both(left_rbs, right_rbs, lkeys, rkeys, jt, cond=None,
             hint=False, conf=None):
    """The port's and the reference's join of the same batches:
    ``(port table, reference table, port ctx)``."""
    port = GpuShuffledHashJoinExec(
        [tcol(k) for k in lkeys], [tcol(k) for k in rkeys], jt,
        tbase.HostBatchSourceExec(left_rbs),
        tbase.HostBatchSourceExec(right_rbs),
        None if cond is None else TGreaterThan(tcol(cond[0]),
                                               tcol(cond[1])),
        build_unique_hint=hint)
    ref = TpuShuffledHashJoinExec(
        [jcol(k) for k in lkeys], [jcol(k) for k in rkeys], jt,
        jbase.HostBatchSourceExec(left_rbs),
        jbase.HostBatchSourceExec(right_rbs),
        None if cond is None else JGreaterThan(jcol(cond[0]),
                                               jcol(cond[1])),
        build_unique_hint=hint)
    ctx = tbase.ExecCtx(RapidsConf(conf or {}), device="cpu")
    got = tbase.collect_arrow(port, ctx)
    from spark_rapids_tpu.config import RapidsConf as JConf
    want = jbase.collect_arrow(ref, jbase.ExecCtx(JConf(conf or {})))
    return got, want, ctx, port


def _staged_batches(ctx, port):
    return ctx.metrics[port.node_label()]["stagedBatches"].value \
        if "stagedBatches" in ctx.metrics[port.node_label()] else 0


def _sides(gen_l, gen_r, nl=150, nr=120, seeds=(11, 22)):
    left = [gen_table([gen_l, LongGen(nullable=False)], nl, seeds[0],
                      names=["lk", "lv"])]
    right = [gen_table([gen_r, LongGen(nullable=False)], nr, seeds[1],
                       names=["rk", "rv"])]
    return left, right


def check(left, right, jt, lkeys=("lk",), rkeys=("rk",), staged=True,
          **kw):
    got, want, ctx, port = run_both(left, right, list(lkeys), list(rkeys),
                                    jt, **kw)
    _exact(got, want, jt)
    if staged:
        assert _staged_batches(ctx, port) == len(left), \
            "a duplicated build key takes the staged path"
    return got


@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_staged_int_keys(jt):
    gen = IntegerGen(min_val=0, max_val=40)
    check(*_sides(gen, gen), jt)


@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_staged_null_keys(jt):
    gen = IntegerGen(min_val=0, max_val=10, null_frac=0.3)
    check(*_sides(gen, gen), jt)


@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_staged_string_keys(jt):
    gen = StringGen(max_len=4, charset="abc", null_frac=0.2)
    check(*_sides(gen, gen), jt)


@pytest.mark.parametrize("kg", [LongGen(min_val=-5, max_val=5),
                                DateGen(), TimestampGen(),
                                DoubleGen(null_frac=0.2)],
                         ids=lambda g: g.dtype.simple_string())
def test_staged_key_types(kg):
    # small longs and dates repeat (the staged path) and run every type;
    # random timestamps and doubles are unique (the fast path), where the
    # key's lane is what is new: an inner and an anti join
    types = JOIN_TYPES if isinstance(kg, (LongGen, DateGen)) \
        else ["inner", "left_anti"]
    for jt in types:
        check(*_sides(kg, kg), jt, staged=False)


def test_staged_float_key_specials():
    """NaN == NaN and -0.0 == 0.0 for keys; a null key never matches."""
    left = [pa.record_batch(
        {"lk": pa.array([float("nan"), 0.0, -0.0, 1.5, None, 2.5]),
         "lv": pa.array([1, 2, 3, 4, 5, 6], pa.int64())})]
    right = [pa.record_batch(
        {"rk": pa.array([float("nan"), -0.0, 2.5, None, float("nan"),
                         0.0]),
         "rv": pa.array([10, 20, 30, 40, 50, 60], pa.int64())})]
    for jt in JOIN_TYPES:
        check(left, right, jt)


def test_staged_several_keys():
    gens = [IntegerGen(min_val=0, max_val=5),
            StringGen(max_len=2, charset="xy")]
    left = [gen_table(gens + [LongGen(nullable=False)], 100, 1,
                      names=["k1", "k2", "lv"])]
    right = [gen_table(gens + [LongGen(nullable=False)], 80, 2,
                       names=["r1", "r2", "rv"])]
    for jt in JOIN_TYPES:
        check(left, right, jt, lkeys=("k1", "k2"), rkeys=("r1", "r2"))


def test_staged_empty_sides():
    empty_r = [pa.record_batch({"rk": pa.array([], pa.int32()),
                                "rv": pa.array([], pa.int64())})]
    left = [gen_table([IntegerGen(), LongGen(nullable=False)], 50, 3,
                      names=["lk", "lv"])]
    empty_l = [pa.record_batch({"lk": pa.array([], pa.int32()),
                                "lv": pa.array([], pa.int64())})]
    right = [gen_table([IntegerGen(min_val=0, max_val=5),
                        LongGen(nullable=False)], 50, 4,
                       names=["rk", "rv"])]
    for jt in JOIN_TYPES:
        check(left, empty_r, jt, staged=False)
        check(empty_l, right, jt)


def test_staged_empty_build_with_strings():
    """A left-outer or anti join with an empty build still emits its
    stream rows, nulls for a build string column."""
    left = [gen_table([IntegerGen(), StringGen()], 40, 7,
                      names=["lk", "ls"])]
    empty = [pa.record_batch({"rk": pa.array([], pa.int32()),
                              "rs": pa.array([], pa.string())})]
    for jt in JOIN_TYPES:
        check(left, empty, jt, staged=False)


def test_staged_multi_batch_stream():
    left = [gen_table([IntegerGen(min_val=0, max_val=20),
                       LongGen(nullable=False)], n, seed=s,
                      names=["lk", "lv"]) for n, s in [(60, 1), (90, 2)]]
    right = [gen_table([IntegerGen(min_val=0, max_val=20),
                        LongGen(nullable=False)], 70, 9,
                       names=["rk", "rv"])]
    for jt in JOIN_TYPES:
        check(left, right, jt)


def test_staged_duplicate_heavy_keys():
    gen = IntegerGen(min_val=0, max_val=3)
    for jt in JOIN_TYPES:
        got = check(*_sides(gen, gen, nl=100, nr=100), jt)
        if jt == "inner":
            assert got.num_rows > 1000  # about 25 build rows a key


def test_staged_string_payload():
    left = [gen_table([IntegerGen(min_val=0, max_val=8), StringGen()],
                      60, 5, names=["lk", "ls"])]
    right = [gen_table([IntegerGen(min_val=0, max_val=8), StringGen()],
                       50, 6, names=["rk", "rs"])]
    for jt in JOIN_TYPES:
        check(left, right, jt)


def test_staged_inner_join_with_condition():
    gen = IntegerGen(min_val=0, max_val=10)
    check(*_sides(gen, gen), "inner", cond=("lv", "rv"))


def _dup_build():
    left = [pa.record_batch({"lk": pa.array(np.arange(30, dtype=np.int32)),
                             "lv": pa.array(np.arange(30,
                                                      dtype=np.int64))})]
    right = [pa.record_batch({
        "rk": pa.array(np.arange(24, dtype=np.int32) % 12),
        "rs": pa.array([f"s{i}" for i in range(24)])})]
    return left, right


def test_false_hint_with_strings_warns_then_goes_staged():
    left, right = _dup_build()
    with pytest.warns(RuntimeWarning, match="build_unique hint is FALSE"):
        got = check(left, right, "inner", hint=True)
    assert got.num_rows == 24


def test_false_hint_without_strings_raises_at_the_download():
    left, right = _dup_build()
    right = [right[0].drop_columns(["rs"])]
    port = GpuShuffledHashJoinExec(
        [tcol("lk")], [tcol("rk")], "inner",
        tbase.HostBatchSourceExec(left), tbase.HostBatchSourceExec(right),
        build_unique_hint=True)
    with pytest.raises(RuntimeError, match="build_unique hint violated"):
        tbase.collect_arrow(port, tbase.ExecCtx(device="cpu"))


def test_verify_unique_hint_off_is_unchecked():
    left, right = _dup_build()
    got, want, ctx, port = run_both(
        left, right, ["lk"], ["rk"], "inner", hint=True,
        conf={"spark.rapids.sql.join.verifyUniqueHint": "false"})
    _exact(got, want)
    assert got.num_rows == 12  # one match a stream row: duplicates dropped
    assert _staged_batches(ctx, port) == 0


@pytest.mark.parametrize("jt", ["right_outer", "full_outer", "cross"])
def test_unported_join_types_raise_naming_item_9(jt):
    """These types raised naming ROADMAP item 9 until the outer and
    cross joins were ported; each is now held to the reference on
    duplicated keys, every stream batch on the staged path (a cross join
    reads no keys)."""
    gen = IntegerGen(min_val=0, max_val=40)
    got = check(*_sides(gen, gen), jt)
    assert got.num_rows >= (150 * 120 if jt == "cross" else 120)


# --- the stage functions against the reference's ---------------------------

STAGE_CASES = {
    "int_dups": (IntegerGen(min_val=0, max_val=12, null_frac=0.2),),
    "string": (StringGen(max_len=3, charset="ab", null_frac=0.2),),
    "double_specials": (DoubleGen(null_frac=0.2),),
    "two_keys": (IntegerGen(min_val=0, max_val=3),
                 StringGen(max_len=2, charset="xy")),
}


def _stage_inputs(gens, dead_every=7):
    names = [f"k{i}" for i in range(len(gens))]
    lrb = gen_table(list(gens) + [StringGen()], 90, 31,
                    names=names + ["s"])
    rrb = gen_table(list(gens) + [StringGen()], 70, 32,
                    names=names + ["s"])
    if isinstance(gens[0], DoubleGen):  # repeat values to make matches
        def fold(rb):
            k = rb.column(0).to_pylist()
            k = [None if v is None else (v if i % 3 else 0.0)
                 for i, v in enumerate(k)]
            k[1] = float("nan")
            return rb.set_column(0, "k0", pa.array(k, pa.float64()))
        lrb, rrb = fold(lrb), fold(rrb)
    out = []
    for rb in (lrb, rrb):
        jb = j_to_device(rb)
        tb = t_to_device(rb, None, "cpu")
        # dead rows between live ones: a lazy selection on both
        keep = np.arange(tb.capacity) % dead_every != 3
        jb = jb.with_selection(jnp.asarray(keep))
        tb = tb.with_selection(torch.from_numpy(keep))
        out.append((jb, tb))
    return names, out


def _np(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor)
                      else x)


@pytest.mark.parametrize("case", sorted(STAGE_CASES))
def test_stage_arrays_match_the_reference(case):
    gens = STAGE_CASES[case]
    names, ((jl, tl), (jr, tr)) = _stage_inputs(gens)
    jk = [[b.column(i) for i in range(len(names))] for b in (jl, jr)]
    tk = [[b.columns[i] for i in range(len(names))] for b in (tl, tr)]
    jplan = jjoin.join_counts(jk[0], jk[1], jl.live_mask(), jr.live_mask())
    tplan = tjoin.join_counts(tk[0], tk[1], tl.live_mask(), tr.live_mask())
    for f in ("g_l", "g_r", "matches", "starts_g", "perm_r", "eligible_l",
              "eligible_r", "matched_r", "times_r"):
        assert np.array_equal(_np(getattr(tplan, f)),
                              _np(getattr(jplan, f))), (case, f)
    # the outer types' math too
    for jt in JOIN_TYPES + ["right_outer", "full_outer"]:
        total = int(tjoin.join_total(tplan, jt))
        assert total == int(jjoin.join_total(jplan, jt)), (case, jt)
        assert np.array_equal(
            _np(tjoin.join_output_bytes(tplan, tl, tr, jt)),
            _np(jjoin.join_output_bytes(jplan, jl, jr, jt))), (case, jt)
        out_cap = max(128, 1 << max(total - 1, 0).bit_length())
        got = [_np(x) for x in tjoin.join_indices(tplan, jt, out_cap)]
        want = [_np(x) for x in jjoin.join_indices(jplan, jt,
                                                     out_cap)[:4]]
        lidx, ridx, lvalid, rvalid = got
        assert np.array_equal(lvalid, want[2]), (case, jt)
        assert np.array_equal(rvalid, want[3]), (case, jt)
        assert np.array_equal(lidx[lvalid], want[0][lvalid]), (case, jt)
        assert np.array_equal(ridx[rvalid], want[1][rvalid]), (case, jt)
        assert int((lvalid | rvalid).sum()) == total, (case, jt)
