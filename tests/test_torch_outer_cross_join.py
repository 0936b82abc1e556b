"""Right and full outer joins and the cross join on the CPU, held to the
JAX package.

- Exec level, the port's ``GpuShuffledHashJoinExec`` and
  ``GpuCartesianProductExec`` against the reference's
  ``TpuShuffledHashJoinExec`` and ``TpuCartesianProductExec`` over the
  same Arrow batches (``tests/test_join.py``'s shapes, made from a seed
  with numpy by ``tests/data_gen.py``): right and full outer over unique,
  duplicated, null, string and two-column keys, an empty build and an
  empty stream, 1 and 3 stream batches, and the cross join with and
  without a condition; the cross join's stage arrays against
  ``spark_rapids_tpu.ops.join.join_counts(..., cross=True)``.
- SQL level, through the dual-run assert and against the oracle
  (``tools/nds_joins.py``): q_full_halves, q_right_items, q28_buckets and
  q90_ratio at ``spark.sql.shuffle.partitions`` 1 and 16 over the NDS
  tables at 2^14 store_sales rows.
- The refusal: a cross join past the int32 indices names ROADMAP item
  14. A non-equi condition on an outer, semi or anti equi-join runs on
  the CPU, against the reference's CPU path.

Tolerance: ints, strings and nulls exact, floats rel
``torch_dual_run.FLOAT_RTOL``; the row order exact against the
reference's device path, and the rows as multisets against its CPU
oracle (``torch_join_cases``)."""
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.ops.join as jjoin
from spark_rapids_tpu.exec.joins import (TpuCartesianProductExec,
                                         TpuShuffledHashJoinExec)
from spark_rapids_tpu.expr import GreaterThan as JGreaterThan
from spark_rapids_tpu_torch import nds
from spark_rapids_tpu_torch.exec import base as tbase
from spark_rapids_tpu_torch.exec.joins import (GpuCartesianProductExec,
                                               GpuShuffledHashJoinExec)
from spark_rapids_tpu_torch.expr import GreaterThan as TGreaterThan
from spark_rapids_tpu_torch.expr import UnresolvedColumn as tcol
from spark_rapids_tpu_torch.ops import join as tjoin

import spark_rapids_tpu.exec.base as jbase
from data_gen import IntegerGen, LongGen, StringGen, gen_table
from spark_rapids_tpu.config import RapidsConf as JConf
from spark_rapids_tpu.expr import UnresolvedColumn as jcol
from torch_dual_run import assert_same_rows, run_port, run_reference
from torch_join_cases import N_SALES, check_sql, run_both, sources

OUTER = ["right_outer", "full_outer"]


def _hash_join(jt, lkeys, rkeys, cond=None):
    def build(side, left, right, col):
        exec_cls = GpuShuffledHashJoinExec if side == "port" \
            else TpuShuffledHashJoinExec
        c = None
        if cond is not None:
            gt = TGreaterThan if side == "port" else JGreaterThan
            c = gt(col(cond[0]), col(cond[1]))
        return exec_cls([col(k) for k in lkeys], [col(k) for k in rkeys],
                        jt, left, right, c)
    return build


def _cross(cond=None):
    def build(side, left, right, col):
        if side == "port":
            c = None if cond is None else TGreaterThan(col(cond[0]),
                                                       col(cond[1]))
            return GpuCartesianProductExec(left, right, c)
        c = None if cond is None else JGreaterThan(col(cond[0]),
                                                   col(cond[1]))
        return TpuCartesianProductExec(left, right, c)
    return build


def _side(gens, n, seed, names):
    return [gen_table(list(gens) + [LongGen(nullable=False)], n, seed,
                      names=list(names))]


KEY_CASES = {
    "unique": ([IntegerGen(min_val=0, max_val=1 << 20, nullable=False)],
               (90, 70)),
    "duplicated": ([IntegerGen(min_val=0, max_val=30, nullable=False)],
                   (150, 120)),
    "nulls": ([IntegerGen(min_val=0, max_val=10, null_frac=0.3)],
              (150, 120)),
    "string": ([StringGen(max_len=3, charset="abc", null_frac=0.2)],
               (120, 100)),
    "two_keys": ([IntegerGen(min_val=0, max_val=5),
                  StringGen(max_len=2, charset="xy")], (100, 80)),
}


@pytest.mark.parametrize("jt", OUTER)
@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_outer_join_matches_the_reference(case, jt):
    """Every key shape against the reference's CPU oracle; two-column
    keys (one a string) also against its device path, row for row."""
    gens, (nl, nr) = KEY_CASES[case]
    lk = [f"l{i}" for i in range(len(gens))]
    rk = [f"r{i}" for i in range(len(gens))]
    left = _side(gens, nl, 11, lk + ["lv"])
    right = _side(gens, nr, 22, rk + ["rv"])
    got, ctx, port = run_both(
        _hash_join(jt, lk, rk), left, right, label=f"{case} {jt}",
        oracle="device" if case == "two_keys" else "cpu")
    m = ctx.metrics[port.node_label()]
    # every outer build is staged, then the unmatched build rows once
    assert m["uniqueBuild"].value == 0 and m["stagedBatches"].value == 1
    assert m["numOutputBatches"].value == 2
    assert got.num_rows >= nr


@pytest.mark.parametrize("jt", OUTER)
@pytest.mark.parametrize("empty", ["build", "stream"])
def test_outer_join_with_an_empty_side(empty, jt):
    """An empty build gives a right outer join no rows and a full outer
    join the stream's; an empty stream gives every build row, the build's
    string column included."""
    left = [gen_table([IntegerGen(min_val=0, max_val=8), StringGen()], 40,
                      7, names=["lk", "ls"])]
    right = [gen_table([IntegerGen(min_val=0, max_val=8), StringGen()], 30,
                       8, names=["rk", "rs"])]
    if empty == "build":
        right = right[0].schema
    else:
        left = left[0].schema
    got, _, _ = run_both(_hash_join(jt, ["lk"], ["rk"]), left, right,
                         label=f"empty {empty} {jt}", oracle="cpu")
    want = {("build", "right_outer"): 0, ("build", "full_outer"): 40,
            ("stream", "right_outer"): 30, ("stream", "full_outer"): 30}
    assert got.num_rows == want[empty, jt]


@pytest.mark.parametrize("jt", OUTER)
@pytest.mark.parametrize("batches", [1, 3])
def test_outer_join_over_stream_batches(batches, jt):
    """The build's matched mask ORs across the stream batches: a build
    row matched by one batch only is not emitted as unmatched (three
    batches against the reference's device path, row for row)."""
    gen = IntegerGen(min_val=0, max_val=60, null_frac=0.1)
    left = [gen_table([gen, LongGen(nullable=False)], 40, seed,
                      names=["lk", "lv"]) for seed in range(batches)]
    right = _side([gen], 70, 9, ["rk", "rv"])
    _, ctx, port = run_both(_hash_join(jt, ["lk"], ["rk"]), left, right,
                            label=f"{batches} {jt}",
                            oracle="device" if batches == 3 else "cpu")
    m = ctx.metrics[port.node_label()]
    assert m["stagedBatches"].value == batches
    assert m["numOutputBatches"].value == batches + 1


@pytest.mark.parametrize("cond", [None, ("lv", "rv")],
                         ids=["no_condition", "condition"])
def test_cross_join_matches_the_reference(cond):
    left = [gen_table([IntegerGen(), StringGen(max_len=4),
                       LongGen(nullable=False)], n, s,
                      names=["lk", "ls", "lv"]) for n, s in ((30, 1),
                                                             (20, 2))]
    if cond is not None:  # one stream batch: the condition's compiles
        left = left[:1]
    right = _side([StringGen(max_len=3, null_frac=0.2)], 25, 3,
                  ["rs", "rv"])
    got, ctx, port = run_both(_cross(cond), left, right,
                              label=f"cross {cond}")
    if cond is None:
        assert got.num_rows == 50 * 25
    assert ctx.metrics[port.node_label()]["stagedBatches"].value \
        == len(left)


def test_cross_stage_arrays_match_the_reference():
    """``join_counts(..., cross=True)``: every array of the plan equals
    the reference's, over live masks with dead rows between live ones,
    and so do the totals, string bytes and output indices of a cross
    join."""
    import jax.numpy as jnp
    from spark_rapids_tpu.columnar.arrow_bridge import \
        arrow_to_device as j_to_device
    from spark_rapids_tpu_torch.columnar.arrow_bridge import \
        arrow_to_device as t_to_device
    rng = np.random.default_rng(5)
    sides = []
    for n, seed in ((90, 31), (70, 32)):
        rb = gen_table([StringGen(), LongGen()], n, seed, names=["s", "v"])
        jb, tb = j_to_device(rb), t_to_device(rb, None, "cpu")
        keep = rng.random(tb.capacity) < 0.7
        sides.append((jb.with_selection(jnp.asarray(keep)),
                       tb.with_selection(torch.from_numpy(keep))))
    (jl, tl), (jr, tr) = sides
    jplan = jjoin.join_counts([], [], jl.live_mask(), jr.live_mask(),
                              cross=True)
    tplan = tjoin.join_counts([], [], tl.live_mask(), tr.live_mask(),
                              cross=True)
    for f in ("g_l", "g_r", "matches", "starts_g", "perm_r", "eligible_l",
              "eligible_r", "matched_r", "times_r"):
        assert np.array_equal(getattr(tplan, f).numpy(),
                              np.asarray(getattr(jplan, f))), f
    for jt in ("cross", "left_outer", "left_semi", "full_outer"):
        total = int(tjoin.join_total(tplan, jt))
        assert total == int(jjoin.join_total(jplan, jt)), jt
        assert np.array_equal(
            tjoin.join_output_bytes(tplan, tl, tr, jt).numpy(),
            np.asarray(jjoin.join_output_bytes(jplan, jl, jr, jt))), jt
        out_cap = max(128, 1 << max(total - 1, 0).bit_length())
        got = [x.numpy() for x in tjoin.join_indices(tplan, jt, out_cap)]
        want = [np.asarray(x)
                for x in jjoin.join_indices(jplan, jt, out_cap)[:4]]
        assert np.array_equal(got[2], want[2]) \
            and np.array_equal(got[3], want[3]), jt
        assert np.array_equal(got[0][got[2]], want[0][got[2]]), jt
        assert np.array_equal(got[1][got[3]], want[1][got[3]]), jt


def test_cross_join_past_the_int32_indices_raises_naming_item_14():
    """2^16 x (2^15 + 1) pairs pass 2^31 - 1: the stage-A readback
    refuses the stream batch before anything is gathered."""
    left = [pa.record_batch({"a": pa.array(np.arange(1 << 16,
                                                     dtype=np.int32))})]
    right = [pa.record_batch({"b": pa.array(np.arange((1 << 15) + 1,
                                                      dtype=np.int32))})]
    plan = GpuCartesianProductExec(tbase.HostBatchSourceExec(left),
                                   tbase.HostBatchSourceExec(right))
    with pytest.raises(NotImplementedError, match="ROADMAP item 14"):
        tbase.collect_arrow(plan, tbase.ExecCtx(device="cpu"))


@pytest.mark.parametrize("jt", ["left_outer", "right_outer", "full_outer",
                                "left_semi", "left_anti"])
def test_condition_on_a_non_inner_equi_join_raises_naming_item_12(jt):
    """A condition on an outer, semi or anti equi-join raised naming
    ROADMAP item 12 until the CPU fallback was ported. The planner now
    places the join on the CPU, where it equals the reference's CPU
    path (duplicated and null keys, as multisets); its device path
    still refuses it, a backstop behind the gate."""
    from spark_rapids_tpu_torch.planner import GpuOverrides
    gen = IntegerGen(min_val=0, max_val=12, null_frac=0.1)
    left = _side([gen], 60, 31, ["lk", "lv"])
    right = _side([gen], 40, 32, ["rk", "rv"])
    build = _hash_join(jt, ["lk"], ["rk"], ("lv", "rv"))
    (lp, lr), (rp, rr) = sources(left), sources(right)
    pp = GpuOverrides(device="cpu").apply(build("port", lp, rp, tcol))
    assert pp.fallback_nodes() == ["ShuffledHashJoinExec"]
    want = jbase.collect_arrow_cpu(build("ref", lr, rr, jcol),
                                   jbase.ExecCtx(JConf()))
    assert_same_rows(pp.collect(), want, ordered=False, label=jt)
    with pytest.raises(NotImplementedError, match="runs on the CPU"):
        tbase.collect_arrow(build("port", lp, rp, tcol),
                            tbase.ExecCtx(device="cpu"))


# --- SQL over the NDS tables -------------------------------------------------

@pytest.fixture(scope="module")
def tables():
    return nds.gen_tables(N_SALES)


@pytest.fixture(scope="module")
def paths(tables, tmp_path_factory):
    return nds.write_tables(tables, str(tmp_path_factory.mktemp("nds")))


SQL_RUNS = [(q, p) for q in ("q_full_halves", "q_right_items",
                             "q28_buckets", "q90_ratio") for p in (1, 16)]


@pytest.mark.parametrize("q,parts", SQL_RUNS,
                         ids=[f"{q}-p{p}" for q, p in SQL_RUNS])
def test_sql_matches_reference_and_oracle(paths, tables, q, parts):
    check_sql(paths, tables, q, parts)


def test_left_join_with_a_non_equi_residual_raises_naming_item_12(paths):
    """It raised naming ROADMAP item 12 until the CPU fallback was
    ported: the join now runs on the CPU and equals the reference's
    all-CPU rows."""
    sql = ("SELECT ss_item_sk, i_brand_id FROM store_sales LEFT JOIN "
           "item ON ss_item_sk = i_item_sk AND ss_quantity > i_brand_id")
    got, _ = run_port(sql, paths)
    want, _ = run_reference(sql, paths, {"spark.rapids.sql.enabled":
                                         "false"})
    assert_same_rows(got, want, ordered=False)
