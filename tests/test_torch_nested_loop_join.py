"""The nested-loop join on the CPU, held to the JAX package.

- Exec level, the port's ``GpuBroadcastNestedLoopJoinExec`` against the
  reference's ``TpuBroadcastNestedLoopJoinExec`` over the same Arrow
  batches (``tests/test_join.py``'s ``_bnlj_plan`` shapes, made from a
  seed with numpy by ``tests/data_gen.py``): all seven join types under
  a band condition over two stream batches, with nulls in the
  condition's columns and a string column carried through the pairs; an
  empty build; no condition; and the DataFrame API's ``join`` without
  ``on``.
- The matched masks of the pair layout (``ops/join.pair_matched_stream``
  and ``pair_matched_build``) against a dense numpy loop over every
  pair.
- SQL level, through the dual-run assert and against the oracle
  (``tools/nds_joins.py``): the five band texts (inner, left outer, left
  anti, left semi and full outer nested-loop joins) at
  ``spark.sql.shuffle.partitions`` 1 and 16 over the NDS tables at 2^14
  store_sales rows.

Tolerance: ints, strings and nulls exact, floats rel
``torch_dual_run.FLOAT_RTOL``; the row order exact against the
reference's device path (the band joins), and the rows as multisets
against its CPU oracle (an empty build, no condition;
``torch_join_cases``)."""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.exec.joins import TpuBroadcastNestedLoopJoinExec
from spark_rapids_tpu.expr import And as JAnd
from spark_rapids_tpu.expr import GreaterThanOrEqual as JGe
from spark_rapids_tpu.expr import LessThanOrEqual as JLe
from spark_rapids_tpu_torch import nds
from spark_rapids_tpu_torch.exec.joins import GpuBroadcastNestedLoopJoinExec
from spark_rapids_tpu_torch.expr import And as TAnd
from spark_rapids_tpu_torch.expr import GreaterThanOrEqual as TGe
from spark_rapids_tpu_torch.expr import LessThanOrEqual as TLe
from spark_rapids_tpu_torch.ops import join as tjoin

from data_gen import IntegerGen, LongGen, StringGen, gen_table
from torch_join_cases import N_SALES, check_sql, run_both

ALL_TYPES = ["inner", "cross", "left_outer", "right_outer", "full_outer",
             "left_semi", "left_anti"]


def _nlj(jt, band=True):
    """The join of ``jt`` under ``lk BETWEEN lo AND hi`` (or none)."""
    def build(side, left, right, col):
        port = side == "port"
        cond = None
        if band:
            ge, le, conj = (TGe, TLe, TAnd) if port else (JGe, JLe, JAnd)
            cond = conj(ge(col("lk"), col("lo")), le(col("lk"), col("hi")))
        cls = GpuBroadcastNestedLoopJoinExec if port \
            else TpuBroadcastNestedLoopJoinExec
        return cls(jt, left, right, cond)
    return build


def _stream():
    gen = IntegerGen(min_val=0, max_val=50, null_frac=0.1)
    return [gen_table([gen, StringGen(max_len=5), LongGen(nullable=False)],
                      n, seed, names=["lk", "ls", "lv"])
            for n, seed in ((60, 21), (30, 22))]


def _bands(n=12, seed=23):
    """Bands ``[lo, hi]`` of width 0-6 over the stream's keys (some
    null, some matching nothing), with a string label."""
    rb = gen_table([IntegerGen(min_val=-10, max_val=60, null_frac=0.1),
                    IntegerGen(min_val=0, max_val=6, nullable=False),
                    StringGen(max_len=3, null_frac=0.2)], n, seed,
                   names=["lo", "w", "rs"])
    lo = rb.column(0)
    hi = [None if a is None else a + w
          for a, w in zip(lo.to_pylist(), rb.column(1).to_pylist())]
    return [pa.record_batch({"lo": lo, "hi": pa.array(hi, pa.int32()),
                             "rs": rb.column(2)})]


@pytest.mark.parametrize("jt", ALL_TYPES)
def test_band_join_matches_the_reference(jt):
    got, ctx, port = run_both(_nlj(jt), _stream(), _bands(), label=jt)
    m = ctx.metrics[port.node_label()]
    assert m["stagedBatches"].value == 2  # one pair batch a stream batch
    assert got.num_rows > 0


@pytest.mark.parametrize("jt", ["left_outer", "full_outer", "left_anti",
                                "inner", "right_outer", "left_semi"])
def test_band_join_with_an_empty_build(jt):
    """Outer and anti joins emit every stream row; inner, right outer and
    semi joins emit nothing."""
    got, _, _ = run_both(_nlj(jt), _stream(), _bands()[0].schema,
                         label=f"empty build {jt}", oracle="cpu")
    assert got.num_rows == (90 if jt in ("left_outer", "full_outer",
                                         "left_anti") else 0)


@pytest.mark.parametrize("jt", ["left_outer", "right_outer", "left_semi",
                                "left_anti"])
def test_join_without_a_condition_is_the_cross_join(jt):
    got, _, _ = run_both(_nlj(jt, band=False), _stream(), _bands(n=5),
                         label=f"no condition {jt}", oracle="cpu")
    want = {"left_outer": 90 * 5, "right_outer": 90 * 5, "left_semi": 90,
            "left_anti": 0}
    assert got.num_rows == want[jt]


def test_dataframe_join_without_keys_takes_the_nested_loop_join():
    from spark_rapids_tpu_torch.expr import UnresolvedColumn as col
    from spark_rapids_tpu_torch.session import GpuSession
    s = GpuSession(device="cpu")
    left, right = s.create_dataframe(_stream()[0]), \
        s.create_dataframe(_bands()[0])
    cond = TAnd(TGe(col("lk"), col("lo")), TLe(col("lk"), col("hi")))
    df = left.join(right, how="full", condition=cond)
    assert isinstance(df._node, GpuBroadcastNestedLoopJoinExec)
    got = df.collect()
    want = run_both(_nlj("full_outer"), [_stream()[0]], _bands())[0]
    assert got.equals(want)
    assert left.join(right).collect().num_rows == 60 * 12


def test_pair_matched_masks_against_every_pair():
    """The pair layout's masks equal a dense loop over the live pairs:
    stream rows (live: 5 of 8) by build rows (live: 4 of 6)."""
    rng = np.random.default_rng(3)
    live_l = torch.tensor([1, 0, 1, 1, 0, 1, 1, 0], dtype=torch.bool)
    live_r = torch.tensor([0, 1, 1, 0, 1, 1], dtype=torch.bool)
    plan = tjoin.join_counts([], [], live_l, live_r, cross=True)
    pairs = 5 * 4
    ok_dense = rng.random((5, 4)) < 0.3
    ok = torch.zeros(128, dtype=torch.bool)
    ok[:pairs] = torch.from_numpy(ok_dense.reshape(-1))
    ml = tjoin.pair_matched_stream(plan, ok).numpy()
    mr = tjoin.pair_matched_build(plan, ok, pairs, 4).numpy()
    want_l = np.zeros(8, bool)
    want_l[np.flatnonzero(live_l.numpy())] = ok_dense.any(1)
    want_r = np.zeros(6, bool)
    want_r[np.flatnonzero(live_r.numpy())] = ok_dense.any(0)
    assert np.array_equal(ml, want_l) and np.array_equal(mr, want_r)
    none = tjoin.pair_matched_build(plan, torch.zeros(128, dtype=torch.bool),
                                    0, 0)
    assert not none.any()


# --- SQL over the NDS tables -------------------------------------------------

@pytest.fixture(scope="module")
def tables():
    return nds.gen_tables(N_SALES)


@pytest.fixture(scope="module")
def paths(tables, tmp_path_factory):
    return nds.write_tables(tables, str(tmp_path_factory.mktemp("nds")))


SQL_RUNS = [(q, p) for q in ("q_band_year", "q_band_left", "q_band_anti",
                             "q_band_semi", "q_band_full") for p in (1, 16)]


@pytest.mark.parametrize("q,parts", SQL_RUNS,
                         ids=[f"{q}-p{p}" for q, p in SQL_RUNS])
def test_sql_matches_reference_and_oracle(paths, tables, q, parts):
    check_sql(paths, tables, q, parts)
