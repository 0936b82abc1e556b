"""The out-of-core paths on the CPU: the port against the JAX package
under device budgets that force each path in both packages.

- Every ``spark_rapids_tpu_torch/tools/nds_memory.py`` text (q_percentile
  and q3 among them) at 2^14 store_sales rows, in row groups and batches
  of 2048 rows, at ``spark.sql.shuffle.partitions`` 1 and 16, under a
  64 KiB budget (``nds_memory.conf_for``), through
  ``tests/torch_dual_run.py``: the rows equal the reference's and the
  text's numpy/pyarrow oracle, and a metric shows the port took the
  path (the sort's runs and merge rounds and its runs on sealed disk
  files, the window's buckets, the aggregate's merge rounds, the
  percentile's CPU run, q3's spilled and uploaded map entries). The
  reference runs with ``spark.rapids.sql.verifyPlan=false``: its static
  verifier refuses an exact percentile's plan under such a budget.
  Budgets: at 64 KiB every path's input (the sort's and the window's
  128 KiB and more, the percentile's, the partials) is past its cut in
  both packages, whose ``device_size_bytes`` differ (the port leaves out
  the validity of a column without nulls and counts a selection's mask).
- The bucketed window's rows come out in the reference's order (its
  buckets from the same Murmur3), not only as the same set.
- A skewed partition's batches are halved in order (``numSkewSplits``),
  the rows the reference's.
- ``DataFrame.cache()`` replays equal rows, spilled or not.

Tolerance: ints and strings exact, floats rel 1e-9
(``torch_dual_run.FLOAT_RTOL``)."""
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu_torch import nds
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.memory import DeviceMemoryManager
from spark_rapids_tpu_torch.session import GpuSession
from spark_rapids_tpu_torch.tools import nds_memory as nm
from torch_dual_run import (assert_same_rows, dual_run, run_port,
                            run_reference)

N_SALES = 1 << 14
BUDGET = 64 << 10
ROWS = 2048


@pytest.fixture(scope="module")
def tables():
    return nds.gen_tables(N_SALES)


@pytest.fixture(scope="module")
def paths(tables, tmp_path_factory):
    return nds.write_tables(tables, str(tmp_path_factory.mktemp("nds")),
                            row_group_size=ROWS)


@pytest.fixture(scope="module")
def spill_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("spill"))


def _conf(q, parts, spill_dir, budget=BUDGET):
    conf = dict(nm.conf_for(q, budget))
    conf.update({"spark.sql.shuffle.partitions": str(parts),
                 "spark.rapids.sql.batchSizeRows": str(ROWS),
                 "spark.rapids.memory.spillDir": spill_dir,
                 "spark.rapids.sql.verifyPlan": "false"})
    return conf


def _op(metrics, prefix, name):
    return sum(m.get(name, 0) for label, m in metrics.items()
               if label.startswith(prefix))


RUNS = [(q, p) for q in nm.QUERIES for p in (1, 16)]


@pytest.mark.parametrize("q,parts", RUNS, ids=[f"{q}-p{p}" for q, p in RUNS])
def test_text_under_budget_matches_reference_and_oracle(paths, tables,
                                                        spill_dir, q,
                                                        parts):
    conf = _conf(q, parts, spill_dir)
    mm = DeviceMemoryManager.shared(RapidsConf(conf), "cpu")
    before = (mm.spill_bytes, mm.disk_spill_bytes, mm.readback_count)
    metrics = {}
    got, _ = dual_run(nm.SQL_QUERIES[q], paths, conf, port_metrics=metrics)
    want = nm.oracle(q, tables)
    assert_same_rows(got.cast(want.schema), want, ordered=True, label=q)
    spilled = mm.spill_bytes - before[0]
    to_disk = mm.disk_spill_bytes - before[1]
    uploaded = mm.readback_count - before[2]
    if q == "q_sales_sorted":
        assert _op(metrics, "SortExec", "numRuns") == N_SALES // ROWS
        assert _op(metrics, "SortExec", "mergeRounds") > 0
        assert spilled > 0 and to_disk > 0
    elif q == "q_last_purchase":
        assert _op(metrics, "WindowExec", "windowBuckets") > 1
    elif q == "q_customer_items":
        assert _op(metrics, "HashAggregateExec", "mergeRounds") > 0
    elif q == "q_percentile":
        assert _op(metrics, "HashAggregateExec", "cpuAggregate") == 1
    else:
        assert spilled > 0 and uploaded > 0
    assert mm.device_bytes == 0
    assert mm.leak_report() == "no leaked catalog entries"


def test_default_budget_takes_no_out_of_core_path(paths, tables):
    metrics = {}
    got, _ = run_port(nm.SQL_QUERIES["q_sales_sorted"], paths,
                      {"spark.rapids.sql.batchSizeRows": str(ROWS)},
                      metrics)
    want = nm.oracle("q_sales_sorted", tables)
    assert_same_rows(got.cast(want.schema), want, ordered=True)
    assert _op(metrics, "SortExec", "numRuns") == 0


# --- the bucketed window's order ---------------------------------------------

WINDOW_SQL = """
SELECT k, v, w,
       ROW_NUMBER() OVER (PARTITION BY k ORDER BY v, w) AS rn,
       SUM(w) OVER (PARTITION BY k ORDER BY v, w) AS run_w
FROM t
"""


@pytest.fixture(scope="module")
def window_paths(tmp_path_factory):
    rng = np.random.default_rng(11)
    n = 6000
    # a null in every column of every row group: the two packages'
    # batches then hold the same bytes, so they cut the same number of
    # buckets (the port leaves out a validity mask with no null in it)
    nulls = np.zeros(n, bool)
    nulls[::500] = True
    t = pa.table({
        "k": pa.array(rng.integers(0, 97, n), pa.int64(), mask=nulls),
        "v": pa.array(rng.integers(0, 40, n), pa.int32(),
                      mask=np.roll(nulls, 7)),
        "w": pa.array(rng.integers(-500, 500, n), pa.int64(),
                      mask=np.roll(nulls, 3))})
    d = tmp_path_factory.mktemp("win")
    path = str(d / "t.parquet")
    pq.write_table(t, path, row_group_size=1000)
    return {"t": path}


@pytest.mark.parametrize("parts", [1, 4])
def test_bucketed_window_rows_in_reference_order(window_paths, spill_dir,
                                                 parts):
    conf = {"spark.rapids.memory.device.budgetBytes": str(BUDGET),
            "spark.rapids.sql.batchSizeRows": "1000",
            "spark.sql.shuffle.partitions": str(parts),
            "spark.rapids.memory.spillDir": spill_dir,
            "spark.rapids.sql.verifyPlan": "false"}
    metrics = {}
    got, _ = run_port(WINDOW_SQL, window_paths, conf, metrics)
    want, _ = run_reference(WINDOW_SQL, window_paths, conf)
    assert _op(metrics, "WindowExec", "windowBuckets") > 1
    assert_same_rows(got, want, ordered=True, label="bucketed window")
    # and not the in-core order: the buckets interleave the keys
    keys = got.column("k").fill_null(-1).to_numpy()
    assert (np.diff(keys) < 0).any()


# --- the skew split ----------------------------------------------------------

SKEW_SQL = "SELECT k, SUM(v) AS s, COUNT(*) AS n FROM t GROUP BY k"


@pytest.fixture(scope="module")
def skew_paths(tmp_path_factory):
    rng = np.random.default_rng(5)
    n = 8192
    k = np.where(rng.random(n) < 0.85, 0, rng.integers(1, 50, n))
    t = pa.table({"k": pa.array(k, pa.int64()),
                  "v": pa.array(rng.integers(0, 1000, n), pa.int64())})
    d = tmp_path_factory.mktemp("skew")
    path = str(d / "t.parquet")
    pq.write_table(t, path, row_group_size=2048)
    return {"t": path}


def test_skewed_partition_is_halved_in_order(skew_paths, spill_dir):
    conf = {"spark.sql.shuffle.partitions": "8",
            "spark.rapids.sql.batchSizeRows": "2048",
            "spark.sql.adaptive.advisoryPartitionSizeInBytes": "4096",
            "spark.sql.adaptive.skewJoin.skewedPartitionFactor": "2",
            "spark.sql.adaptive.skewJoin.skewedPartitionThresholdInBytes":
                "1024",
            "spark.rapids.memory.spillDir": spill_dir}
    metrics = {}
    got, want = dual_run(SKEW_SQL, skew_paths, conf, port_metrics=metrics)
    assert _op(metrics, "AQEShuffleReadExec", "numSkewedPartitions") >= 1
    assert _op(metrics, "AQEShuffleReadExec", "numSkewSplits") >= 1
    assert got.num_rows == 50


# --- DataFrame.cache() ---------------------------------------------------------

@pytest.mark.parametrize("budget", [0, 1024])
def test_cache_replays_equal_rows_spilled_or_not(paths, tables, spill_dir,
                                                  budget):
    conf = {"spark.rapids.sql.batchSizeRows": str(ROWS),
            "spark.rapids.memory.spillDir": spill_dir,
            "spark.sql.shuffle.partitions": "1"}
    if budget:
        conf["spark.rapids.memory.device.budgetBytes"] = str(budget)
    s = nds.session_over_files(paths, conf, device="cpu")
    df = s.sql("SELECT ss_customer_sk, ss_item_sk, ss_net_profit "
               "FROM store_sales WHERE ss_quantity > 50").cache()
    mm = DeviceMemoryManager.shared(s.conf, s.device)
    held = mm.catalog_size
    first = df.collect()
    entries = mm.catalog_size - held
    assert entries >= N_SALES // ROWS
    spilled = mm.spill_bytes
    second = df.collect()
    assert second.equals(first)
    if budget:
        # the replay uploaded the spilled entries again
        assert spilled > 0 and mm.readback_count > 0
    # the same rows as the reference's cached frame and the oracle
    from spark_rapids_tpu.session import TpuSession
    from spark_rapids_tpu.tools import nds as jnds
    r = TpuSession(dict(conf))
    jnds.register_frames(r, {k: r.read_parquet(p) for k, p in paths.items()})
    rdf = r.sql("SELECT ss_customer_sk, ss_item_sk, ss_net_profit "
                "FROM store_sales WHERE ss_quantity > 50").cache()
    rdf.collect()
    assert_same_rows(second, rdf.collect(), ordered=False, label="cache")
    ss = tables["store_sales"]
    assert second.num_rows == int(
        (ss.column("ss_quantity").to_numpy() > 50).sum())
    # the entries stay until the frame goes
    assert mm.catalog_size == held + entries
    del df
    import gc
    gc.collect()
    assert mm.catalog_size == held


def test_cache_through_the_dataframe_api_and_sql():
    s = GpuSession({"spark.sql.shuffle.partitions": "1"}, device="cpu")
    df = s.create_dataframe({"a": list(range(10)), "b": [1, 2] * 5}).cache()
    s.register_table("c", df)
    got = s.sql("SELECT b, SUM(a) AS s FROM c GROUP BY b ORDER BY b") \
        .collect()
    assert got.to_pydict() == {"b": [1, 2], "s": [20, 25]}
    assert df.collect().to_pydict() == {"a": list(range(10)),
                                        "b": [1, 2] * 5}
