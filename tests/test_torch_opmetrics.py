"""The port's per-operator metrics (``obs/opmetrics.py``, the execute
shims of ``exec/base.py``) against the JAX package's, on the CPU.

- Operator ids are unique, survive ``copy.deepcopy`` and pickle, and an
  aliased subtree keeps one id.
- EXPLAIN ANALYZE's per-operator ``rows`` and ``batches`` equal the
  reference's, node for node in pre-order, for q3, q97, q_rank and
  q_union at 1 and 4 partitions, and for the 44 texts of the plan
  verifier's corpus at 1 and 16 partitions, over the same Parquet files
  (the corpus's tables at 2^10 store_sales rows): rows in every run;
  batches but for the departures ``DIFFERENCES`` lists with their
  reasons (the adaptive reader's coalesced views, the CPU island's
  conditioned outer join). The port's exchange counts the rows its map
  side partitions and a scan spliced into its consumer's stage counts
  its decoded rows, as the reference's do; the CPU exchange yields no
  zero-row batch.
- ``GpuSession.sql("EXPLAIN ANALYZE ...")`` returns the annotated tree:
  ids once each, the root's rows the result's.
- A batch is counted once where an ``execute`` delegates to ``super()``
  (a nested-loop cross join), where a subclass inherits it (the global
  limit) and where a CPU island runs a copy of its node.
- A profile is written under ``spark.rapids.history.dir`` and read back;
  ``fold_snapshots`` skips a torn snapshot; ``render_analyzed`` renders
  a tree directly; a CPU context's fused-stage time is a synchronous add
  (no event, no watcher); op metrics off record no counts.
"""
import copy
import json
import os
import pickle
import re

import pyarrow as pa
import pytest

from spark_rapids_tpu_torch import nds
from spark_rapids_tpu_torch.exec.base import (ExecCtx, HostBatchSourceExec,
                                              collect_arrow)
from spark_rapids_tpu_torch.expr.aggregates import Sum
from spark_rapids_tpu_torch.expr.base import Alias, UnresolvedColumn as col
from spark_rapids_tpu_torch.obs.opmetrics import (
    OP_METRICS_ENABLED, assign_op_ids, flush_task_opmetrics, fold_ctx,
    fold_snapshots, plan_source, read_profiles, read_task_opmetrics,
    render_analyzed)
from spark_rapids_tpu_torch.planner import GpuOverrides
from spark_rapids_tpu_torch.session import GpuSession

OPID_RE = re.compile(r"\(op(\d+)\)")

_VIEWS = ("the adaptive reader reads a coalesced group's partitions as "
          "one selection view of each map batch, sharing its buffers "
          "(exec/aqe.py), where the reference concatenates the group into "
          "one batch; rows are equal")
_ISLAND_JOIN = ("the CPU island's conditioned left outer join emits a "
                "stream batch's passing pairs, then its unmatched rows "
                "beside nulls, as two batches (exec/joins.py "
                "_execute_conditioned), where the reference's host join "
                "emits one; the upload and the reader above pass them "
                "through; rows are equal")

#: (query, partitions, operator) -> why the port's batches differ from
#: the reference's (rows never do); the zero-row batches of the CPU
#: exchange's empty partitions are gone (``exec/exchange.py``
#: ``execute_cpu``)
DIFFERENCES = {
    ("q_right_items", 16, "AQEShuffleReadExec"): _VIEWS,
    ("q_band_full", 16, "AQEShuffleReadExec"): _VIEWS,
    **{("q_outer_price", p, op): _ISLAND_JOIN for p in (1, 16)
       for op in ("AQEShuffleReadExec", "HostToDeviceExec",
                  "ShuffledHashJoinExec")},
}


def _session(extra=None):
    conf = {"spark.sql.shuffle.partitions": "2"}
    conf.update(extra or {})
    return GpuSession(conf, device="cpu")


def _join_agg_df(s, n_left=400, n_dim=10):
    left = s.create_dataframe({
        "k": [i % n_dim for i in range(n_left)],
        "v": list(range(n_left))})
    dim = s.create_dataframe({
        "k": list(range(n_dim)),
        "name": [f"d{i}" for i in range(n_dim)]})
    return left.join(dim, on="k").group_by("name").agg(
        Alias(Sum(col("v")), "sv"))


def _preorder(root):
    out, seen = [], set()

    def walk(n):
        out.append(n)
        if id(n) in seen:
            return
        seen.add(id(n))
        for c in n.children:
            walk(c)

    walk(root)
    return out


def _uses(root, node) -> int:
    """How many paths from ``root`` reach ``node``."""
    if root is node:
        return 1
    return sum(_uses(c, node) for c in root.children)


def _ops_by_name(folded, name):
    return [st for st in folded.values()
            if st["label"].split("#", 1)[0] == name]


# --- operator ids ------------------------------------------------------------

def test_op_ids_unique_and_survive_pickle_and_deepcopy():
    pp = _join_agg_df(_session())._plan()
    labels = [n.node_label() for n in _preorder(pp.root)]
    assert all("#op" in lb for lb in labels), labels
    assert len(labels) == len(set(labels)), labels
    for clone in (pickle.loads(pickle.dumps(pp.root)),
                  copy.deepcopy(pp.root)):
        assert [n.node_label() for n in _preorder(clone)] == labels


def test_assign_op_ids_shares_aliased_subtrees():
    from spark_rapids_tpu_torch.exec.aggregate import GpuHashAggregateExec
    from spark_rapids_tpu_torch.exec.exchange import GpuShuffleExchangeExec
    from spark_rapids_tpu_torch.exec.misc import GpuUnionExec
    from spark_rapids_tpu_torch.shuffle.partitioner import HashPartitioning
    src = HostBatchSourceExec([pa.record_batch({"k": [1, 2]})])
    agg = GpuHashAggregateExec([col("k")], [Alias(Sum(col("k")), "s")],
                               src)
    exch = GpuShuffleExchangeExec(HashPartitioning([col("k")], 2), agg)
    root = GpuUnionExec([exch, exch])
    assign_op_ids(root, force=True)
    assert root.children[0] is root.children[1]
    assert root.children[0]._op_id == root.children[1]._op_id == 2
    assert [n._op_id for n in _preorder(root)] == [1, 2, 3, 4, 2]


# --- rows and batches against the reference ----------------------------------

@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return nds.write_tables(nds.gen_tables(1 << 10),
                            str(tmp_path_factory.mktemp("nds")))


RUNS = [(q, p) for q in ("q3", "q97", "q_rank", "q_union") for p in (1, 4)]


@pytest.mark.parametrize("q,parts", RUNS, ids=[f"{q}-p{p}" for q, p in RUNS])
def test_rows_and_batches_equal_the_reference_node_for_node(paths, q,
                                                            parts):
    _rows_and_batches(paths, q, nds.SQL_QUERIES[q], {}, parts)


def _corpus():
    from test_torch_plan_verifier import CORPUS
    return [(q, sql, conf, p) for _, q, sql, conf in CORPUS
            for p in (1, 16)]


CORPUS_RUNS = _corpus()
# the runs split in two halves, the other in
# tests/test_torch_opmetrics_corpus.py: under the tier-1 run's
# ``--dist loadfile`` one file runs on one worker
HALVES = (CORPUS_RUNS[0::2], CORPUS_RUNS[1::2])


@pytest.mark.parametrize("q,sql,conf,parts", HALVES[0],
                         ids=[f"{q}-p{p}" for q, _, _, p in HALVES[0]])
def test_batches_over_the_verifier_corpus(paths, q, sql, conf, parts):
    """The 44 texts of the plan verifier's corpus (the NDS corpus, the
    join, fallback and memory texts under their confs) at 1 and 16
    partitions: rows equal everywhere, batches equal but for
    ``DIFFERENCES``. This file runs the first half of the runs."""
    _rows_and_batches(paths, q, sql, conf, parts)


def test_the_cpu_exchange_yields_no_zero_row_batch(paths):
    from spark_rapids_tpu_torch.exec.exchange import GpuShuffleExchangeExec
    conf = {"spark.sql.shuffle.partitions": "16",
            "spark.rapids.sql.enabled": "false"}
    s = nds.session_over_files(paths, conf, device="cpu")
    pp = GpuOverrides(s.conf, s.device).apply(
        s.sql(nds.SQL_QUERIES["q3"])._node)
    exchanges = [n for n in _preorder(pp.root)
                 if isinstance(n, GpuShuffleExchangeExec)]
    assert exchanges and not pp.root_on_device
    ctx = ExecCtx(s.conf, "cpu")
    sizes = [rb.num_rows for rb in exchanges[0].execute_cpu(ctx)]
    assert sizes and all(sizes), sizes
    # 16 partitions of a few keys: some are empty, and none comes out
    assert len(sizes) < 16


def _rows_and_batches(paths, q, sql, conf, parts):
    from spark_rapids_tpu.obs.opmetrics import fold_ctx as jfold_ctx
    from spark_rapids_tpu.planner import TpuOverrides
    from spark_rapids_tpu.session import TpuSession
    from spark_rapids_tpu.tools import nds as jnds
    conf = dict(conf, **{"spark.sql.shuffle.partitions": str(parts)})
    s = nds.session_over_files(paths, conf, device="cpu")
    pp = GpuOverrides(s.conf, s.device).apply(s.sql(sql)._node)
    out = pp.collect()
    folded = fold_ctx(pp.last_ctx)
    js = TpuSession(dict(conf))
    jnds.register_frames(js, {k: js.read_parquet(p)
                              for k, p in paths.items()})
    jpp = TpuOverrides(js.conf).apply(js.sql(sql)._node)
    want = jpp.collect()
    jfolded = jfold_ctx(jpp.last_ctx)
    assert out.num_rows == want.num_rows
    nodes, jnodes = _preorder(pp.root), _preorder(jpp.root)
    assert [n.pretty_name() for n in nodes] == \
        [n.pretty_name() for n in jnodes]
    for n, jn in zip(nodes, jnodes):
        m = folded.get(f"op{n._op_id}", {}).get("metrics", {})
        jm = jfolded.get(f"op{jn._op_id}", {}).get("metrics", {})
        assert m.get("rows") == jm.get("rows"), \
            (q, parts, n.node_label(), m.get("rows"), jm.get("rows"))
        if (q, parts, n.pretty_name()) in DIFFERENCES:
            continue
        assert m.get("batches") == jm.get("batches"), \
            (q, parts, n.node_label(), m.get("batches"), jm.get("batches"))
    # the root's rows are the result's, and every scan read its file
    # once a path that reaches it (a CTE's or a union's shared scans)
    root = folded[f"op{pp.root._op_id}"]["metrics"]
    assert root["rows"] == out.num_rows
    import pyarrow.parquet as pq
    for n in set(nodes):
        if n.pretty_name() == "FileScanExec":
            m = folded[f"op{n._op_id}"]["metrics"]
            assert m["rows"] == _uses(pp.root, n) * sum(
                pq.ParquetFile(p).metadata.num_rows for p in n.paths)


def test_explain_analyze_through_sql(paths):
    s = nds.session_over_files(paths, {"spark.sql.shuffle.partitions": "2"},
                               device="cpu")
    sql = nds.SQL_QUERIES["q3"]
    text = s.sql("EXPLAIN ANALYZE " + sql)
    assert text.startswith("== Analyzed Physical Plan (local, ")
    ids = OPID_RE.findall(text)
    assert ids and len(ids) == len(set(ids)), text
    assert sorted(map(int, ids)) == list(range(1, len(ids) + 1))
    n_rows = s.sql(sql).collect().num_rows
    assert f"rows={n_rows}," in text.splitlines()[1], text
    assert "fused into op" in text, text
    full = s.sql("EXPLAIN ANALYZE FORMATTED " + sql)
    assert "outputBytes=" in full and "dispatchTime=" in full, full


# --- counted once ------------------------------------------------------------

def test_no_double_count_on_a_super_delegating_execute():
    # the nested-loop join without a condition delegates to the wrapped
    # _BaseJoinExec.execute: both shims fire, each batch counts once
    s = _session()
    left = s.create_dataframe({"a": [1, 2, 3]})
    right = s.create_dataframe({"b": [10, 20]})
    pp = left.join(right, on=None)._plan()
    assert pp.collect().num_rows == 6
    join = _ops_by_name(fold_ctx(pp.last_ctx),
                        "BroadcastNestedLoopJoinExec")[0]
    assert join["metrics"]["rows"] == 6, join
    assert join["metrics"]["batches"] == 1, join


def test_global_limit_counts_once():
    s = _session()
    df = s.create_dataframe({"a": list(range(100))}).limit(7)
    pp = df._plan()
    assert pp.collect().num_rows == 7
    st = _ops_by_name(fold_ctx(pp.last_ctx), "GlobalLimitExec")[0]
    assert st["metrics"]["rows"] == 7 and st["metrics"]["batches"] == 1


def test_a_cpu_island_counts_its_rows_once():
    s = _session({"spark.rapids.sql.exec.FilterExec": "false"})
    s.register_table("t", {"k": list(range(50)), "v": [1.0] * 50})
    pp = GpuOverrides(s.conf, s.device).apply(
        s.sql("SELECT k FROM t WHERE k < 20")._node)
    assert pp.fallback_nodes() == ["FilterExec"]
    assert pp.collect().num_rows == 20
    folded = fold_ctx(pp.last_ctx)
    filt = _ops_by_name(folded, "FilterExec")[0]["metrics"]
    assert filt["rows"] == 20 and filt["batches"] == 1
    assert filt["cpuFallback"] == 1
    assert not [k for k in pp.last_ctx.metrics if "HostInput" in k]
    assert "[CPU]" in pp.explain_analyze()


# --- profiles, snapshots, rendering ------------------------------------------

def test_profile_written_and_read_back(tmp_path):
    hist = str(tmp_path / "hist")
    s = _session({"spark.rapids.history.dir": hist})
    s.register_table("t", {"k": [i % 3 for i in range(90)],
                           "v": list(range(90))})
    df = s.sql("SELECT k, SUM(v) AS sv FROM t GROUP BY k")
    assert plan_source(df._node) == "sql"
    pp = df._plan()
    pp.collect()
    assert pp.last_profile_path and os.path.exists(pp.last_profile_path)
    profiles = read_profiles(hist)
    assert [p for p, _ in profiles] == [pp.last_profile_path]
    doc = profiles[0][1]
    assert doc == json.load(open(pp.last_profile_path))
    assert doc["device_kind"] == "cpu"
    assert doc["source"] == "sql" and doc["cluster"] == "local"
    assert doc["fallbacks"] == []
    assert [n["label"] for n in doc["nodes"]] == \
        [n.node_label() for n in _preorder(pp.root)]
    aggs = [st for st in doc["ops"].values()
            if st["label"].startswith("HashAggregateExec")]
    assert aggs[0]["metrics"]["rows"] == 3


def test_fold_tolerates_a_torn_snapshot(tmp_path):
    s = _session()
    pp = _join_agg_df(s)._plan()
    pp.collect()
    path = flush_task_opmetrics(str(tmp_path / "t1.a0.w0.task"),
                                pp.last_ctx, "t1", 0)
    assert path and os.path.exists(path)
    torn = tmp_path / "t2.a1.w1.task.opm.json"
    torn.write_text('{"task": "t2", "ops": {"FooExec#')
    snaps = read_task_opmetrics(str(tmp_path),
                                [("t1", 0, 0), ("t2", 1, 1), ("t3", 0, 0)])
    assert [sn["task"] for sn in snaps] == ["t1"]
    folded = fold_snapshots(snaps + ["not a snapshot", {"ops": 7}])
    assert folded == fold_ctx(pp.last_ctx)
    agg = _ops_by_name(folded, "HashAggregateExec")[0]
    assert agg["metrics"]["rows"] == 10 and agg["tasks"] == 1


def test_render_analyzed_direct():
    src = HostBatchSourceExec([pa.record_batch({"k": [1, 2, 3]})])
    assign_op_ids(src, force=True)
    text = render_analyzed(src, {}, cluster="local")
    assert "HostBatchSourceExec" in text
    assert "not executed directly" in text
    text2 = render_analyzed(
        src, fold_snapshots([{"ops": {src.node_label():
                                      {"rows": 3, "batches": 1}}}]),
        wall_s=0.5)
    assert "rows=3" in text2 and "500.0 ms" in text2


def test_a_cpu_context_adds_stage_time_at_once():
    s = _session()
    s.register_table("t", {"k": list(range(64)), "v": [2.0] * 64})
    pp = GpuOverrides(s.conf, s.device).apply(
        s.sql("SELECT k, v * 2 AS w FROM t WHERE k > 3")._node)
    ctx = ExecCtx(s.conf, "cpu")
    gen = pp.root.execute(ctx)
    next(gen)
    # before the query's finalize: the stage's time is already in
    # opTime, stamped on this thread, and nothing waits for a watcher
    assert ctx.opm.stamps["event"] == ctx.opm.stamps["wall"] \
        == ctx.opm.stamps["wedged"] == 0
    assert ctx.opm.stamps["cpu"] >= 1
    times = [ms["opTime"].value for ms in ctx.metrics.values()
             if "opTime" in ms]
    assert times and all(t > 0 for t in times)
    assert not ctx.opm._deferred_times
    gen.close()


def test_op_metrics_off_records_no_counts():
    s = _session({OP_METRICS_ENABLED.key: "false"})
    df = _join_agg_df(s)
    ctx = ExecCtx(s.conf, "cpu")
    on = _join_agg_df(_session())._plan().collect()
    off = collect_arrow(df._plan().root, ctx)
    assert off.equals(on)
    assert not [k for ms in ctx.metrics.values() for k in ms
                if k in ("rows", "batches", "outputBytes")]


def test_the_ladders_cpu_rerun_counts_each_row_once():
    # the device attempt's counts go with it: the CPU rerun's are the
    # query's
    s = _session({"spark.rapids.sql.test.injectRetryOOM.storm": "200",
                  "spark.rapids.sql.oomRetry.maxSplits": "2"})
    s.register_table("t", {"k": [i % 5 for i in range(300)],
                           "v": list(range(300))})
    pp = s.sql("SELECT k, SUM(v) AS sv FROM t GROUP BY k")._plan()
    out = pp.collect()
    assert out.num_rows == 5
    ctx = pp.last_ctx
    assert ctx.metric(pp.root, "ladderCpuFallback").value == 1
    folded = fold_ctx(ctx)
    assert folded[f"op{pp.root._op_id}"]["metrics"]["rows"] == 5
    src = _ops_by_name(folded, "HostBatchSourceExec")[0]["metrics"]
    assert src["rows"] == 300 and src["cpuFallback"] == 1
