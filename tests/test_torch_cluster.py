"""The process cluster (``cluster.py``) on the CPU: ``GpuProcessCluster(
n_workers=2, device="cpu")``, real worker processes exchanging Arrow IPC
shuffle files, against the JAX package's in-process runs.

A group-by, a join + aggregate and a join over two batch sources split
into per-leaf tasks (the plans of ``tests/test_cluster.py`` in the
port's classes) give the rows of the reference's in-process run of the
same plan and of a pyarrow oracle; so do NDS q3, q_rank, q97 and
q_like_intl (a CPU island in a worker) at 16 partitions through
``GpuSession``, held to ``tests/torch_dual_run.run_reference`` and their
oracles, and q6 from Parquet (one worker runs the whole plan). Rows are
held with ``assert_same_rows`` (ints, strings and nulls exact, floats at
rel 1e-9: the cluster reads a partition's files in another order than
the in-process views). EXPLAIN ANALYZE's rows equal the in-process
EXPLAIN ANALYZE's operator by operator; the workers' registry snapshots
fold to the in-process scan's device chunks; a worker's error surfaces;
``cancel_running`` stops a query; a mesh conf raises naming ROADMAP
item 17; every corpus plan pickles with no tensor or lock inside; a
``cuda`` worker on a host with no card fails its task rather than run on
the CPU; and no worker loads ``jax``. Each test sets a small stage
timeout, and the module's cluster is shut down in its fixture's
finalizer."""
import os
import threading

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch import datatypes as tdt
from spark_rapids_tpu_torch import nds
from spark_rapids_tpu_torch.cluster import (ENV_SHARING,
                                            GpuProcessCluster,
                                            _split_leaf_input, _task_conf,
                                            plan_pickle_refusals)
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exec.base import HostBatchSourceExec
from spark_rapids_tpu_torch.obs.opmetrics import fold_ctx
from spark_rapids_tpu_torch.planner import GpuOverrides
from spark_rapids_tpu_torch.tools import nds_fallback as fb
from torch_dual_run import assert_same_rows, run_port, run_reference

STAGE_TIMEOUT = {"spark.rapids.tpu.scheduler.stageTimeout": "60",
                 "spark.rapids.tpu.task.timeout": "60"}
N_SALES = 1 << 12


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    conf = RapidsConf(dict(STAGE_TIMEOUT,
                           **{"spark.rapids.metrics.enabled": "true"}))
    c = GpuProcessCluster(n_workers=2, device="cpu", conf=conf,
                          root=str(tmp_path_factory.mktemp("cluster")))
    yield c
    c.shutdown()


def _ns(pkg):
    """Each package's operators, expressions and partitioning."""
    if pkg == "port":
        from spark_rapids_tpu_torch.exec import aggregate, exchange, joins
        from spark_rapids_tpu_torch.exec.base import HostBatchSourceExec
        from spark_rapids_tpu_torch.expr import Alias, UnresolvedColumn
        from spark_rapids_tpu_torch.expr.aggregates import Count, Sum
        from spark_rapids_tpu_torch.shuffle.partitioner import \
            HashPartitioning
        return dict(Agg=aggregate.GpuHashAggregateExec,
                    Exch=exchange.GpuShuffleExchangeExec,
                    Join=joins.GpuShuffledHashJoinExec,
                    Src=HostBatchSourceExec, Alias=Alias,
                    col=UnresolvedColumn, Sum=Sum, Count=Count,
                    Hash=HashPartitioning)
    from spark_rapids_tpu.exec import aggregate, exchange, joins
    from spark_rapids_tpu.exec.base import HostBatchSourceExec
    from spark_rapids_tpu.expr import Alias, UnresolvedColumn
    from spark_rapids_tpu.expr.aggregates import Count, Sum
    from spark_rapids_tpu.shuffle.partitioner import HashPartitioning
    return dict(Agg=aggregate.TpuHashAggregateExec,
                Exch=exchange.TpuShuffleExchangeExec,
                Join=joins.TpuShuffledHashJoinExec,
                Src=HostBatchSourceExec, Alias=Alias, col=UnresolvedColumn,
                Sum=Sum, Count=Count, Hash=HashPartitioning)


def _ref_rows(plan):
    from spark_rapids_tpu.exec.base import ExecCtx, collect_arrow
    return collect_arrow(plan, ExecCtx())


def _groupby_batches():
    rng = np.random.default_rng(1)
    out = []
    for n in (300, 250, 411, 128):
        k = rng.integers(0, 21, n).astype(np.int32)
        out.append(pa.record_batch({
            "k": pa.array(k, mask=rng.random(n) < 0.1),
            "v": pa.array(rng.integers(-1000, 1000, n).astype(np.int64))}))
    return out


def _groupby(pkg, rbs):
    n = _ns(pkg)
    c = n["col"]
    exch = n["Exch"](n["Hash"]([c("k")], 4), n["Src"](rbs))
    return n["Agg"]([c("k")], [n["Alias"](n["Sum"](c("v")), "s"),
                               n["Alias"](n["Count"](c("v")), "c")], exch)


def _groupby_oracle(rbs):
    t = pa.Table.from_batches(rbs)
    g = t.group_by("k").aggregate([("v", "sum"), ("v", "count")])
    return g.select(["k", "v_sum", "v_count"]).rename_columns(
        ["k", "s", "c"])


def _sorted(t):
    return t.sort_by([(name, "ascending") for name in t.column_names])


def _same(got, *wants):
    for want in wants:
        assert_same_rows(_sorted(got.cast(want.schema)), _sorted(want),
                         ordered=True)


def test_groupby_over_two_workers(cluster):
    rbs = _groupby_batches()
    got = cluster.run_query(_groupby("port", rbs))
    _same(got, _ref_rows(_groupby("ref", rbs)), _groupby_oracle(rbs))
    maps = {e["task"] for e in cluster.last_scheduler.events
            if e["event"] == "task_ok" and "m" in e["task"][2:]}
    assert len(maps) == 2  # the source's four batches split in two tasks


def _join_batches(n_f=2000, n_d=64, seed=5):
    rng = np.random.default_rng(seed)
    fact = pa.record_batch({
        "fk": pa.array(rng.integers(0, n_d, n_f).astype(np.int32)),
        "amt": pa.array(rng.integers(1, 100, n_f).astype(np.int64))})
    dim = pa.record_batch({
        "dk": pa.array(np.arange(n_d, dtype=np.int32)),
        "grp": pa.array((np.arange(n_d) % 7).astype(np.int32))})
    return fact, dim


def _join_agg(pkg, fact, dim, nparts=3):
    n = _ns(pkg)
    c = n["col"]
    lex = n["Exch"](n["Hash"]([c("fk")], nparts),
                    n["Src"]([fact.slice(0, 1100), fact.slice(1100)]))
    rex = n["Exch"](n["Hash"]([c("dk")], nparts),
                    n["Src"]([dim.slice(0, 40), dim.slice(40)]))
    join = n["Join"]([c("fk")], [c("dk")], "inner", lex, rex)
    gex = n["Exch"](n["Hash"]([c("grp")], nparts), join)
    return n["Agg"]([c("grp")], [n["Alias"](n["Sum"](c("amt")), "total"),
                                 n["Alias"](n["Count"](c("amt")), "n")],
                    gex)


def _join_oracle(fact, dim):
    j = pa.Table.from_batches([fact]).join(
        pa.Table.from_batches([dim]), keys="fk", right_keys="dk")
    g = j.group_by("grp").aggregate([("amt", "sum"), ("amt", "count")])
    return g.select(["grp", "amt_sum", "amt_count"]).rename_columns(
        ["grp", "total", "n"])


def test_join_aggregate_in_three_stages(cluster):
    fact, dim = _join_batches()
    got = cluster.run_query(_join_agg("port", fact, dim))
    _same(got, _ref_rows(_join_agg("ref", fact, dim)),
          _join_oracle(fact, dim))
    stages = {e["stage"] for e in cluster.last_scheduler.events
              if e["event"] == "task_ok"}
    assert len(stages) == 4  # two leaf maps, the join's map, the final


def test_multichild_leaf_stage_splits_into_per_leaf_tasks(cluster):
    n = _ns("port")
    c = n["col"]
    fact, dim = _join_batches(800, 32, seed=9)
    fact_src = HostBatchSourceExec([fact.slice(i * 200, 200)
                                    for i in range(4)])
    dim_src = HostBatchSourceExec([dim.slice(0, 16), dim.slice(16)])
    join = n["Join"]([c("fk")], [c("dk")], "inner", fact_src, dim_src)
    slices = _split_leaf_input(join, 2)
    assert len(slices) == 2
    for s in slices:
        f, d = s.children
        assert len(f.batches) == 2 and len(d.batches) == 2
    # an aliased self-join's leaf never splits (both sides would)
    self_join = n["Join"]([c("fk")], [c("fk")], "inner", fact_src,
                          fact_src)
    assert _split_leaf_input(self_join, 2) == [self_join]
    # a full outer join distributes over neither side
    outer = n["Join"]([c("fk")], [c("dk")], "full_outer", fact_src,
                      dim_src)
    assert _split_leaf_input(outer, 2) == [outer]
    gex = n["Exch"](n["Hash"]([c("grp")], 3), join)
    plan = n["Agg"]([c("grp")], [n["Alias"](n["Sum"](c("amt")), "total"),
                                 n["Alias"](n["Count"](c("amt")), "n")],
                    gex)
    got = cluster.run_query(plan)
    _same(got, _join_oracle(fact, dim))
    qid = cluster._query_seq
    maps = {e["task"] for e in cluster.last_scheduler.events
            if e["event"] == "task_ok" and e["task"].startswith(f"q{qid}s")}
    assert len(maps) == 2


@pytest.fixture(scope="module")
def tables():
    return nds.gen_tables(N_SALES)


@pytest.fixture(scope="module")
def paths(tables, tmp_path_factory):
    return nds.write_tables(tables, str(tmp_path_factory.mktemp("nds")))


CONF16 = {"spark.sql.shuffle.partitions": "16"}


def _planned(paths, sql, conf=CONF16):
    s = nds.session_over_files(paths, dict(conf, **STAGE_TIMEOUT),
                               device="cpu")
    return GpuOverrides(s.conf, s.device).apply(s.sql(sql)._node)


@pytest.mark.parametrize("q", ["q3", "q_rank", "q97", "q_like_intl"])
def test_nds_text_on_the_cluster(q, cluster, paths, tables):
    corpus = fb if q in fb.SQL_QUERIES and q not in nds.SQL_QUERIES \
        else nds
    sql = corpus.SQL_QUERIES[q]
    got = cluster.run_query(_planned(paths, sql))
    ref, _ = run_reference(sql, paths, CONF16)
    assert got.num_rows > 0
    assert_same_rows(got, ref, ordered=True, label=q)
    assert_same_rows(got, corpus.oracle(q, tables), ordered=True, label=q)
    reports = cluster.last_kernel_reports
    assert reports and all(r["device_name"] == "cpu"
                           and r["reference_modules"] == []
                           for r in reports)


def test_q6_runs_whole_on_one_worker(cluster, tmp_path):
    from bench import build_q6 as jax_build_q6
    from spark_rapids_tpu.io import TpuFileScanExec
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.io.scan import GpuFileScanExec
    q6_paths = tpch.write_lineitem(tpch.gen_lineitem(30_000, seed=2),
                                   str(tmp_path), seed=2, n_files=3,
                                   row_group_size=1 << 13)
    got = cluster.run_query(tpch.build_q6(GpuFileScanExec(
        q6_paths, schema=tpch.LINEITEM_SCHEMA)))
    import spark_rapids_tpu.datatypes as jdt
    jschema = jdt.Schema([jdt.StructField(f.name, t, False) for f, t in zip(
        tpch.LINEITEM_SCHEMA, (jdt.FLOAT32, jdt.FLOAT32, jdt.FLOAT32,
                               jdt.DATE))])
    ref_plan, _ = jax_build_q6(TpuFileScanExec(q6_paths, schema=jschema))
    ref = _ref_rows(ref_plan)
    revenue, _ = tpch.host_q6(q6_paths)
    assert got.num_rows == 1
    assert got.column(0)[0].as_py() == pytest.approx(
        ref.column(0)[0].as_py(), rel=1e-9)
    assert got.column(0)[0].as_py() == pytest.approx(revenue, rel=1e-9)
    tasks = [e for e in cluster.last_scheduler.events
             if e["event"] == "task_ok"]
    assert len(tasks) == 1  # no exchange: one worker runs it all


def test_worker_error_surfaces(cluster):
    from spark_rapids_tpu_torch.io.scan import GpuFileScanExec
    n = _ns("port")
    schema = tdt.Schema([tdt.StructField("x", tdt.INT64, True)])
    missing = GpuFileScanExec(["/nonexistent/x.parquet"], schema=schema)
    exch = n["Exch"](n["Hash"]([n["col"]("x")], 2), missing)
    plan = n["Agg"]([], [n["Alias"](n["Count"](n["col"]("x")), "c")],
                    exch)
    with pytest.raises(RuntimeError, match="worker task"):
        cluster.run_query(plan, RapidsConf(dict(
            STAGE_TIMEOUT, **{"spark.rapids.tpu.task.maxAttempts": 1})))


def _rows_by_op(folded):
    return {k: int(v["metrics"].get("rows", 0))
            for k, v in folded.items() if "rows" in v["metrics"]}


def test_explain_analyze_rows_equal_in_process(cluster, paths):
    sql = nds.SQL_QUERIES["q3"]
    pp = _planned(paths, sql)
    pp.collect()
    local = _rows_by_op(fold_ctx(pp.last_ctx))
    text = cluster.explain_analyze(_planned(paths, sql))
    assert text.startswith("== Analyzed Physical Plan (process")
    remote = _rows_by_op(cluster.last_opmetrics)
    ids = {f"op{n._op_id}" for n in _walk(cluster.last_plan)}
    assert set(remote) <= ids
    common = set(local) & set(remote)
    # every node of the executed plan but the stripped adaptive readers
    assert len(common) >= len(ids) - 1
    assert {k: remote[k] for k in common} == {k: local[k] for k in common}
    # the session routes EXPLAIN ANALYZE to an attached cluster
    s = nds.session_over_files(paths, dict(CONF16, **STAGE_TIMEOUT),
                               device="cpu")
    s.set_cluster(cluster)
    assert s.sql("EXPLAIN ANALYZE " + sql).startswith(
        "== Analyzed Physical Plan (process")


def _walk(node):
    yield node
    for ch in getattr(node, "children", ()):
        yield from _walk(ch)


def test_registry_fold_counts_the_scans_chunks(cluster, paths):
    sql = nds.SQL_QUERIES["q3"]
    pp = _planned(paths, sql)
    pp.collect()
    local = sum(m["deviceChunks"].value
                for label, m in pp.last_ctx.metrics.items()
                if label.startswith("FileScanExec") and "deviceChunks" in m)
    before = cluster.worker_counter("rapids_scan_device_chunks_total")
    cluster.run_query(_planned(paths, sql))
    after = cluster.worker_counter("rapids_scan_device_chunks_total")
    assert local > 0 and after - before == local
    text = cluster.prometheus_text()
    assert 'rapids_scan_device_chunks_total{proc="w' in text


def test_cancel_running(cluster):
    rbs = _groupby_batches()
    qid = cluster._query_seq + 1
    conf = RapidsConf(dict(STAGE_TIMEOUT, **{
        "spark.rapids.tpu.test.injectFaults": f"hang_query:q{qid}s*:*:30"}))
    out = {}

    def run():
        try:
            cluster.run_query(_groupby("port", rbs), conf)
        except BaseException as e:  # noqa: BLE001 — inspected below
            out["err"] = e

    th = threading.Thread(target=run)
    th.start()
    import time
    t0 = time.monotonic()
    while cluster._running_qctx is None and time.monotonic() - t0 < 30:
        time.sleep(0.02)
    time.sleep(0.5)
    assert cluster.cancel_running("test cancel")
    th.join(timeout=60)
    from spark_rapids_tpu_torch.lifecycle import QueryCancelled
    assert isinstance(out.get("err"), QueryCancelled)
    assert out["err"].reason == "user"
    assert not cluster.cancel_running()  # nothing runs now
    assert any(e["event"] == "query_cancelled"
               for e in cluster.last_scheduler.events)


def test_mesh_conf_raises_naming_item_17():
    with pytest.raises(NotImplementedError, match="item 17"):
        GpuProcessCluster(2, device="cpu", conf=RapidsConf(
            {"spark.rapids.tpu.mesh.enabled": "true"}))


@pytest.mark.parametrize("parts", ["1", "16"])
def test_every_corpus_plan_pickles_as_structure(parts, paths):
    texts = dict(nds.SQL_QUERIES)
    texts.update(fb.SQL_QUERIES)
    for q, sql in texts.items():
        conf = dict(fb.CONF.get(q, {}),
                    **{"spark.sql.shuffle.partitions": parts})
        pp = _planned(paths, sql, conf)
        assert plan_pickle_refusals(pp.root) == [], q
    # a plan that holds a tensor or a lock is refused
    bad = HostBatchSourceExec([pa.record_batch({"x": pa.array([1])})])
    bad.stash = (torch.zeros(2), threading.Lock())
    assert sorted(plan_pickle_refusals(bad)) == ["lock", "tensor (2,) on cpu"]


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the host has a card: a cuda worker runs there")
def test_cuda_worker_without_a_card_fails_its_task(tmp_path):
    rbs = _groupby_batches()
    with GpuProcessCluster(1, root=str(tmp_path)) as c:
        assert c.device.type == "cuda"
        with pytest.raises(RuntimeError, match="failed after 1 attempts"
                           "(.|\n)*CUDA"):
            c.run_query(_groupby("port", rbs), RapidsConf(dict(
                STAGE_TIMEOUT, **{"spark.rapids.tpu.task.maxAttempts": 1})))
        errs = [n for n in os.listdir(os.path.join(c.root, "tasks"))
                if n.endswith(".err")]
        assert errs
        with open(os.path.join(c.root, "tasks", errs[0])) as f:
            assert "CUDA" in f.read()
        assert c.kernel_launches(winners_only=False) \
            == {0: {k: 0 for k in c.last_kernel_reports[0]["launches"]}}


def test_workers_share_the_card_budget(monkeypatch):
    """Queue C: each worker's ledger takes its share of the card when no
    budget is set; the reference's workers run on the CPU by default."""
    from spark_rapids_tpu_torch import memory
    monkeypatch.setattr(memory, "_device_memory", lambda device=None: 80e9)
    monkeypatch.setenv(ENV_SHARING, "2")
    cuda = torch.device("cuda", 0)
    conf = _task_conf({"conf": {}}, cuda)
    assert conf.get(memory.DEVICE_BUDGET) == int(80e9 * 0.85) // 2
    set_budget = _task_conf(
        {"conf": {"spark.rapids.memory.device.budgetBytes": "1000"}}, cuda)
    assert set_budget.get(memory.DEVICE_BUDGET) == 1000
    assert not _task_conf({"conf": {}}, torch.device("cpu")).get(
        memory.DEVICE_BUDGET)


def test_host_shuffle_in_process_equals_the_cluster(cluster, paths):
    sql = nds.SQL_QUERIES["q_rank"]
    got = cluster.run_query(_planned(paths, sql))
    local, _ = run_port(sql, paths, dict(
        CONF16, **{"spark.rapids.shuffle.mode": "HOST"}))
    assert_same_rows(got, local, ordered=True, label="q_rank")


def _read_over_exchange(cluster_mod, root, exchange_cls):
    """The plan as the cluster's final stage sees it: adaptive readers
    stripped, the one exchange replaced by a shuffle read."""
    plan = cluster_mod._strip_aqe_reads(root)
    exch = cluster_mod._deepest_exchange(plan)
    assert isinstance(exch, exchange_cls)
    kw = {"partitioning": exch.partitioning} \
        if cluster_mod.__name__.startswith("spark_rapids_tpu_torch") else {}
    read = cluster_mod.ProcessShuffleReadExec(
        "/unused", 1, list(range(16)), exch.child.output_schema, **kw)
    return cluster_mod._replace_node(plan, exch, read)


def test_regions_with_a_global_operator_run_as_one_task(paths):
    """Queue C: q3's final region (an aggregate by the exchange's keys,
    then a sort and a limit) needs every partition at once, so the port
    runs it as one task; the reference slices it over the workers, each
    slice sorting and limiting its own partitions. The aggregate below
    the sort is local to the partitions in both."""
    import copy
    from spark_rapids_tpu import cluster as jcluster
    from spark_rapids_tpu.exec.exchange import TpuShuffleExchangeExec
    from spark_rapids_tpu.planner import TpuOverrides
    from spark_rapids_tpu.session import TpuSession
    from spark_rapids_tpu.tools import nds as jnds
    from spark_rapids_tpu_torch import cluster as tcluster
    from spark_rapids_tpu_torch.exec.aggregate import GpuHashAggregateExec
    from spark_rapids_tpu_torch.exec.exchange import GpuShuffleExchangeExec
    sql = nds.SQL_QUERIES["q3"]
    port = _read_over_exchange(tcluster, _planned(paths, sql).root,
                               GpuShuffleExchangeExec)
    assert tcluster._distribution(port) is None
    agg = next(n for n in _walk(port)
               if isinstance(n, GpuHashAggregateExec))
    assert tcluster._distribution(agg) is not None
    s = TpuSession(conf=dict(CONF16))
    jnds.register_frames(s, {k: s.read_parquet(p) for k, p in paths.items()})
    ref = _read_over_exchange(
        jcluster, TpuOverrides(s.conf).apply(s.sql(sql)._node).root,
        TpuShuffleExchangeExec)
    halves = [jcluster._slice_partitions(copy.deepcopy(ref), w, 2)
              for w in range(2)]
    assert all(h is not None for h in halves)


def test_status_provider_reports_the_cluster(cluster, tmp_path,
                                             monkeypatch):
    """The cluster's ``/status`` part: its workers and device, and the
    warehouse's newest ``spark.rapids.warehouse.statusRows`` rows."""
    from spark_rapids_tpu_torch.obs import metrics, warehouse
    d = str(tmp_path / "wh")
    conf = RapidsConf({"spark.rapids.warehouse.dir": d,
                       "spark.rapids.warehouse.statusRows": "2"})
    for i in range(3):
        warehouse.append_row(conf, {"query_id": f"q{i}",
                                    "outcome": "completed"})
    monkeypatch.setattr(cluster, "conf", conf)
    metrics.set_status_provider(cluster._status_doc)
    doc = metrics.render_status()
    assert doc["cluster"]["n_workers"] == 2
    assert doc["cluster"]["device"] == "cpu"
    assert [r["query_id"] for r in doc["warehouse_tail"]] == ["q1", "q2"]
    assert doc["in_flight"] == []
