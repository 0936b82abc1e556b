"""The port's static plan verifier against the JAX package's, on the CPU,
planning only (nothing runs except where a test says so).

- Every text of ``nds.PORTED_QUERIES``, ``tools/nds_joins.py``,
  ``tools/nds_fallback.py`` (under its ``CONF``) and
  ``tools/nds_memory.py`` (under ``conf_for``), planned by both packages
  over the same in-memory tables (``nds.gen_tables(1 << 10)``) under an
  explicit 1 GiB device budget, verifies clean in both, with equal
  ``nodes_checked``, ``hbm_estimate_bytes`` and ``hbm_budget_bytes``.
  The two rebuilt trees have the same shape on every text at 1 and 16
  partitions (the reference's AQE join switch, which the port does not
  have, wraps only a shuffled hash join over exchanges, which no SQL
  text plans), so no count differs.
- Each defect the reference's ``tests/test_plan_verifier.py:65-198``
  seeds is built in both packages and refused with the same reason, the
  same node and a detail equal once the class names' ``Tpu``/``Gpu``
  prefixes are dropped. Where the port's constructor refuses the defect
  itself (the adaptive reader over a non-exchange, a map sort key), the
  defect is made as a stale rebuild would make it. The broadcast
  exchange the reference's budget case uses has no port yet (ROADMAP
  item 17): both packages are held to the same defect on the other
  resident operator, an aggregate's single pass (a percentile).
- The exact percentile's plan (q_percentile over Parquet files) is
  refused by both with ``hbm_over_budget`` and the same estimate under a
  budget below its scan's file bytes, and passes in both under a budget
  above the estimate.
- ``spark.rapids.sql.verifyPlan`` on: the planner raises
  ``PlanVerificationError`` with the report; off: the broken plan is
  planned and reaches execution, as in the reference.
- ``python -m spark_rapids_tpu_torch.analysis.plan_verifier --smoke
  --device cpu`` exits 0.
"""
import copy
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu_torch import datatypes as tdt
from spark_rapids_tpu_torch import nds
from spark_rapids_tpu_torch.analysis.plan_verifier import (
    PlanVerificationError, verify_plan)
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exec.base import HostBatchSourceExec
from spark_rapids_tpu_torch.expr.base import UnresolvedColumn
from spark_rapids_tpu_torch.planner import GpuOverrides
from spark_rapids_tpu_torch.session import GpuSession
from spark_rapids_tpu_torch.tools import nds_fallback, nds_joins, nds_memory

from spark_rapids_tpu import datatypes as jdt
from spark_rapids_tpu.analysis.plan_verifier import \
    PlanVerificationError as JPlanVerificationError
from spark_rapids_tpu.analysis.plan_verifier import verify_plan as jverify
from spark_rapids_tpu.config import RapidsConf as JConf
from spark_rapids_tpu.exec.base import HostBatchSourceExec as JSource
from spark_rapids_tpu.expr import UnresolvedColumn as JCol
from spark_rapids_tpu.planner import TpuOverrides
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.tools import nds as jnds

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET = str(1 << 30)


@pytest.fixture(scope="module")
def tables():
    return nds.gen_tables(1 << 10)


def _corpus():
    out = []
    for tag, mod, confs in (
            ("nds", nds, {}), ("joins", nds_joins, {}),
            ("fallback", nds_fallback, nds_fallback.CONF),
            ("memory", nds_memory,
             {q: nds_memory.conf_for(q, 1 << 30)
              for q in nds_memory.QUERIES})):
        queries = nds.PORTED_QUERIES if mod is nds else mod.QUERIES
        for q in queries:
            out.append((tag, q, mod.SQL_QUERIES[q], dict(confs.get(q, {}))))
    return out


CORPUS = _corpus()


def _plan_both(sql, tables, conf):
    """Both packages' planned plans (their planners verify too)."""
    s = GpuSession(dict(conf), device="cpu")
    nds.register_frames(s, {k: s.create_dataframe(v)
                            for k, v in tables.items()})
    pp = GpuOverrides(s.conf, s.device).apply(s.sql(sql)._node)
    js = TpuSession(dict(conf))
    jnds.register_frames(js, {k: js.create_dataframe(v)
                              for k, v in tables.items()})
    jpp = TpuOverrides(js.conf).apply(js.sql(sql)._node)
    return pp, s, jpp, js


@pytest.mark.parametrize("parts", [1, 16])
@pytest.mark.parametrize("tag,q,sql,conf", CORPUS,
                         ids=[f"{t}-{q}" for t, q, _, _ in CORPUS])
def test_every_text_verifies_clean_in_both(tables, tag, q, sql, conf,
                                           parts):
    conf = dict(conf)
    conf.setdefault("spark.rapids.memory.device.budgetBytes", BUDGET)
    conf["spark.sql.shuffle.partitions"] = str(parts)
    pp, s, jpp, js = _plan_both(sql, tables, conf)
    rep = verify_plan(pp.root, s.conf, s.device)
    jrep = jverify(jpp.root, js.conf)
    assert rep.ok and jrep.ok, (rep.summary(), jrep.summary())
    # the planner's own pass, kept on the plan, says the same
    assert pp.verify_report.to_dict() == rep.to_dict()
    assert rep.nodes_checked == jrep.nodes_checked > 1
    assert rep.hbm_estimate_bytes == jrep.hbm_estimate_bytes > 0
    assert rep.hbm_budget_bytes == jrep.hbm_budget_bytes == int(BUDGET)


# --- seeded defects ----------------------------------------------------------

def _norm(text: str) -> str:
    """A detail or label with the packages' class prefixes dropped."""
    return re.sub(r"\b(Tpu|Gpu)(?=[A-Z])", "", text)


def _same_refusal(rep, jrep, reason):
    assert not rep.ok and not jrep.ok
    assert reason in rep.reasons(), rep.summary()
    assert rep.reasons() == jrep.reasons(), (rep.summary(), jrep.summary())
    got = [(v.reason, v.op.split("#")[0], _norm(v.detail))
           for v in rep.violations]
    want = [(v.reason, v.op.split("#")[0], _norm(v.detail))
            for v in jrep.violations]
    assert got == want


def _batch(n=64, seed=0):
    rng = np.random.default_rng(seed)
    cols = {"a": pa.array(rng.integers(0, 100, n), pa.int64()),
            "b": pa.array(rng.uniform(0, 1, n), pa.float64()),
            "c": pa.array(rng.integers(0, 10, n), pa.int32())}
    return pa.record_batch(cols)


def _sources(rb):
    return HostBatchSourceExec([rb]), JSource([rb])


def test_schema_mismatch_out_of_range():
    from spark_rapids_tpu.exec.basic import TpuProjectExec
    from spark_rapids_tpu_torch.exec.basic import GpuProjectExec
    src, jsrc = _sources(_batch())
    narrow = pa.record_batch({"a": pa.array([1, 2], pa.int64())})
    nsrc, jnsrc = _sources(narrow)
    cols = ["a", "b", "c"]
    port = GpuProjectExec([UnresolvedColumn(c) for c in cols], src) \
        .with_new_children([nsrc])
    ref = TpuProjectExec([JCol(c) for c in cols], jsrc) \
        .with_new_children([jnsrc])
    _same_refusal(verify_plan(port), jverify(ref), "schema_mismatch")


def test_schema_mismatch_dtype():
    from spark_rapids_tpu.exec.basic import TpuProjectExec
    from spark_rapids_tpu_torch.exec.basic import GpuProjectExec
    src, jsrc = _sources(_batch())
    other = pa.record_batch({"a": pa.array(["x", "y"]),
                             "b": pa.array([0.1, 0.2], pa.float64()),
                             "c": pa.array([1, 2], pa.int32())})
    osrc, josrc = _sources(other)
    port = GpuProjectExec([UnresolvedColumn("a")], src) \
        .with_new_children([osrc])
    ref = TpuProjectExec([JCol("a")], jsrc).with_new_children([josrc])
    _same_refusal(verify_plan(port), jverify(ref), "schema_mismatch")


def test_union_width_mismatch_is_a_named_refusal():
    from spark_rapids_tpu.exec.misc import TpuUnionExec
    from spark_rapids_tpu_torch.exec.misc import GpuUnionExec
    s1, j1 = _sources(_batch(seed=1))
    s2, j2 = _sources(_batch(seed=2))
    narrow = pa.record_batch({"a": pa.array([1], pa.int64())})
    n, jn = _sources(narrow)
    port = GpuUnionExec([s1, s2]).with_new_children([s1, n])
    ref = TpuUnionExec([j1, j2]).with_new_children([j1, jn])
    _same_refusal(verify_plan(port), jverify(ref), "schema_mismatch")


def test_nullability_lie():
    from spark_rapids_tpu.exec.basic import TpuProjectExec
    from spark_rapids_tpu.expr.base import BoundReference as JRef
    from spark_rapids_tpu_torch.exec.basic import GpuProjectExec
    from spark_rapids_tpu_torch.expr.base import BoundReference
    src, jsrc = _sources(_batch())
    assert src.output_schema.fields[0].nullable
    port = GpuProjectExec([BoundReference(0, tdt.INT64, nullable_=False,
                                          name="a")], src)
    ref = TpuProjectExec([JRef(0, jdt.INT64, nullable_=False, name="a")],
                         jsrc)
    _same_refusal(verify_plan(port), jverify(ref), "nullability_lie")


def test_missing_exchange_and_copartitioned_children():
    from spark_rapids_tpu.exec.exchange import TpuShuffleExchangeExec
    from spark_rapids_tpu.exec.joins import TpuShuffledHashJoinExec
    from spark_rapids_tpu.shuffle.partitioner import \
        HashPartitioning as JHash
    from spark_rapids_tpu_torch.exec.exchange import GpuShuffleExchangeExec
    from spark_rapids_tpu_torch.exec.joins import GpuShuffledHashJoinExec
    from spark_rapids_tpu_torch.shuffle.partitioner import HashPartitioning
    left, jleft = _sources(_batch(seed=1))
    right, jright = _sources(_batch(seed=2))

    def port(nl, nr):
        return GpuShuffledHashJoinExec(
            [UnresolvedColumn("a")], [UnresolvedColumn("a")], "inner",
            GpuShuffleExchangeExec(
                HashPartitioning([UnresolvedColumn("a")], nl), left),
            GpuShuffleExchangeExec(
                HashPartitioning([UnresolvedColumn("a")], nr), right))

    def ref(nl, nr):
        return TpuShuffledHashJoinExec(
            [JCol("a")], [JCol("a")], "inner",
            TpuShuffleExchangeExec(JHash([JCol("a")], nl), jleft),
            TpuShuffleExchangeExec(JHash([JCol("a")], nr), jright))

    _same_refusal(verify_plan(port(4, 8)), jverify(ref(4, 8)),
                  "missing_exchange")
    assert verify_plan(port(4, 4)).ok and jverify(ref(4, 4)).ok


def test_hbm_over_budget_on_a_single_pass_aggregate():
    from spark_rapids_tpu.exec.aggregate import TpuHashAggregateExec
    from spark_rapids_tpu.expr import Alias as JAlias
    from spark_rapids_tpu.expr.aggregates import \
        ApproxPercentile as JPercentile
    from spark_rapids_tpu_torch.exec.aggregate import GpuHashAggregateExec
    from spark_rapids_tpu_torch.expr.aggregates import ApproxPercentile
    from spark_rapids_tpu_torch.expr.base import Alias
    src, jsrc = _sources(_batch(n=4096))
    assert src.static_bytes_estimate() == jsrc.static_bytes_estimate() \
        > 2048
    port = GpuHashAggregateExec(
        [UnresolvedColumn("c")],
        [Alias(ApproxPercentile(UnresolvedColumn("b"), 0.5), "p")], src)
    ref = TpuHashAggregateExec(
        [JCol("c")], [JAlias(JPercentile(JCol("b"), 0.5), "p")], jsrc)
    assert port.resident_footprint() and ref.resident_footprint()
    small = {"spark.rapids.memory.device.budgetBytes": 2048}
    rep = verify_plan(port, RapidsConf(small))
    jrep = jverify(ref, JConf(small))
    _same_refusal(rep, jrep, "hbm_over_budget")
    assert rep.hbm_budget_bytes == jrep.hbm_budget_bytes == 2048
    assert rep.hbm_estimate_bytes == jrep.hbm_estimate_bytes
    # a real budget: the same plans verify clean
    big = {"spark.rapids.memory.device.budgetBytes": BUDGET}
    assert verify_plan(port, RapidsConf(big)).ok
    assert jverify(ref, JConf(big)).ok


def _port_malformed_reader(src):
    """An adaptive reader over a non-exchange: the port's constructor
    refuses it, a stale rebuild makes it."""
    from spark_rapids_tpu_torch.exec.aqe import GpuAQEShuffleReadExec
    from spark_rapids_tpu_torch.exec.exchange import GpuShuffleExchangeExec
    from spark_rapids_tpu_torch.shuffle.partitioner import \
        SinglePartitioning
    reader = GpuAQEShuffleReadExec(
        GpuShuffleExchangeExec(SinglePartitioning(), src))
    return reader.with_new_children([src])


def test_malformed_aqe_wrapper():
    from spark_rapids_tpu.exec.aqe import TpuAQEShuffleReadExec
    src, jsrc = _sources(_batch())
    with pytest.raises(TypeError):
        from spark_rapids_tpu_torch.exec.aqe import GpuAQEShuffleReadExec
        GpuAQEShuffleReadExec(src)
    _same_refusal(verify_plan(_port_malformed_reader(src)),
                  jverify(TpuAQEShuffleReadExec(jsrc)),
                  "malformed_aqe_wrapper")


def test_unsupported_dtype_map_sort_key():
    from spark_rapids_tpu.exec.sort import SortOrder as JOrder
    from spark_rapids_tpu.exec.sort import TpuSortExec
    from spark_rapids_tpu_torch.exec.sort import GpuSortExec, SortOrder
    from spark_rapids_tpu_torch.expr.base import BoundReference
    rb = pa.record_batch({
        "m": pa.array([[("k", 1)], [("j", 2)]],
                      pa.map_(pa.string(), pa.int64())),
        "v": pa.array([1, 2], pa.int64())})
    src, jsrc = _sources(rb)
    mtype = src.output_schema.fields[0].dtype
    assert isinstance(mtype, tdt.MapType)
    # the port's sort refuses a map key as it is built; a plan whose
    # key was rebound after the check carries the defect
    with pytest.raises(NotImplementedError):
        GpuSortExec([SortOrder(UnresolvedColumn("m"))], src)
    port = GpuSortExec([SortOrder(UnresolvedColumn("v"))], src)
    port = copy.copy(port)
    port.orders = [dataclasses.replace(
        port.orders[0], child=BoundReference(0, mtype, True, "m"))]
    ref = TpuSortExec([JOrder(JCol("m"))], jsrc)
    _same_refusal(verify_plan(port), jverify(ref), "unsupported_dtype")


# --- the exact percentile under a budget -------------------------------------

@pytest.fixture(scope="module")
def paths(tables, tmp_path_factory):
    return nds.write_tables(tables, str(tmp_path_factory.mktemp("nds")))


def _plans_over_files(sql, paths, conf):
    s = nds.session_over_files(paths, conf, device="cpu")
    js = TpuSession(dict(conf))
    jnds.register_frames(js, {k: js.read_parquet(p)
                              for k, p in paths.items()})
    return s.sql(sql)._node, s, js.sql(sql)._node, js


def test_exact_percentile_refused_under_a_budget_below_its_scan(paths):
    sql = nds.SQL_QUERIES["q_percentile"]
    scan_bytes = os.path.getsize(paths["store_sales"])
    budget = scan_bytes // 2
    conf = {"spark.rapids.memory.device.budgetBytes": str(budget)}
    node, s, jnode, js = _plans_over_files(sql, paths, conf)
    with pytest.raises(PlanVerificationError) as ei:
        GpuOverrides(s.conf, s.device).apply(node)
    with pytest.raises(JPlanVerificationError) as jei:
        TpuOverrides(js.conf).apply(jnode)
    rep, jrep = ei.value.report, jei.value.report
    _same_refusal(rep, jrep, "hbm_over_budget")
    assert rep.reasons() == ["hbm_over_budget"]
    assert rep.hbm_estimate_bytes == jrep.hbm_estimate_bytes > budget
    assert rep.to_dict()["hbm_budget_bytes"] == budget
    assert all(v.op.startswith("HashAggregateExec")
               for v in rep.violations)
    # above the estimate, the same plan passes in both
    conf = {"spark.rapids.memory.device.budgetBytes":
            str(rep.hbm_estimate_bytes + 1)}
    node, s, jnode, js = _plans_over_files(sql, paths, conf)
    pp = GpuOverrides(s.conf, s.device).apply(node)
    TpuOverrides(js.conf).apply(jnode)
    assert pp.verify_report.ok
    assert pp.verify_report.hbm_estimate_bytes == rep.hbm_estimate_bytes


# --- the planner's switch ----------------------------------------------------

def test_planner_raises_and_the_switch_turns_it_off():
    from spark_rapids_tpu.exec.aqe import TpuAQEShuffleReadExec
    src, jsrc = _sources(_batch())
    broken = _port_malformed_reader(src)
    with pytest.raises(PlanVerificationError) as ei:
        GpuOverrides(RapidsConf(), "cpu").apply(broken)
    assert "malformed_aqe_wrapper" in str(ei.value)
    d = ei.value.report.to_dict()
    assert d["ok"] is False
    assert [v["reason"] for v in d["violations"]] == \
        ["malformed_aqe_wrapper"]
    with pytest.raises(JPlanVerificationError):
        TpuOverrides(JConf()).apply(TpuAQEShuffleReadExec(jsrc))
    # off: planned as in the reference, and the broken tree reaches
    # execution, where the reader finds no exchange to read
    off = {"spark.rapids.sql.verifyPlan": "false"}
    pp = GpuOverrides(RapidsConf(off), "cpu").apply(broken)
    assert pp.verify_report is None
    assert TpuOverrides(JConf(off)).apply(
        TpuAQEShuffleReadExec(jsrc)) is not None
    with pytest.raises(AttributeError, match="materialize"):
        pp.collect()


def test_smoke_entry_exits_zero():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m",
         "spark_rapids_tpu_torch.analysis.plan_verifier", "--smoke",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert '"nds_clean": true' in r.stdout
    assert '"seeded_rejected": true' in r.stdout
