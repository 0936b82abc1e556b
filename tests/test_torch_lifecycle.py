"""The port's query lifecycle (``spark_rapids_tpu_torch/lifecycle.py``,
``PhysicalPlan.collect``, ``GpuSession.query_context``) against the JAX
package's, both on the CPU, at small sizes:

- a user cancel, a deadline and a memory budget (``action=cancel``, and
  ``degrade`` walking the ladder to its budget terminal) stop a query
  with the same ``QueryCancelled`` reason in both packages, and leave
  no ledger byte and no admission slot behind;
- for a scripted arrival sequence of weighted tenants, the fair
  admission grants slots in the reference's order; a full tenant queue
  and a queue timeout reject as ``admission``;
- under an OOM storm the ladder's rungs come in order (halve, spill,
  width1, cpu), and the CPU rung's rows equal the oracle and the
  reference's, with ``ladderCpuFallback`` on the root.

Tolerance: exact (reasons, order, rows; the sums are of integers)."""
import threading
import time

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import lifecycle as jlc
from spark_rapids_tpu.config import RapidsConf as JConf
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import lifecycle as tlc
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.memory import DeviceMemoryManager
from spark_rapids_tpu_torch.session import GpuSession

PACKAGES = {"port": (tlc, RapidsConf), "reference": (jlc, JConf)}

SQL = "SELECT k, SUM(v) AS s, COUNT(*) AS n FROM t GROUP BY k ORDER BY k"


def _table(rows=512):
    rng = np.random.default_rng(3)
    return pa.table({"k": pa.array(rng.integers(0, 7, rows), pa.int64()),
                     "v": pa.array(rng.integers(-100, 100, rows),
                                   pa.int64())})


def _oracle(t):
    k = t.column("k").to_numpy()
    v = t.column("v").to_numpy()
    keys = np.unique(k)
    return pa.table({"k": pa.array(keys, pa.int64()),
                     "s": pa.array([int(v[k == x].sum()) for x in keys],
                                   pa.int64()),
                     "n": pa.array([int((k == x).sum()) for x in keys],
                                   pa.int64())})


def _session(which, conf):
    conf = dict({"spark.sql.shuffle.partitions": "1"}, **conf)
    if which == "port":
        s = GpuSession(conf, device="cpu")
    else:
        s = TpuSession(conf)
    s.register_table("t", _table())
    return s


def _reason(which, conf, qctx_kw=None, cancel_first=False):
    s = _session(which, conf)
    qx = s.query_context(**(qctx_kw or {}))
    if cancel_first:
        qx.cancel("stop")
    exc = tlc.QueryCancelled if which == "port" else jlc.QueryCancelled
    with pytest.raises(exc) as e:
        s.sql(SQL).collect(qx)
    return e.value.reason, qx


@pytest.mark.parametrize("case", ["user", "deadline", "budget_cancel",
                                  "budget_degrade"])
def test_cancel_reasons_match_reference(case):
    conf, kw, first = {}, None, False
    if case == "user":
        first = True
    elif case == "deadline":
        kw = {"deadline_s": 1e-9}
    elif case == "budget_cancel":
        conf = {"spark.rapids.query.memoryBudgetBytes": "1",
                "spark.rapids.query.memoryBudget.action": "cancel"}
    else:
        conf = {"spark.rapids.query.memoryBudgetBytes": "1",
                "spark.rapids.sql.oomRetry.maxSplits": "1"}
    got = {w: _reason(w, conf, kw, first) for w in PACKAGES}
    want = {"user": "user", "deadline": "deadline",
            "budget_cancel": "budget", "budget_degrade": "budget"}[case]
    assert {w: r for w, (r, _) in got.items()} \
        == {"port": want, "reference": want}
    if case == "budget_degrade":
        # the walk is visible and the same: halving, spill, width1, and
        # the terminal rung, classified as the budget
        assert got["port"][1].ladder.counts \
            == got["reference"][1].ladder.counts
        assert got["port"][1].ladder.counts.get("width1", 0) >= 1


def test_deadline_from_conf_and_nothing_left_behind():
    s = _session("port", {"spark.rapids.query.deadline": "0.000001"})
    mm = DeviceMemoryManager.shared(s.conf, s.device)
    time.sleep(0.01)
    with pytest.raises(tlc.QueryCancelled) as e:
        s.sql(SQL).collect()
    assert e.value.reason == "deadline"
    assert mm.device_bytes == 0
    assert mm.leak_report() == "no leaked catalog entries"
    snap = mm.admission.snapshot()
    assert snap["in_use"] == 0 and not snap["queued"]
    assert snap["exclusive"] is None


def test_user_cancel_mid_run_releases_everything():
    s = GpuSession({"spark.sql.shuffle.partitions": "4"}, device="cpu")
    rbs = [pa.record_batch({"a": pa.array(np.arange(200, dtype=np.int64)),
                            "b": pa.array(np.arange(200, dtype=np.int64)
                                          % 5)}) for _ in range(40)]
    s.register_table("big", pa.Table.from_batches(rbs))
    qx = s.query_context()
    mm = DeviceMemoryManager.shared(s.conf, s.device)
    threading.Timer(0.05, qx.cancel).start()
    with pytest.raises(tlc.QueryCancelled) as e:
        for _ in range(300):  # until the cancel lands mid-run
            s.sql("SELECT b, SUM(a) AS s FROM big GROUP BY b").collect(qx)
    assert e.value.reason == "user"
    assert mm.device_bytes == 0
    snap = mm.admission.snapshot()
    assert snap["in_use"] == 0 and not snap["queued"]


def _grant_order(which):
    """Two slots held by tenants a and b; five waiters queue in a fixed
    order; the slots free one at a time, and each grant is recorded
    before the next slot frees."""
    mod, Conf = PACKAGES[which]
    conf = Conf({"spark.rapids.query.admission.weights": "a:3,b:1"})
    ctl = mod.FairAdmissionController(2, conf)
    held = [ctl.slot(mod.QueryContext(conf, tenant=t, query_id=f"h{t}"))
            for t in ("a", "b")]
    got, events, threads = [], {}, []

    def waiter(tenant, tag):
        with ctl.slot(mod.QueryContext(conf, tenant=tenant, query_id=tag)):
            got.append(tag)
            events[tag].wait(10)

    arrivals = [("b", "b1"), ("a", "a1"), ("b", "b2"), ("a", "a2"),
                ("c", "c1")]
    for i, (tenant, tag) in enumerate(arrivals):
        events[tag] = threading.Event()
        th = threading.Thread(target=waiter, args=(tenant, tag))
        th.start()
        threads.append(th)
        deadline = time.monotonic() + 5
        while sum(ctl.snapshot()["queued"].values()) < i + 1:
            assert time.monotonic() < deadline
            time.sleep(0.005)
    release = [h.release for h in held]
    while release:
        n = len(got)
        release.pop(0)()
        deadline = time.monotonic() + 5
        while len(got) == n and len(got) < len(arrivals):
            assert time.monotonic() < deadline
            time.sleep(0.005)
        if len(got) > n:
            release.append(events[got[-1]].set)
    for th in threads:
        th.join(5)
    snap = ctl.snapshot()
    assert snap["in_use"] == 0 and not snap["queued"]
    return got


def test_fair_admission_grant_order_matches_reference():
    port = _grant_order("port")
    assert port == _grant_order("reference")
    assert sorted(port) == ["a1", "a2", "b1", "b2", "c1"]
    assert port[0] == "a1"  # a (0/3) before the earlier b (1/1)


@pytest.mark.parametrize("which", list(PACKAGES))
def test_admission_rejections_classify(which):
    mod, Conf = PACKAGES[which]
    ctl = mod.FairAdmissionController(1, Conf({
        "spark.rapids.query.admission.maxQueuedPerTenant": "1",
        "spark.rapids.query.admission.timeout": "0.2"}))
    held = ctl.slot(None)
    parked = threading.Thread(target=lambda: pytest.raises(
        mod.QueryCancelled, ctl.slot, mod.QueryContext(Conf({}),
                                                       tenant="t")))
    parked.start()
    time.sleep(0.05)
    with pytest.raises(mod.QueryCancelled) as e:
        ctl.slot(mod.QueryContext(Conf({}), tenant="t"))
    assert e.value.reason == "admission" and "queue full" in e.value.detail
    parked.join(5)
    qx = mod.QueryContext(Conf({}), tenant="u")
    with pytest.raises(mod.QueryCancelled) as e:
        ctl.slot(qx)
    assert e.value.reason == "admission" and qx.token.reason == "admission"
    held.release()
    assert ctl.snapshot()["in_use"] == 0 and not ctl.snapshot()["queued"]


def test_token_first_cancel_wins_and_classifies():
    tok = tlc.CancellationToken("q1")
    assert tok.poll() is None and not tok.cancelled
    assert tok.cancel("budget", "too big")
    assert not tok.cancel("user")
    with pytest.raises(tlc.QueryCancelled) as e:
        tok.check()
    assert (e.value.reason, e.value.detail, e.value.query_id) \
        == ("budget", "too big", "q1")
    with pytest.raises(ValueError):
        tok.cancel("bogus")
    assert tlc.CANCEL_REASONS == jlc.CANCEL_REASONS
    assert tlc.LADDER_RUNGS == jlc.LADDER_RUNGS


def test_oom_storm_walks_the_ladder_to_the_cpu_rung():
    conf = {"spark.rapids.sql.test.injectRetryOOM.storm": "200",
            "spark.rapids.sql.oomRetry.maxSplits": "2"}
    rows, counts = {}, {}
    for which in PACKAGES:
        s = _session(which, conf)
        qx = s.query_context()
        rows[which] = s.sql(SQL).collect(qx)
        counts[which] = qx.ladder
    want = _oracle(_table()).to_pydict()
    assert rows["port"].to_pydict() == rows["reference"].to_pydict() == want
    for which, ladder in counts.items():
        for rung in ("halve", "spill", "width1", "cpu"):
            assert ladder.counts.get(rung, 0) >= 1, (which, ladder.counts)
    # the rungs above halving come once each, in order
    assert [r for r, _ in counts["port"].causes] \
        == ["spill", "width1", "cpu"]
    # the root says the query fell back, and the plan runs again after
    s = _session("port", conf)
    pp = s.sql(SQL)._plan()
    out = pp.collect()
    assert out.to_pydict() == want
    assert pp.last_ctx.metric(pp.root, "ladderCpuFallback").value == 1
    assert pp.last_ctx.mm.device_bytes == 0


def test_lifecycle_off_runs_without_a_context():
    s = _session("port", {"spark.rapids.lifecycle.enabled": "false"})
    pp = s.sql(SQL)._plan()
    assert pp.collect().to_pydict() == _oracle(_table()).to_pydict()
    assert pp.last_qctx is None
