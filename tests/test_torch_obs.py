"""The port's span tracer and metrics registry (``spark_rapids_tpu_torch/
obs/tracer.py``, ``obs/metrics.py``) against the JAX package's, and
their wiring into the engine.

- The tracer: the same calls on both packages' ``Tracer`` give the same
  spans (names, categories, ids, parents, processes, args; times aside):
  nesting a thread, a thread of its own, ``emit`` and ``absorb``, the
  span bound, id prefixes, and the category summary. A Chrome trace
  either package writes reads back alike through both loaders, and
  ``tools/check_obs_output.check_trace`` accepts the port's.
- The registry: the same updates give the same snapshot and the same
  Prometheus text, bounded label sets overflow into ``__other__``,
  merged snapshots carry a ``proc`` label, worker snapshot files cross
  read, and ``check_prometheus`` accepts the port's text and its
  ``/metrics`` endpoint on ``127.0.0.1``.
- The engine: a collect with ``spark.rapids.trace.dir`` set writes one
  trace with one ``query`` span and, for every operator id of the plan,
  an ``op`` span or a stage span that ran it; ``spark.rapids.profile
  .path`` writes a ``torch.profiler`` Chrome trace; the registry's
  deltas equal the memory manager's attributes (spill, disk spill,
  read-back, OOM retries), the ladder's counts, the token's reason and
  the scan's folded ``deviceChunks``; ``rapids_query_duration_seconds``
  counts one observation a collect.

The registry is process wide and pytest-xdist runs many files in one
process, so every check reads deltas.
"""
import importlib.util
import json
import os
import threading
import urllib.error
import urllib.request

import pytest

from spark_rapids_tpu.obs import metrics as jmetrics
from spark_rapids_tpu.obs import tracer as jtracer
from spark_rapids_tpu_torch import nds
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exec.base import ExecCtx
from spark_rapids_tpu_torch.obs import metrics as pmetrics
from spark_rapids_tpu_torch.obs import tracer as ptracer
from spark_rapids_tpu_torch.obs.opmetrics import fold_ctx
from spark_rapids_tpu_torch.planner import GpuOverrides
from spark_rapids_tpu_torch.tools import nds_memory as nm
from spark_rapids_tpu_torch.tools.telemetry_q6 import (plan_op_ids,
                                                       traced_op_ids)


def _checker():
    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "check_obs_output.py")
    spec = importlib.util.spec_from_file_location("check_obs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- the tracer -------------------------------------------------------------

def test_disabled_tracer_is_shared_noop(tmp_path):
    t = ptracer.tracer_from_conf(RapidsConf())
    assert t is ptracer.NULL_TRACER and not t.enabled
    assert t.span("a") is t.span("b")
    with t.span("x") as sp:
        assert sp.span_id is None
    assert t.drain() == [] and t.write_chrome("/nonexistent") == ""
    on = ptracer.tracer_from_conf(RapidsConf({
        "spark.rapids.trace.dir": str(tmp_path),
        "spark.rapids.trace.maxSpans": 7}), pid=3)
    assert on.enabled and on.pid == 3 and on.max_spans == 7
    assert ExecCtx(RapidsConf(), "cpu").tracer is ptracer.NULL_TRACER


def _scenario(mod, kind):
    """One span scenario on ``mod``'s Tracer; its drained spans."""
    if kind == "nested":
        t = mod.Tracer(trace_id="abc")
        with t.span("outer", cat="query", args={"fingerprint": "f"}):
            with t.span("inner", cat="op"):
                pass
            with t.span("sibling", cat="op", args={"op_id": 3}):
                pass
    elif kind == "threads":
        t = mod.Tracer(trace_id="abc")

        def work():
            with t.span("other-thread"):
                with t.span("its-child"):
                    pass

        with t.span("root"):
            th = threading.Thread(target=work)
            th.start()
            th.join()
    elif kind == "emit_absorb":
        t = mod.Tracer(trace_id="abc")
        t.emit("attempt t1 a0", "attempt", ts=100.0, dur=2.0,
               span_id="t1.a0", parent_id=None)
        t.absorb([{"name": "task t1 a0", "cat": "task",
                   "span_id": "t1.a0.1.1", "parent_id": "t1.a0",
                   "ts": 100.5, "dur": 1.0, "pid": 1},
                  {"garbage": True}, {"name": "no-id"}])
    elif kind == "bounded":
        t = mod.Tracer(trace_id="abc", max_spans=3)
        for i in range(5):
            with t.span(f"s{i}"):
                pass
        assert t.dropped == 2
    else:
        assert kind == "id_prefix"
        t = mod.Tracer(trace_id="x", pid=1, id_prefix="t1.a0.")
        with t.span("s"):
            with t.span("c"):
                pass
    out = t.drain()
    for s in out:
        s.pop("ts")
        s.pop("dur")
    return sorted(out, key=lambda s: s["span_id"]), t.summary()


@pytest.mark.parametrize("kind", ["nested", "threads", "emit_absorb",
                                  "bounded", "id_prefix"])
def test_spans_equal_reference(kind):
    got, got_sum = _scenario(ptracer, kind)
    want, want_sum = _scenario(jtracer, kind)
    assert got == want
    for s in (got_sum, want_sum):
        for c in s["by_cat"].values():
            c.pop("total_s")
    assert got_sum == want_sum
    if kind == "threads":
        other = [s for s in got if s["name"] == "other-thread"][0]
        assert other["parent_id"] is None


def test_span_closed_out_of_order_leaves_no_parent():
    """An operator's generator may close after a sibling opened (a
    consumer that stopped early): its id leaves the stack all the
    same."""
    t = ptracer.Tracer()
    a = t.span("a")
    a.__enter__()
    b = t.span("b")
    b.__enter__()
    a.__exit__(None, None, None)
    b.__exit__(None, None, None)
    with t.span("c"):
        pass
    spans = {s["name"]: s for s in t.drain()}
    assert spans["c"]["parent_id"] is None
    assert t._stack() == []


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_chrome_trace_cross_read(tmp_path, writer):
    mod = ptracer if writer == "port" else jtracer
    t = mod.Tracer(trace_id="deadbeef", pid=0)
    with t.span("query q1", cat="query", args={"fingerprint": "f"}):
        with t.span("Op#op2", cat="op", args={"op_id": 2}):
            pass
    t.absorb([{"name": "task", "cat": "task", "span_id": "w.1",
               "parent_id": None, "ts": 1.0, "dur": 0.5, "pid": 2}])
    path = t.write_chrome(str(tmp_path))
    assert os.path.basename(path) == "trace-deadbeef.json"
    assert _checker().check_trace(path) == []
    got = ptracer.load_chrome_trace(path)
    assert got == jtracer.load_chrome_trace(path)
    by_name = {s["name"]: s for s in got}
    assert by_name["Op#op2"]["parent_id"] == by_name["query q1"]["span_id"]
    assert by_name["Op#op2"]["args"]["op_id"] == 2
    names = {e["args"]["name"] for e in json.load(open(path))["traceEvents"]
             if e["ph"] == "M"}
    assert {"driver", "worker 1"} <= names


def test_trace_retention_prunes_oldest(tmp_path):
    for i in range(4):
        t = ptracer.Tracer(trace_id=f"t{i}", max_files=2)
        with t.span("q", cat="query"):
            pass
        p = t.write_chrome(str(tmp_path))
        os.utime(p, (i, i))
    assert sorted(os.listdir(tmp_path)) == ["trace-t2.json",
                                            "trace-t3.json"]


# --- the registry -----------------------------------------------------------

def _updates(mod):
    r = mod.MetricsRegistry()
    c = r.counter("rapids_test_total", 'escapes "quoted" help', ("k",))
    c.labels("x").inc()
    c.labels('v"1"').inc(2)
    g = r.gauge("rapids_g")
    g.set(5)
    g.dec(2)
    h = r.histogram("rapids_h_seconds", buckets=(0.1, 1.0, float("inf")))
    for v in (0.05, 0.1, 0.5, 10.0):
        h.observe(v)
    t = r.histogram("rapids_t_seconds", "", ("mode",),
                    buckets=mod.TRANSFER_BUCKETS)
    for v in (0.0002, 0.0003, 0.01, 7.0):
        t.labels("device").observe(v)
    b = r.counter("rapids_bounded_total", "", ("id",))
    for i in range(mod.MAX_CHILDREN + 10):
        b.labels(f"id{i}").inc()
    return r


def test_registry_snapshot_and_text_equal_reference():
    got, want = _updates(pmetrics), _updates(jmetrics)
    assert got.snapshot() == want.snapshot()
    text = pmetrics.dump_prometheus(got)
    assert text == jmetrics.dump_prometheus(want)
    assert _checker().check_prometheus(text) == []
    snap = got.snapshot()
    assert snap["rapids_h_seconds"]["samples"][""]["counts"] == [2, 3, 4]
    assert snap["rapids_bounded_total"]["samples"]["__other__"] == 10
    assert len(snap["rapids_bounded_total"]["samples"]) == \
        pmetrics.MAX_CHILDREN + 1
    assert got.counter("rapids_test_total") is \
        got.counter("rapids_test_total")
    with pytest.raises(ValueError):
        got.gauge("rapids_test_total")
    d, w = pmetrics.MetricsRegistry(), pmetrics.MetricsRegistry()
    d.counter("c_total").inc(1)
    w.counter("c_total").inc(41)
    tagged = [("driver", d.snapshot()), ("w0", w.snapshot())]
    merged = pmetrics.render_merged_snapshots(tagged)
    assert merged == jmetrics.render_merged_snapshots(tagged)
    assert 'c_total{proc="w0"} 41' in merged
    assert _checker().check_prometheus(merged) == []


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_worker_snapshots_cross_read(tmp_path, writer):
    wmod = pmetrics if writer == "port" else jmetrics
    r = wmod.MetricsRegistry()
    r.counter("n_total").inc(7)
    wmod.flush_worker_metrics(str(tmp_path), 0, r)
    with open(os.path.join(str(tmp_path), "metrics", "w1.json"), "w") as f:
        f.write('{"torn":')
    got = pmetrics.read_worker_metrics(str(tmp_path))
    assert got == jmetrics.read_worker_metrics(str(tmp_path))
    assert [t for t, _ in got] == ["w0"]
    assert got[0][1]["n_total"]["samples"][""] == 7


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_metrics_endpoint_serves_the_registry():
    assert pmetrics.maybe_start_http_server(RapidsConf()) is None
    port = pmetrics.maybe_start_http_server(RapidsConf(
        {"spark.rapids.metrics.port": str(_free_port())}))
    if port is None:
        pytest.skip("no free port on 127.0.0.1")
    pmetrics.REGISTRY.counter("rapids_http_test_total").inc()
    body = urllib.request.urlopen(
        f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
    assert _checker().check_prometheus(body) == []
    assert "rapids_http_test_total" in body
    assert "rapids_memory_device_bytes_in_use" in body
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=10)


# --- the engine -------------------------------------------------------------

N_SALES = 1 << 12


@pytest.fixture(scope="module")
def nds_paths(tmp_path_factory):
    return nds.write_tables(nds.gen_tables(N_SALES),
                            str(tmp_path_factory.mktemp("nds")),
                            row_group_size=1024)


def _plan(paths, sql, conf):
    s = nds.session_over_files(paths, conf, device="cpu")
    return GpuOverrides(s.conf, s.device).apply(s.sql(sql)._node)


def _sample(name, label=""):
    fam = pmetrics.REGISTRY.snapshot().get(name)
    if fam is None:
        return 0
    v = fam["samples"].get(label, 0)
    return v["count"] if isinstance(v, dict) else v


@pytest.mark.parametrize("q,parts", [("q3", 1), ("q3", 4), ("q97", 4),
                                     ("q_rank", 1)])
def test_collect_traces_every_operator(nds_paths, tmp_path, q, parts):
    conf = {"spark.sql.shuffle.partitions": str(parts),
            "spark.rapids.trace.dir": str(tmp_path / "trace")}
    pp = _plan(nds_paths, nds.SQL_QUERIES[q], conf)
    before = _sample("rapids_query_duration_seconds", "sql\tlocal")
    pp.collect(ExecCtx(pp.conf, "cpu"))
    assert _sample("rapids_query_duration_seconds", "sql\tlocal") \
        == before + 1
    (name,) = os.listdir(tmp_path / "trace")
    path = str(tmp_path / "trace" / name)
    assert _checker().check_trace(path) == []
    spans = ptracer.load_chrome_trace(path)
    assert spans == jtracer.load_chrome_trace(path)
    queries = [s for s in spans if s["cat"] == "query"]
    assert len(queries) == 1
    from spark_rapids_tpu_torch.tools.event_log import plan_fingerprint
    assert queries[0]["args"]["fingerprint"] == plan_fingerprint(pp.root)
    assert all(s["parent_id"] is not None for s in spans
               if s["cat"] == "op")
    n_query, ran = traced_op_ids(spans)
    assert n_query == 1 and ran == plan_op_ids(pp.root)


def test_profile_path_writes_a_torch_profiler_trace(nds_paths, tmp_path):
    pp = _plan(nds_paths, nds.SQL_QUERIES["q3"],
               {"spark.rapids.profile.path": str(tmp_path / "prof")})
    pp.collect(ExecCtx(pp.conf, "cpu"))
    path = pp.last_profiler_trace
    assert path and os.path.dirname(path) == str(tmp_path / "prof")
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    off = _plan(nds_paths, nds.SQL_QUERIES["q3"], {})
    off.collect(ExecCtx(off.conf, "cpu"))
    assert off.last_profiler_trace is None


_MEM_FAMILIES = {"rapids_memory_spill_bytes_total": "spill_bytes",
                 "rapids_memory_disk_spill_bytes_total": "disk_spill_bytes",
                 "rapids_spill_read_bytes_total": "spill_read_bytes",
                 "rapids_memory_oom_retries_total": "oom_retries"}


def _mem_run(paths, sql, conf):
    pp = _plan(paths, sql, conf)
    ctx = ExecCtx(pp.conf, "cpu")
    before = {f: _sample(f) for f in _MEM_FAMILIES}
    attrs = {a: getattr(ctx.mm, a) for a in _MEM_FAMILIES.values()}
    pp.collect(ctx)
    deltas = {a: _sample(f) - before[f] for f, a in _MEM_FAMILIES.items()}
    return pp, ctx, deltas, {a: getattr(ctx.mm, a) - v
                             for a, v in attrs.items()}


@pytest.mark.parametrize("case", ["spill", "oom_retry"])
def test_memory_registry_deltas_equal_the_managers(nds_paths, tmp_path,
                                                   case):
    if case == "spill":
        conf = dict(nm.conf_for("q_sales_sorted", 16 << 10), **{
            "spark.rapids.sql.batchSizeRows": "1024",
            "spark.rapids.sql.verifyPlan": "false",
            "spark.rapids.memory.spillDir": str(tmp_path)})
        sql = nm.SQL_QUERIES["q_sales_sorted"]
    else:
        conf = {"spark.rapids.sql.test.injectRetryOOM": "3"}
        sql = nds.SQL_QUERIES["q3"]
    _, ctx, deltas, attrs = _mem_run(nds_paths, sql, conf)
    assert deltas == attrs
    if case == "spill":
        assert attrs["spill_bytes"] > 0 and attrs["disk_spill_bytes"] > 0
        assert attrs["spill_read_bytes"] > 0
    else:
        assert attrs["oom_retries"] >= 1
    assert _sample("rapids_memory_device_bytes_in_use") == \
        ctx.mm.device_bytes
    assert _sample("rapids_memory_device_budget_bytes") == ctx.mm.budget


def test_lifecycle_registry_deltas(nds_paths):
    ladder_before = {r: _sample("rapids_query_degraded_total", r)
                     for r in ("halve", "spill", "width1", "cpu")}
    pp = _plan(nds_paths, nds.SQL_QUERIES["q3"], {
        "spark.rapids.sql.test.injectRetryOOM.storm": "64",
        "spark.rapids.sql.oomRetry.maxSplits": "1"})
    pp.collect(ExecCtx(pp.conf, "cpu"))
    counts = pp.last_qctx.ladder.counts
    assert counts == {"halve": 1, "spill": 1, "width1": 1, "cpu": 1}
    assert {r: _sample("rapids_query_degraded_total", r) - v
            for r, v in ladder_before.items()} == counts
    from spark_rapids_tpu_torch.lifecycle import (CancellationToken,
                                                  QueryCancelled)
    before = _sample("rapids_query_cancelled_total", "deadline")
    tok = CancellationToken("qdead", deadline_s=1e-9)
    with pytest.raises(QueryCancelled):
        tok.check()
    assert tok.reason == "deadline"
    assert tok.cancel("user") is False  # the first cancel wins
    assert _sample("rapids_query_cancelled_total", "deadline") == before + 1
    assert _sample("rapids_query_cancelled_total", "user") >= 0
    waits = _sample("rapids_admission_wait_seconds")
    pp = _plan(nds_paths, nds.SQL_QUERIES["q3"], {})
    pp.collect(ExecCtx(pp.conf, "cpu"))
    assert _sample("rapids_admission_wait_seconds") == waits + 1
    assert _sample("rapids_admission_queue_depth", "default") == 0


def test_scan_registry_deltas_equal_folded_chunks(nds_paths):
    pp = _plan(nds_paths, nds.SQL_QUERIES["q3"], {})
    ctx = ExecCtx(pp.conf, "cpu")
    dev = _sample("rapids_scan_device_chunks_total")
    asm = _sample("rapids_scan_assemble_seconds", "device")
    pp.collect(ctx)
    folded = fold_ctx(ctx)
    chunks = sum(st["metrics"].get("deviceChunks", 0)
                 for st in folded.values())
    batches = sum(st["metrics"].get("scanPrograms", 0)
                  for st in folded.values())
    assert chunks > 0
    assert _sample("rapids_scan_device_chunks_total") - dev == chunks
    assert _sample("rapids_scan_assemble_seconds", "device") - asm == \
        batches
    host = _plan(nds_paths, nds.SQL_QUERIES["q3"], {
        "spark.rapids.sql.format.parquet.deviceDecode.enabled": "false"})
    arrow = _sample("rapids_scan_upload_seconds", "arrow")
    host.collect(ExecCtx(host.conf, "cpu"))
    assert _sample("rapids_scan_upload_seconds", "arrow") > arrow
    assert _sample("rapids_scan_device_chunks_total") - dev == chunks
