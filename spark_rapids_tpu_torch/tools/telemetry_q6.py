"""q6 SF1 from Parquet with every telemetry sink on, in a process of its own.

    python3 -m spark_rapids_tpu_torch.tools.telemetry_q6 --out DIR
        [--rows N] [--device cpu]

Writes the SF1 files as ``chip_smoke.py`` does (seed 0, 8 files, under
``.bench_cache/lineitem_torch/``; ``--rows`` writes a smaller set beside
them), plans q6 over the device-decode scan with ``GpuOverrides`` and runs
``PhysicalPlan.collect`` once, the process's first query, with the span
tracer, the event log and the warehouse on (each a directory under DIR)
and ``spark.rapids.profile.path`` set (DIR/profile).
Prints one JSON line: the revenue, the Chrome trace's ``query`` spans and
the operator ids its ``op`` spans ran beside the plan's, the
``torch.profiler`` trace's K1 (``fps_``) and K5 (``k5_``) kernel
launches beside the launches their wrappers counted, ``rapids_scan_device_chunks_total``'s delta beside the folded
``deviceChunks``, the warehouse rows and event-log lines, and the run's
wall time. The profiler runs here because a trace after a long traced
run in one process loses device records.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .. import tpch
from ..config import RapidsConf
from ..exec.base import ExecCtx
from ..io.scan import GpuFileScanExec
from ..obs import warehouse
from ..obs.metrics import REGISTRY
from ..obs.opmetrics import fold_ctx
from ..obs.tracer import load_chrome_trace
from ..ops.cuda_kernels import filter_product_sum
from ..ops.parquet_decode import decode_batch
from ..planner import GpuOverrides
from .event_log import read_event_logs

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: kernel-name prefixes of K1's and K5's kernels
KERNEL_PREFIXES = {"k1": "fps_", "k5": "k5_"}
#: the wrappers that launch them
WRAPPERS = {"k1": filter_product_sum, "k5": decode_batch}


def _device_chunks_total() -> float:
    fam = REGISTRY.snapshot().get("rapids_scan_device_chunks_total")
    return fam["samples"].get("", 0) if fam else 0


def plan_op_ids(root) -> set:
    """Every operator id of a planned tree."""
    out, stack = set(), [root]
    while stack:
        n = stack.pop()
        out.add(n._op_id)
        stack.extend(n.children)
    return out


def traced_op_ids(spans) -> tuple:
    """``(query spans, operator ids run)`` of one trace's span dicts: an
    ``op`` span's ``op_id`` and the ids its fused stage ran."""
    ran = set()
    for s in spans:
        if s["cat"] == "op":
            ran.add(s["args"]["op_id"])
            ran.update(s["args"].get("fused", ()))
    return sum(1 for s in spans if s["cat"] == "query"), ran


def run(out_dir: str, rows: int = tpch.SF1_ROWS, device=None) -> dict:
    device = torch.device(device or "cuda")
    sub = "lineitem_torch" if rows == tpch.SF1_ROWS \
        else f"lineitem_torch_n{rows}"
    paths = tpch.write_lineitem(
        tpch.gen_lineitem(rows, seed=0),
        os.path.join(_ROOT, ".bench_cache", sub), seed=0)
    dirs = {k: os.path.join(out_dir, k)
            for k in ("trace", "events", "warehouse", "profile")}
    plan = tpch.build_q6(GpuFileScanExec(paths,
                                         schema=tpch.LINEITEM_SCHEMA))
    pp = GpuOverrides(RapidsConf({
        "spark.rapids.trace.dir": dirs["trace"],
        "spark.rapids.eventLog.dir": dirs["events"],
        "spark.rapids.warehouse.dir": dirs["warehouse"],
        "spark.rapids.profile.path": dirs["profile"]}), device).apply(plan)
    ctx = ExecCtx(pp.conf, device)
    chunks0 = _device_chunks_total()
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    out = pp.collect(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    chunks = _device_chunks_total() - chunks0
    folded = fold_ctx(ctx)
    (trace,) = os.listdir(dirs["trace"])
    spans = load_chrome_trace(os.path.join(dirs["trace"], trace))
    query_spans, traced = traced_op_ids(spans)
    kernels = {k: 0 for k in KERNEL_PREFIXES}
    with open(pp.last_profiler_trace) as f:
        events = json.load(f)["traceEvents"]
    device_kernels = 0
    for e in events:
        if str(e.get("cat", "")).lower() != "kernel":
            continue
        device_kernels += 1
        for k, prefix in KERNEL_PREFIXES.items():
            # a kernel's name as the profiler demangles it: "void k5_..."
            if prefix in e.get("name", ""):
                kernels[k] += 1
    rows_wh = warehouse.read_rows(dirs["warehouse"])
    return {
        "revenue": out.column("revenue")[0].as_py(),
        "rows": out.num_rows,
        "query_spans": query_spans,
        "op_spans": sum(1 for s in spans if s["cat"] == "op"),
        "plan_op_ids": sorted(plan_op_ids(pp.root)),
        "traced_op_ids": sorted(traced),
        "trace_file": os.path.join(dirs["trace"], trace),
        "profiler_trace": pp.last_profiler_trace,
        "profiler_kernel_launches": kernels,
        "wrapper_launches": {k: w.launches for k, w in WRAPPERS.items()},
        "profiler_device_kernels": device_kernels,
        "scan_device_chunks_delta": chunks,
        "folded_device_chunks": sum(st["metrics"].get("deviceChunks", 0)
                                    for st in folded.values()),
        "warehouse_rows": [{k: r.get(k) for k in (
            "outcome", "device_kind", "scan", "fingerprint")}
            for r in rows_wh],
        "event_lines": [e.get("type", "query")
                        for e in read_event_logs(dirs["events"])],
        "wall_s": wall,
        "device": str(device)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True,
                    help="directory for the sinks' files")
    ap.add_argument("--rows", type=int, default=tpch.SF1_ROWS)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    if args.device is None and not torch.cuda.is_available():
        raise SystemExit("telemetry_q6 needs a CUDA device "
                         "(--device cpu for a dry run)")
    print(json.dumps(run(args.out, args.rows, args.device)))


if __name__ == "__main__":
    main()
