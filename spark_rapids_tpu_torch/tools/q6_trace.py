"""Where q6's time goes on the card: one traced run of q6 SF1 from Parquet.

    python3 -m spark_rapids_tpu_torch.tools.q6_trace [--out DIR]
        [--query q6|q6_host_decode|q6_by_linenumber] [--conf KEY=VALUE ...]

Writes the SF1 files as ``chip_smoke.py`` does (seed 0, 8 files), runs
the query once to warm up, then once under ``torch.profiler`` (CPU and
CUDA activity). ``q6`` decodes pages on the card (the default, as in the
reference), ``q6_host_decode`` with pyarrow on the host, and
``q6_by_linenumber`` is q6's revenue grouped by line number; ``--conf``
sets further engine settings. Prints the
wall time, the device time by kernel and copy name, the device busy and
idle shares of the wall time, and the device time and kernel launches
of K1, K2 and K5 (one kernel a call each; q6 gives 8 of K1 and of K5),
as one JSON line; with ``--out`` it also writes the Chrome
trace there. Busy time sums the device activities, so copies
on the side stream that overlap a kernel count twice: the idle share is
a lower bound. It needs a CUDA device.

The port's span tracer (``obs/tracer.py``, ``spark.rapids.trace.dir``)
records host spans only, so this script reads the profiler directly.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .. import tpch
from ..config import RapidsConf
from ..exec.base import ExecCtx, collect_arrow
from ..io.scan import GpuFileScanExec

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


# kernel-name prefixes of each CUDA source's kernels
_KERNELS = {"k1": "fps_", "k2": "ffa_", "k5": "k5_"}
QUERIES = ("q6", "q6_host_decode", "q6_by_linenumber")


def trace_q6(out_dir=None, query: str = "q6", settings=None) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("q6_trace needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile
    grouped = query == "q6_by_linenumber"
    paths = tpch.write_lineitem(
        tpch.gen_lineitem(tpch.SF1_ROWS, seed=0, linenumber=grouped),
        os.path.join(_ROOT, ".bench_cache", "lineitem_grouped_torch"
                     if grouped else "lineitem_torch"), seed=0)
    conf = RapidsConf(
        {"spark.rapids.sql.format.parquet.deviceDecode.enabled":
         str(query != "q6_host_decode").lower(), **(settings or {})})
    plan = (tpch.build_q6_by_linenumber if grouped else tpch.build_q6)(
        GpuFileScanExec(paths, schema=tpch.LINEITEM_GROUPED_SCHEMA
                        if grouped else tpch.LINEITEM_SCHEMA))
    device = torch.device("cuda", 0)
    collect_arrow(plan, ExecCtx(conf, device))  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        collect_arrow(plan, ExecCtx(conf, device))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0:
            by_name[evt.key] = {"device_us": us, "calls": evt.count}
    busy = sum(v["device_us"] for v in by_name.values())
    kernels = {}
    for label, prefix in _KERNELS.items():
        mine = {k: v for k, v in by_name.items() if prefix in k}
        kernels[label] = {
            "device_us_total": sum(v["device_us"] for v in mine.values()),
            "launches": sum(v["calls"] for v in mine.values()),
            "by_kernel": mine}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir,
                                              f"{query}_trace.json"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1]["device_us"])[:12]
    return {"query": query, "settings": settings or {},
            "device": torch.cuda.get_device_name(0),
            "wall_us": wall_us, "device_busy_us": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_us),
            "kernels": kernels, "top_device_ops": dict(top)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the Chrome trace")
    ap.add_argument("--query", default="q6", choices=QUERIES)
    ap.add_argument("--conf", nargs="*", default=[],
                    help="engine settings as KEY=VALUE")
    args = ap.parse_args()
    settings = dict(kv.split("=", 1) for kv in args.conf)
    print(json.dumps(trace_q6(args.out, args.query, settings)))


if __name__ == "__main__":
    main()
