"""Where an NDS query's time goes on the card: one traced run from SQL.

    python3 -m spark_rapids_tpu_torch.tools.nds_trace [--query NAME]
        [--partitions N] [--n-sales N] [--decimals | --nested]
        [--out DIR]

``NAME`` is any query the port runs from SQL: the corpus
(``nds.PORTED_QUERIES``), the outer, cross and nested-loop join texts
(``tools/nds_joins.QUERIES``), the SQL function texts
(``tools/nds_functions.QUERIES``) or, with ``--decimals``, the decimal
texts (``tools/nds_decimals.QUERIES``) over the tables whose money
columns are ``DECIMAL(7,2)``, written as Spark writes decimals into
``.bench_cache/nds_decimal_torch_n<N>/`` (``decimal_paths``) or, with
``--nested``, the nested texts (``tools/nds_nested.QUERIES``, DataFrame
builders or SQL) over the tables with ``ticket``, written into
``.bench_cache/nds_nested_torch_n<N>/`` (``nested_paths``).

Writes the NDS tables as ``chip_smoke.py`` phase 8 does (``nds.gen_tables``,
seed 42, snappy, row groups of 2^19; default 2^22 ``store_sales`` rows,
into ``.bench_cache/nds_torch_n<N>/``), compiles the query's SQL text
through ``GpuSession.sql`` and ``GpuOverrides``, runs it once to warm up,
then once under ``torch.profiler`` (CPU and CUDA activity). Prints one
JSON line: the wall time, the device's busy time (the union of the
intervals in which a kernel or a copy ran, so nothing counts twice) and
its idle share, the device time and kernel launches of K3
(``radix_histogram``, ``radix_plan``, ``radix_pass``), K4
(``gather_rows_*``), K5 (``k5_*``) and K6 (``regex_match_*``), the
wrappers' launch counts in the traced run, and the largest other device
operations (and the largest of all, ``top_device_ops``). The K3 and
K4 kernels launched inside ``sort_keys.string_order_ranks_multi`` (the
string keys' refinement passes, a ``record_function("string_ranks")``
range) are reported apart under ``string_ranks``: a kernel counts there
when it runs within the device-side span the profiler gives that range
(the span itself is left out of the busy time). The window operator's
pass (``exec/window.py``, a ``record_function("window")`` range: its
sort, string ranks included, its gathers and its torch ops) is reported
the same way under ``window``, with the device time of all its
operations and its largest operations by name. With ``--out`` it also writes
the Chrome trace there. It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .. import nds
from . import nds_decimals, nds_functions, nds_joins, nds_nested
from .join_trace import _union_us

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_RANGE = "string_ranks"  # sort_keys.string_order_ranks_multi's range
_WINDOW = "window"       # exec/window.GpuWindowExec's pass
_SQL = {**nds.SQL_QUERIES, **nds_joins.SQL_QUERIES,
        **nds_functions.SQL_QUERIES}
_FAMILIES = {"K3": ("radix_histogram", "radix_plan", "radix_pass"),
             "K4": ("gather_rows_fast", "gather_rows_any"),
             "K5": ("k5_",), "K6": ("regex_match_",)}


def _family(name: str):
    for fam, parts in _FAMILIES.items():
        if any(p in name for p in parts):
            return fam
    return None


def nds_paths(n_sales: int):
    """The NDS files at ``n_sales`` rows, written once under
    ``.bench_cache/``."""
    return nds.write_tables(nds.gen_tables(n_sales), os.path.join(
        _ROOT, ".bench_cache", f"nds_torch_n{n_sales}"))


def decimal_paths(n_sales: int, tables=None):
    """The decimal NDS files at ``n_sales`` rows (``nds_decimals.
    decimal_tables``, unless the caller has made ``tables``), written
    once under ``.bench_cache/`` with decimals as INT32/INT64."""
    if tables is None:
        tables = nds_decimals.decimal_tables(nds.gen_tables(n_sales))
    return nds.write_tables(tables, os.path.join(
        _ROOT, ".bench_cache", f"nds_decimal_torch_n{n_sales}"))


def nested_paths(n_sales: int, tables=None):
    """The nested NDS files at ``n_sales`` rows (``nds_nested.
    nested_tables``, unless the caller has made ``tables``), written
    once under ``.bench_cache/`` in row groups of 2^16."""
    if tables is None:
        tables = nds_nested.nested_tables(nds.gen_tables(n_sales))
    return nds_nested.write_tables(tables, os.path.join(
        _ROOT, ".bench_cache", f"nds_nested_torch_n{n_sales}"))


def counters():
    """The launch counters of K3, K4, K5, K6, K7 and K8's wrappers."""
    from ..ops import cuda_kernels as ck
    from ..ops.hash import xxhash64_strings
    from ..ops.parquet_decode import decode_batch
    from ..ops.regex import find_spans, regex_match
    return {"K3": ck.sort_pairs, "K4": ck.gather_rows, "K5": decode_batch,
            "K6": regex_match, "K7": xxhash64_strings, "K8": find_spans}


def _rank_share(device_events, range_name: str = _RANGE):
    """Device us and kernels of K3 and K4 inside the ``range_name``
    ranges, from ``(start, end, name)`` device events. The profiler
    gives a ``record_function`` range a device-side event of its name
    that spans the kernels launched inside it; the engine launches on
    one stream, in order, so the kernels that run within such a span
    are the range's. ``spans`` counts those events (0: this profiler
    records none, and nothing is attributed)."""
    spans = [(a, b) for a, b, name in device_events if name == range_name]
    out = {"spans": len(spans), "K3_device_us": 0.0,
           "K3_kernel_launches": 0, "K4_device_us": 0.0,
           "K4_kernel_launches": 0}
    for a, b, name in device_events:
        fam = _family(name)
        if fam in ("K3", "K4") and any(sa <= a and b <= sb
                                       for sa, sb in spans):
            out[f"{fam}_device_us"] += b - a
            out[f"{fam}_kernel_launches"] += 1
    return out


def _window_share(device_events, top: int = 10):
    """``_rank_share`` of the window passes' ranges, plus the device us
    of every operation inside them (their union: the window's torch ops,
    its K3 and K4) and, under ``top_ops``, the ``top`` largest of them
    by name (device us and calls)."""
    out = _rank_share(device_events, _WINDOW)
    spans = [(a, b) for a, b, name in device_events if name == _WINDOW]
    inside = [(a, b, name) for a, b, name in device_events
              if name not in (_RANGE, _WINDOW)
              and any(sa <= a and b <= sb for sa, sb in spans)]
    out["device_us"] = _union_us([(a, b) for a, b, _ in inside])
    by_name = {}
    for a, b, name in inside:
        rec = by_name.setdefault(name, {"device_us": 0.0, "calls": 0})
        rec["device_us"] += b - a
        rec["calls"] += 1
    out["top_ops"] = dict(sorted(by_name.items(),
                                 key=lambda kv: -kv[1]["device_us"])[:top])
    return out


def trace_nds(out_dir=None, query: str = "q3", partitions: int = 1,
              n_sales: int = 1 << 22, decimals: bool = False,
              nested: bool = False) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("nds_trace needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..exec.base import ExecCtx
    from ..planner import GpuOverrides
    device = torch.device("cuda", 0)
    paths = decimal_paths(n_sales) if decimals else nested_paths(n_sales) \
        if nested else nds_paths(n_sales)
    s = nds.session_over_files(paths, {
        "spark.sql.shuffle.partitions": str(partitions)}, device)
    if nested:
        node = nds_nested.plan(s, query)._node
    else:
        node = s.sql(nds_decimals.SQL_QUERIES[query] if decimals
                     else _SQL[query])._node
    pp = GpuOverrides(s.conf, device).apply(node)
    pp.collect(ExecCtx(s.conf, device))  # warm-up
    torch.cuda.synchronize()
    wrappers = counters()
    for c in wrappers.values():
        c.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = pp.collect(ExecCtx(s.conf, device))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    intervals, by_name, device_events = [], {}, []
    fams = {f: {"device_us": 0.0, "kernel_launches": 0,
                "wrapper_launches": wrappers[f].launches}
            for f in _FAMILIES}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        a, b = evt.time_range.start, evt.time_range.end
        device_events.append((a, b, evt.name))
        if evt.name in (_RANGE, _WINDOW):
            continue  # a span over kernels, not device work of its own
        intervals.append((a, b))
        rec = by_name.setdefault(evt.name, {"device_us": 0.0, "calls": 0})
        rec["device_us"] += b - a
        rec["calls"] += 1
        fam = _family(evt.name)
        if fam:
            fams[fam]["device_us"] += b - a
            fams[fam]["kernel_launches"] += 1
    busy = _union_us(intervals)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            out_dir, f"nds_{query}_p{partitions}_trace.json"))
    others = sorted(((k, v) for k, v in by_name.items()
                     if _family(k) is None),
                    key=lambda kv: -kv[1]["device_us"])[:12]
    return {"query": query, "partitions": partitions, "n_sales": n_sales,
            "decimals": decimals, "nested": nested,
            "rows": out.num_rows, "device": torch.cuda.get_device_name(0),
            "wall_us": wall_us, "device_busy_us": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_us),
            "kernels": fams,
            "string_ranks": _rank_share(device_events),
            "window": _window_share(device_events),
            "top_other_device_ops": dict(others),
            "top_device_ops": dict(sorted(
                by_name.items(), key=lambda kv: -kv[1]["device_us"])[:12])}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--query", default="q3",
                    choices=sorted(set(_SQL) | set(nds_decimals.QUERIES)
                                   | set(nds_nested.QUERIES)))
    ap.add_argument("--partitions", type=int, default=1)
    ap.add_argument("--n-sales", type=int, default=1 << 22)
    ap.add_argument("--decimals", action="store_true",
                    help="the decimal texts over DECIMAL(7,2) money "
                         "columns")
    ap.add_argument("--nested", action="store_true",
                    help="the nested texts over the ticket table")
    ap.add_argument("--out", default=None,
                    help="directory for the Chrome trace")
    args = ap.parse_args()
    print(json.dumps(trace_nds(args.out, args.query, args.partitions,
                               args.n_sales, args.decimals, args.nested)))


if __name__ == "__main__":
    main()
