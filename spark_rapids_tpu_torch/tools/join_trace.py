"""Where the join + group-by query's time goes on the card: one traced run.

    python3 -m spark_rapids_tpu_torch.tools.join_trace [--out DIR]

Builds the query at the reference's size (``join_groupby.build_plan``:
2^23 lineitem rows in 4 batches, 2^17 orders, seed 1), runs it once to
warm up, then once under ``torch.profiler`` (CPU and CUDA activity).
Prints one JSON line: the wall time, the device's busy time (the union
of the intervals in which a kernel or a copy ran on the device, so
nothing counts twice) and its idle share of the wall time, the device
time of K3 (``radix_histogram``, ``radix_plan``, ``radix_pass``; the
workspace memset of each sort is not counted) and of K4
(``gather_rows_fast``, ``gather_rows_any``) with their kernel launches
(one K3 sort is several),
and the largest other device operations by name. With ``--out`` it
also writes the Chrome trace there. It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .. import join_groupby as jg
from ..exec.base import ExecCtx, collect_arrow

_FAMILIES = {"K3": ("radix_histogram", "radix_plan", "radix_pass"),
             "K4": ("gather_rows_fast", "gather_rows_any")}


def _family(name: str):
    for fam, parts in _FAMILIES.items():
        if any(p in name for p in parts):
            return fam
    return None


def _union_us(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def trace_join(out_dir=None) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("join_trace needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    device = torch.device("cuda", 0)
    plan, _, _ = jg.build_plan(device=device)
    collect_arrow(plan, ExecCtx(device=device))  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        collect_arrow(plan, ExecCtx(device=device))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    intervals, by_name = [], {}
    fams = {f: {"device_us": 0.0, "kernel_launches": 0}
            for f in _FAMILIES}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        a, b = evt.time_range.start, evt.time_range.end
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
        prof.export_chrome_trace(os.path.join(out_dir, "join_trace.json"))
    others = sorted(((k, v) for k, v in by_name.items()
                     if _family(k) is None),
                    key=lambda kv: -kv[1]["device_us"])[:12]
    return {"device": torch.cuda.get_device_name(0), "wall_us": wall_us,
            "device_busy_us": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_us),
            "kernels": fams, "top_other_device_ops": dict(others)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the Chrome trace")
    print(json.dumps(trace_join(ap.parse_args().out)))


if __name__ == "__main__":
    main()
