"""Time NDS texts from SQL on one or more checkouts of the port on the
card, in turns.

    python3 -m spark_rapids_tpu_torch.tools.nds_paired [--trees DIR ...]
        [--queries q3,q_rank,...] [--partitions 1] [--runs 5]
        [--sales N] [--conf KEY=VALUE ...] [--out DIR]

For each tree given (default: this checkout), in the order given, one
process imports that tree's ``spark_rapids_tpu_torch`` (its kernels
built into that tree's ``build/``), reads the NDS tables at ``--sales``
store_sales rows (written once under this checkout's ``.bench_cache/``,
the same files for every tree), and for each text of ``nds.SQL_QUERIES``
named plans it, runs one warm-up and ``--runs`` timed runs of
``PhysicalPlan.collect`` (each ended by ``torch.cuda.synchronize()``),
and holds the first result to ``nds.oracle``'s row count. So ``--trees
parent change change parent``, with the parent unpacked by ``git
archive`` into an ignored directory, times two versions of the engine on
the same files and card. Each tree's line is printed as JSON (text ->
ms of each run, and the median) and all of them are written to
``<out>/nds_paired.json``. It imports neither jax nor the JAX package.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _one(tree: str, queries, parts: int, runs: int, sales: int,
         conf: dict) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.planner import GpuOverrides
    dev = torch.device("cuda", 0)
    tables = nds.gen_tables(sales)
    paths = nds.write_tables(tables, os.path.join(
        _ROOT, ".bench_cache", f"nds_torch_n{sales}"))
    out = {}
    for q in queries:
        settings = dict(conf, **{"spark.sql.shuffle.partitions": str(parts)})
        s = nds.session_over_files(paths, settings, dev)
        pp = GpuOverrides(s.conf, dev).apply(s.sql(nds.SQL_QUERIES[q])._node)
        got = pp.collect()
        if got.num_rows != nds.oracle(q, tables).num_rows:
            raise AssertionError(f"{tree} {q}: {got.num_rows} rows")
        torch.cuda.synchronize()
        ms = []
        for _ in range(runs):
            t = time.perf_counter()
            pp.collect()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        out[q] = {"ms": ms, "median_ms": statistics.median(ms)}
    return {"tree": tree, "module": nds.__file__, "partitions": parts,
            "conf": conf, "queries": out}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--queries", default="q3,q_rank,q_rolling")
    ap.add_argument("--partitions", type=int, default=1)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--sales", type=int, default=1 << 22)
    ap.add_argument("--conf", nargs="*", default=[])
    ap.add_argument("--out", default=None)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    queries = args.queries.split(",")
    conf = dict(kv.split("=", 1) for kv in args.conf)
    if args.one is not None:
        print(json.dumps(_one(args.one, queries, args.partitions, args.runs,
                              args.sales, conf)), flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("nds_paired: no CUDA device")
    results = []
    for tree in args.trees:
        cmd = [sys.executable, os.path.abspath(__file__), "--one", tree,
               "--queries", args.queries, "--partitions",
               str(args.partitions), "--runs", str(args.runs), "--sales",
               str(args.sales), "--conf", *args.conf]
        run = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=1800)
        if run.returncode != 0:
            raise SystemExit(f"nds_paired: tree {tree} failed:\n"
                             f"{run.stdout[-4000:]}\n{run.stderr[-4000:]}")
        results.append(json.loads(run.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "nds_paired.json"), "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
