"""Smoke test of the PyTorch/CUDA port on one GPU: TPC-H q6 at SF1 from
Parquet (host decode, then device page decode), the join + group-by
query at the reference's full size, q6's revenue by line number at
SF1, the 22 NDS queries from SQL text over Parquet files
(``nds.PORTED_QUERIES``), nine more that need outer, cross and
nested-loop joins (``tools/nds_joins.py``) and eight that need the
per-operator CPU fallback (``tools/nds_fallback.py``) and five whose
working set passes the device budget they run under
(``tools/nds_memory.py``), the SQL function texts
(``tools/nds_functions.py``), the decimal texts over TPC-DS's
``DECIMAL(7,2)`` money columns (``tools/nds_decimals.py``) and the
nested texts over a ``ticket`` table of struct, array and map columns
(``tools/nds_nested.py``), through
``spark_rapids_tpu_torch``, with K1 to K6 checked on the card, every
plan checked by the static plan verifier, the per-operator metrics
(EXPLAIN ANALYZE, query profiles) held to the runs, and the telemetry
(span tracer, metrics registry, flight recorder, event log, warehouse,
``torch.profiler`` under ``spark.rapids.profile.path``) held to them.

    python3 chip_smoke.py [--memory-only | --opm-only | --functions-only
                           | --decimals-only | --nested-only
                           | --telemetry-only | --cluster-only
                           | --dataframe-only] [--log FILE]

Phases, any failure exits non-zero before the result line:
  1. the card: name, count, and nvidia-smi's name and power limit;
  2. build every CUDA source under spark_rapids_tpu_torch/csrc/ with nvcc
     (one process per source, in parallel) into build/kernels/;
  3. each kernel against its plain PyTorch version on the card: K1's two
     editions at the q6 batch shape, at a ragged length, with nulls and
     NaN, with columns and masks off alignment, at 0, 1, 3 and 5 rows, at
     a block's and a full grid round's rows +- 1, at 2^23 rows, with int32
     columns in other slots, twice on one input and on two streams at
     once (the same bits), and every op against bounds on and off the
     float32 and int32 grids over columns of each bound's neighbours;
     both editions timed, and the engine edition timed from 0 to 2^23
     rows beside a one-cycle kernel; K3
     (the radix sort) on random keys at the join + group-by path's sort
     shapes (2^17, 2^21, 2^23 pairs), on the path's own key words, on a
     string-rank refinement's words (item.i_category gathered into a
     2^20-row store_sales batch: pass 0's word, pass 1's two), at a
     ragged length, on all-equal, sorted, reverse and duplicated keys,
     keys whose only varying bit is the sign bit or whose only varying
     digit is the top one, 1-bit keys, month words with 90% dead rows
     and negative payloads, exactly against its plain version and
     torch.sort; K4 at the path's gather shapes, at a ragged length,
     with nulls, dead rows, 1- to 8-byte columns mixed and of one width,
     and at the NDS join's shape (item's columns and string starts and
     lengths, 32,768 rows, into a 2^20-row batch), bit for bit, and the
     string gather at that shape against pyarrow's take; each timed with CUDA events beside its bound, its
     plain version and the library call (K3 on random keys and on the
     path's words, K4 at the probe and at the group-by permutation); K5
     (Parquet page decode)
     bit for bit at a q6 row group, with nulls, DELTA and v2 pages, on a
     coalesced batch of differing dictionaries, on alternating values, a
     dictionary of 100,000 entries and 64-bit PLAIN columns, on the NDS
     path's batches (2^20 store_sales rows from two row groups, every
     column; item with its dictionary string column, offsets and chars
     compared), every batch read from a file also against pyarrow, and
     on the hand-made run tables that walk its tiles at their edges
     (kernel_checks.k5_tile_layouts); K2's two editions at a q6 batch
     keyed by line number, at a ragged length, with nulls, NaN and
     out-of-range keys, with every row in one group and with every
     group, with columns, key and masks off alignment, with int64 keys,
     at 1, 3 and 5 rows, twice on one input and on two streams at once
     (the same bits each time); each timed beside its bound and plain
     version; K6 (the regex automaton) bit for bit on q_like's item
     batch (32,768 strings, '%o%s%', also against Python's re), on 2^20
     rows of 20-120 bytes of text with multi-byte characters and
     newlines under a LIKE pattern, an RLIKE alternation and an RLIKE
     whose DFA does not fit (route B), and on the edges (the empty
     string, a null row, rows inside an inherited chars buffer, an empty
     buffer, always- and empty-only patterns), through every route that
     can take each case (the DFA, the position sets), timed beside its
     bound and plain version, each route apart;
  4. q6 SF1 (6,001,215 rows, seed 0, 8 snappy files, row groups of
     1 << 20) written to .bench_cache/lineitem_torch/, run through
     collect_arrow with device page decode off, its revenue held to a
     pyarrow + numpy oracle (rel 1e-9), K1's launches held to the batch
     count, and rows/s as the median of 3 runs after a warm-up;
  5. the join + group-by query (2^23 lineitem rows in 4 batches, 2^17
     orders, seed 1): its 12 monthly revenues held to a numpy oracle
     (rel 1e-9), K3's and K4's launches held to the counts the plan
     implies, and rows/s as the median of 3 runs after a warm-up, with
     each operator's opTime;
  6. q6 SF1 from the same files with device page decode on (the
     reference's default): revenue against the oracle (rel 1e-9), 8 K5
     and 8 K1 launches, the scan's counters (deviceChunks 32,
     fallbackChunks 0, scanPrograms = fusedDispatches = 8), rows/s and
     opTime;
  7. q6 revenue by line number at SF1 (the same rows and seed plus
     l_linenumber, written to .bench_cache/lineitem_grouped_torch/): the
     7 revenues against a numpy oracle (rel 1e-9), 8 K5 and 8 K2
     launches, no K1, the final's one K3 sort and two K4 gathers, the
     scan's counters (deviceChunks 40, fallbackChunks 0), rows/s and
     opTime;
  8. the 22 NDS queries from SQL text (``nds.SQL_QUERIES``: q3, q42,
     q52, q55, q96, q_topn, q7, q_pivot, q_customer_age, q_price_band,
     q_cte, q_having, q_in_between, q_agg_expr, q_not_or, q_rank,
     q_rownum, q_rolling, q_union, q_percentile, q97, q_like)
     over the reference bench's tables at 2^22 store_sales rows (seed 42,
     snappy, row groups of 2^19, written to
     .bench_cache/nds_torch_n4194304/), through GpuSession.sql,
     GpuOverrides and PhysicalPlan.collect with device page decode on: at
     spark.sql.shuffle.partitions 1 a warm-up and 1 timed run each
     (rows/s = store_sales rows over the median wall of collect, and ms a
     query in collect; planning, sql + apply, is timed apart), the
     warm-up and one more run after the first timed one under
     spark.rapids.metrics.op.enabled=false (the per-operator accounting's
     cost, printed in phase 12), then each query once at 16 partitions
     (the Murmur3 exchange and the adaptive reader; no warm-up there).
     Every result is held to the numpy/pyarrow oracle (ints and strings
     exact, floats rel 1e-9, row order exact), every
     scan to deviceChunks = row groups x columns and 0 fallback chunks.
     The first timed run of each query and partition count also counts
     the K3, K4, K5 and K6 launches, held to what the plan implies
     (``_nds_expected``: operator by operator, string ranks included).
     Every run of phases 8-10 is at the default device budget and must
     leave the memory manager's spill bytes, readbacks and OOM retries
     where they were (``_pressure_figures``). Phases 8-11 plan with the
     static plan verifier on (``spark.rapids.sql.verifyPlan``, the
     default): each prints how many plans were verified and refused and
     the median and largest host time of ``verify_plan``, and every text
     of phases 8-10 verifies clean;
  9. NDS joins from SQL: the nine texts of
     ``spark_rapids_tpu_torch/tools/nds_joins.py`` (right and full
     outer joins, cross joins and the nested-loop join over the same
     files), each run as phase 8 runs a query and held to its oracle,
     its scans to their chunks and its launches to ``_nds_expected``
     (at 16 partitions with no warm-up, as phase 8);
     every plan of phases 4-9 has no node on the CPU
     (``fallback_nodes() == []``);
  10. NDS fallback: the eight texts of
     ``spark_rapids_tpu_torch/tools/nds_fallback.py`` (non-equi
     conditions on left outer, semi and anti equi-joins, a RANGE frame
     over the 64-bit date key, a string lag default, a non-ASCII LIKE,
     q3 under variableFloatAgg=false and q3 under
     spark.rapids.sql.enabled=false), each under its conf, over the same
     files at 1 partition (a warm-up and one timed run) and 16 (one
     run): its rows held to its oracle, its ``fallback_nodes()`` to the
     module's ``FALLBACK``, its device scans to their chunks, its K3, K4
     and K5 launches to ``_nds_expected`` (a CPU island launches
     nothing; the device subtrees under it launch as planned), and the
     transitions' downloadTime and uploadTime printed; q_outer_price at
     16 partitions (``SKEW_WITNESS``) must show a skewed partition and a
     skew split: the adaptive reader's skew split on the card;
  11. NDS memory: the five texts of
     ``spark_rapids_tpu_torch/tools/nds_memory.py`` (an out-of-core
     sort with its runs on sealed disk files, a bucketed window, a
     bounded merge of 4M groups, the percentile's CPU reroute, q3's
     spilled map entries) under a 64 MiB device budget at 1 and 16
     partitions (q3 at 16), each beside the same text at the default
     budget (which must spill nothing), each planned first with the
     verifier on under the cut budget, its verdict printed with its
     reasons, its estimate and the budget: a refusal must be
     ``hbm_over_budget`` on a node whose ``resident_footprint()`` holds
     (q_percentile's exact single pass), and a refused text then runs
     with spark.rapids.sql.verifyPlan=false, as the reference's would:
     rows held to the oracle, each
     path's own figure above 0, no catalog entry or ledger byte left,
     the device storages every spill released as a share of the bytes
     the ledger credited printed by the site that registered
     the entry, and held to that site's ``SPILL_FREED_SHARES``, K3/K4/K5
     launches printed; the CRC32C in use and the port's own timed on 64 MiB; a
     real torch.OutOfMemoryError (the memory fraction cut at q_pivot's
     largest retry scope) answered by split-and-retry with the
     unconstrained run's rows; the degradation ladder (q3 under
     injectRetryOOM.storm: halve, spill, width1, the CPU rerun); a
     deadline that cancels q97 mid-run and leaves no catalog entry,
     ledger byte or spill file, and memory_allocated() within
     CANCEL_MARGIN_BYTES of its value before (``--memory-only`` runs
     the build and this phase alone);
  12. per-operator metrics at full width: q3, q97, q_rank,
     q_full_halves and q_outer_price at 1 and 16 partitions, each run
     once through collect and EXPLAIN ANALYZE (``explain_analyze``) with
     spark.rapids.history.dir set to a temporary directory and under
     torch.cuda.set_sync_debug_mode("warn"), then once with
     spark.rapids.metrics.op.enabled=false under the same mode: the
     rows against the oracle, the root's rows the result's, every scan's
     rows its file's times the paths that reach it, one op id a node,
     cpuFallback on every node of a CPU island and on no device node,
     every device stage's opTime stamped by a CUDA event (no wall-clock
     or wedged stamp), the fused stages' opTime at least their
     dispatchTime, one profile a run whose device_kind is the card's
     name, and as many synchronizing calls with the op metrics off as
     on; the top three operators by opTime printed, and phase 8's ms a
     query with the op metrics on and off (``--opm-only`` runs the build
     and this phase alone, without phase 8's figures);
  13. SQL functions: the ten texts of
     ``spark_rapids_tpu_torch/tools/nds_functions.py`` (the variances
     and deviations, string MIN/MAX, FIRST/LAST, grouped and over a
     window frame, and the math, string, date and cast functions of the
     SQL registry) over the same files at 1 partition (a warm-up and a
     timed run through ``_counted_runs``) and 16 (one run; the phase
     stays within 90 s): each result
     held to the module's oracle (``check``: ints, strings and dates
     exact, floats rel 1e-9, FIRST/LAST after a join to a value of their
     group), its ``fallback_nodes()`` to the module's ``FALLBACK`` (no
     expression the reference places on the device runs on the CPU), its
     ms a query and its K3, K4, K5 and K6 launches printed with the
     card's name and power limit; q_fn_strings and q_fn_casts are
     traced once each (``tools/nds_trace.py``) after phase 15, each in
     a process of its own (``_traced_apart``): device busy time, idle share and the top five device operations
     (``--functions-only`` runs the build and this phase alone);
  14. decimals: the ten texts of
     ``spark_rapids_tpu_torch/tools/nds_decimals.py`` (q3, q42, q52,
     q55 and q7 as they stand, decimal keys, arithmetic, casts, a window
     frame's sum, and three sums past 18 digits that run on the CPU)
     over the NDS tables at 2^22 store_sales rows with the four money
     columns as ``DECIMAL(7,2)``, written as Spark writes decimals
     (INT32; ``.bench_cache/nds_decimal_torch_n4194304/``), at 1
     partition (a warm-up and one timed run, no warm-up for a text with
     a CPU island) and 16 (one run), each as
     phase 8 runs a query (``_run_sql_queries``): rows equal to the
     module's oracle exactly (floats rel 1e-9), ``fallback_nodes()`` to
     its ``FALLBACK``, the device scans to their chunks, every plan
     verified, and the K3, K4 and K5 launches to ``_nds_expected`` (a
     decimal key is one 64-bit value lane); one text
     (``DECIMALS_TRACED``) is traced after phase 13's traces, in a
     process of its own: device busy time, idle share and the top five device operations
     (``--decimals-only`` runs the build and this phase alone); phase 3
     checks K5 on an INT32 ``DECIMAL(7,2)``
     and an INT64 ``DECIMAL(12,2)`` row group pair with nulls
     (``kernel_checks.decimal_layouts``, against the plain version and
     pyarrow), K3 on a decimal key's words with negatives and nulls
     (``decimal_words``) and K4 gathering a decimal column
     (``decimal_gather_case``);
  16. nested types: the eight texts of
     ``spark_rapids_tpu_torch/tools/nds_nested.py`` (an explode of
     ``array<struct>`` joined and summed, a filter on a struct field and
     a limit that compacts nested batches, array items, a named struct
     and a map's keys and values downloaded, ``posexplode_outer`` of a
     map, ``collect_list``/``collect_set`` from SQL, a list of
     percentiles, a group-by and a sort by a struct on the CPU, and every
     ticket column downloaded) over the ``ticket`` table made from the
     NDS tables at 2^22 store_sales rows (about 490,000 tickets, row
     groups of 2^16, ``.bench_cache/nds_nested_torch_n4194304/``), each
     as phase 14 runs a text: rows equal to the oracle (floats rel
     1e-9), ``fallback_nodes()`` to ``FALLBACK``, every plan verified,
     the device scans to their chunks (a nested column a host chunk of
     reason ``nested`` a row group, the flat ones on K5) and the K3, K4
     and K5 launches to ``_nds_expected`` (an explode's two gathers, a
     limit's compaction, a collect's sorts and gather, and one more K4 a
     list level a nested gather moves); ``NESTED_TRACED`` is traced in a
     process of its own after phase 14's trace (``--nested-only`` runs
     the build and this phase alone); phase 3 checks K4 on the ticket
     batch's compaction lanes and the lines' elements by element index
     (``nested_k4_cases``), ``gather_columns`` on a struct, an
     ``array<struct>``, a map, ``array<int64>``, ``array<string>`` and
     ``array<array<int32>>`` of the tickets and the batch's compaction
     against the same calls on CPU tensors, bit for bit
     (``check_nested_gather``), and K3 on the compaction's words
     (``nested_words``);
  17. telemetry: q3, q_rank, q97 and q_like_intl (a CPU island) twice at
     1 partition and once at 16, with the warehouse, the event log and
     the span tracer on: rows equal to the oracle, one warehouse row a
     collect (``device_kind`` the card's name, ``completed``, or
     ``degraded`` for the island, as the reference classifies it; its
     per-operator rows the folded op metrics), one trace with one
     ``query`` span whose ``op`` spans ran every operator id, one
     event-log line, and ``drift_report`` over the runs clean;
     ``tools/nds_memory.py``'s q_sales_sorted under 64 MiB with its
     first two disk writes refused (``injectDiskFull=2``) and q3
     under ``injectRetryOOM=3``: the registry's spill, disk-spill,
     read-back and OOM-retry deltas equal the manager's attributes, the
     event log holds the query lines and the refused write's
     ``disk_pressure`` line, the flight ring's memory timeline is not
     empty and ends at 0 ledger bytes (its high water printed beside the
     budget: the scan's pinned in-flight blobs pass it); q97 cancelled by a
     0.4 s deadline (a ``cancelled`` row, the counter moved by one, the
     flight events and the event-log line) and a plan the verifier
     refuses (its ``plan_rejected`` flight event and line); five
     interleaved off/on pairs of q6 and q3 at 1 partition, each side's
     median and spread and the overhead, not gated, and its bound: one
     more run of each with every flight-ring append, span, gauge sync
     and registry update counted, times each call's host microseconds
     (``_telemetry_unit_costs``), plus the query's timed writes (the
     warehouse row, the Chrome trace, the event-log line), over the on
     side's median. After phase 16's
     trace, q6 SF1 with device decode and every sink on and
     ``spark.rapids.profile.path`` set, in a process of its own
     (``tools/telemetry_q6.py``): its revenue phase 6's, one ``query``
     span and every operator id traced, the profiler trace naming as
     many K5 and K1 kernels as the process's wrappers launched and phase
     6 counts (8 each), 32 device chunks in the registry's delta and the
     folded metrics (``--telemetry-only`` runs the build and this phase
     alone, q6 held to the oracle only);
  19. the DataFrame API's rest (``tools/nds_dataframe.py``) over the
     phase 8 files at 1 and 16 partitions, one timed run each: ROLLUP
     through Expand (3 x 2^22 rows), ``sample(0.1, seed=7)``, a pivot
     with inferred values, ``hash``/``xxhash64`` of four columns of the
     store_sales x item join (every row compared), three
     ``regexp_replace``/``regexp_extract`` columns, and four write/read
     round trips (store_sales to Parquet partitioned by ``ss_store_sk``,
     read back with its Hive column; a quarter of the join to ORC, CSV
     and Hive text): each result held to its numpy, pyarrow or ``re``
     oracle, every plan verified, the device scans to their chunks and
     the K3, K4, K5, K7 and K8 launches to ``_nds_expected`` (one K7 a
     string column an ``XxHash64`` hashes a batch, one K8 a regex
     expression a batch), each text's ms and the phase's seconds
     printed (``--dataframe-only`` runs the build and this phase
     alone); phase 3 checks K7 (``xxhash64.cu``) over 2^20 strings of
     0-100 bytes after an int, a long, a double and a ``decimal(12,2)``
     column, with nulls, and its edges, bit for bit against its plain
     version and on 2^16 rows against the numpy host copy, and K8
     (``regex_spans.cu``) over 2^20 text rows under a class run, a
     bounded repeat, 60 positions and an end anchor, and its edges (a
     row starting at the buffer's end), with ``first_only`` off and on,
     every output bit for bit; each timed beside its bound and plain
     version;
  15. K1's kernels a call, counted in a profiler trace of one call (1)
     between pad kernels. Every trace runs after the timed phases, in a
     process of its own, so that it is the first trace of its process
     (``_traced_apart``: within one process a trace after a long one
     lost device records, after three every record of K1 and its pads)
     and leaves no profiler hooks in the process that times.
The last lines are the kernels' JSON, nvidia-smi's line, and
{"ok": true, "device": {...}}; with ``--log FILE`` every line is also
written to FILE. The script imports neither jax nor the JAX package.
"""
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
ENGINE_RTOL = 1e-9
#: K5's and K1's launches in one q6 SF1 query with device decode: one of
#: each a batch (phases 6 and 17)
Q6_DD_LAUNCHES = {"decode_batch": 8, "filter_product_sum": 8}
#: the device chunks of one q6 SF1 query's scan with device decode
Q6_DD_CHUNKS = 32
# the TPU kernel K1 replaces, as file:line
K1_REPLACES = "spark_rapids_tpu/ops/pallas_kernels.py:58"
K1_SOURCE = "spark_rapids_tpu_torch/csrc/masked_product_sum.cu"
K3_REPLACES = "spark_rapids_tpu/ops/pallas_kernels.py:156"
K3_SOURCE = "spark_rapids_tpu_torch/csrc/radix_sort.cu"
K4_REPLACES = "spark_rapids_tpu/ops/pallas_kernels.py:259"
K4_SOURCE = "spark_rapids_tpu_torch/csrc/gather.cu"
K2_REPLACES = "spark_rapids_tpu/ops/pallas_kernels.py:225"
K2_SOURCE = "spark_rapids_tpu_torch/csrc/fused_filter_agg.cu"
K5_REPLACES = "spark_rapids_tpu/io/parquet_device.py:1015"
K5_SOURCE = "spark_rapids_tpu_torch/csrc/parquet_decode.cu"
K6_REPLACES = "spark_rapids_tpu/ops/regex.py:378"
K6_SOURCE = "spark_rapids_tpu_torch/csrc/regex_match.cu"
K7_REPLACES = "spark_rapids_tpu/ops/hash.py:363"
K7_SOURCE = "spark_rapids_tpu_torch/csrc/xxhash64.cu"
K8_REPLACES = "spark_rapids_tpu/ops/regex.py:475"
K8_SOURCE = "spark_rapids_tpu_torch/csrc/regex_spans.cu"
K8_MAIN_ROWS_LOG2 = 20  # phase 3's K8 text rows, kernel_checks.K8_TEXT_ROWS
# phase 16's traced text, and phase 3's nested shapes in the kernels' JSON
NESTED_TRACED = "q_nest_explode"
NESTED_K3_SHAPE = "nested_ticket_compaction_2^16"
NESTED_K4_SHAPE = "nested_lines_elements_2^19"


#: with ``--log FILE``, every line the smoke prints is also written there
_log_file = None


def log(*a):
    print(*a, flush=True)
    if _log_file is not None:
        print(*a, file=_log_file, flush=True)


def _args():
    """``(memory_only, opm_only, functions_only, decimals_only,
    nested_only, telemetry_only, cluster_only, dataframe_only, log path
    or None)`` from the command line."""
    args = sys.argv[1:]
    path = None
    if "--log" in args:
        path = args[args.index("--log") + 1]
    return ("--memory-only" in args, "--opm-only" in args,
            "--functions-only" in args, "--decimals-only" in args,
            "--nested-only" in args, "--telemetry-only" in args,
            "--cluster-only" in args, "--dataframe-only" in args, path)


def phase_card():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke test runs "
                         "only on the GPU")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[card] {name} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; nvidia-smi: {smi}")
    return name, count, smi


def phase_build():
    from spark_rapids_tpu_torch.ops._build import build_all
    t0 = time.perf_counter()
    logs = build_all()
    secs = time.perf_counter() - t0
    for name, out in logs.items():
        ptxas = [ln.strip() for ln in out.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[build] {name}.cu: " + (" | ".join(ptxas) or "built"))
    log(f"[build] {len(logs)} source(s) compiled in {secs:.3f} s")


def phase_kernels(device):
    from spark_rapids_tpu_torch.ops import kernel_checks as kc
    recs = kc.check_k1(device)
    for rec in recs:
        log(f"[k1] {rec['edition']:8s} {rec['case']:18s} "
            f"rows={rec['rows']} sum={rec['sum']!r} "
            f"plain={rec['plain_sum']!r} rel_err={rec['rel_err']:.3e} "
            f"count={rec['count']} plain_count={rec['plain_count']}")
    times = kc.time_k1(device)
    log(f"[k1] geometry {kc.k1_geometry(device)}")
    sweep = kc.time_k1_sweep(device)
    log(f"[k1] engine edition by live rows (ms): {sweep['ms_by_rows']}; "
        f"a one-cycle kernel: {sweep['empty_launch_ms']:.6f} ms")
    case = kc.k1_base_cases(device)[0]
    ops = case.row_count * (len(case.spec.leaves) + 2)
    for edition, t in times.items():
        t["bound_ms"], t["bound_by"] = _bound(t["bytes"], ops)
        t["max_abs_err"] = max(abs(r["sum"] - r["plain_sum"])
                               for r in recs if r["edition"] == edition)
        t.update(sweep)
        log(f"[k1] {edition} edition at {case.row_count} live rows of "
            f"{kc.MAIN_CAPACITY}: kernel {t['ms']:.6f} ms, "
            f"plain {t['plain_ms']:.6f} ms, bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']}, {t['bytes']} B; "
            f"{100 * t['bound_ms'] / t['ms']:.1f}% of it)")
    return times


def _traced_apart(args, timeout=300):
    """The JSON line a trace prints, run in a process of its own
    (``python3 args...`` from the repo's root; the kernels are already
    built): each trace is then the first in its process, whatever ran
    before it. Within one process a trace after a long one lost device
    records, and every trace leaves the profiler's hooks behind, which
    slow every later launch."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    run = subprocess.run([sys.executable] + list(args), cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    if run.returncode != 0:
        raise AssertionError(f"trace {args} exited {run.returncode}: "
                             f"{run.stderr[-3000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def _trace_query(query, decimals=False):
    """``tools/nds_trace`` of ``query`` at 1 partition, in a process of
    its own (``_traced_apart``)."""
    return _traced_apart(
        ["-m", "spark_rapids_tpu_torch.tools.nds_trace", "--query", query,
         "--partitions", "1", "--n-sales", str(NDS_SALES)]
        + (["--decimals"] if decimals else []))


def phase_k1_kernels_per_call():
    """K1's kernels a call, from a profiler trace of one call, in a
    process of its own (``_traced_apart``)."""
    trace = _traced_apart(
        ["-c", "import json, torch; from spark_rapids_tpu_torch.ops "
         "import kernel_checks as kc; print(json.dumps(kc.k1_trace("
         "torch.device('cuda', 0))))"])
    per_call = trace["k1"]
    log(f"[k1] kernels a call (profiler, main batch): {per_call}; the "
        f"trace kept {trace['pads']} of its 3 pad kernels")
    if per_call != 1:
        raise AssertionError(f"K1 launches {per_call} kernels a call, not 1")
    return per_call


def phase_decode_group(device):
    """K5 and K2 against their plain versions, then timed."""
    from spark_rapids_tpu_torch.ops import kernel_checks as kc
    k5_recs, k2_recs = kc.check_k5(device), kc.check_k2(device)
    for rec in k5_recs:
        log(f"[k5] {rec}")
    for rec in k2_recs:
        log(f"[k2] {rec}")
    k5 = kc.time_k5(device)
    # bytes: the encoded parts in, every column out up to the capacity;
    # operations: some 20 a live value (a funnel shift, a mask, a
    # dictionary read, the conversion)
    k5["bound_ms"], k5["bound_by"] = _bound(
        k5["bytes"], k5["rows"] * k5["columns"] * 20)
    k5["max_abs_err"] = max(r["max_abs_err"] for r in k5_recs)
    log(f"[k5] decode_batch at a q6 batch ({k5['rows']} rows of "
        f"{k5['capacity']} x {k5['columns']} columns): kernel "
        f"{k5['ms']:.6f} ms, plain {k5['plain_ms']:.6f} ms, bound "
        f"{k5['bound_ms']:.6f} ms ({k5['bound_by']}, {k5['encoded_bytes']} "
        f"B encoded in + {k5['written_bytes']} B written out to the "
        f"capacity)")
    k2 = kc.time_k2(device)
    k2["bound_ms"], k2["bound_by"] = _bound(k2["bytes"], k2["ops"])
    k2["max_abs_err"] = max(r["max_abs_err"] for r in k2_recs
                            if r["edition"] == "engine")
    k2["contract_max_rel_err"] = max(r["rel_err"] for r in k2_recs
                                     if r["edition"] == "contract")
    log(f"[k2] filter_product_group_sum at a q6 batch ({k2['rows']} rows, "
        f"7 groups): kernel {k2['ms']:.6f} ms, plain {k2['plain_ms']:.6f} "
        f"ms, bound {k2['bound_ms']:.6f} ms ({k2['bound_by']}, "
        f"{k2['bytes']} B)")
    return k5, k2


def phase_regex(device):
    """K6 against its plain version, then timed."""
    from spark_rapids_tpu_torch.ops import kernel_checks as kc
    cases = kc.k6_cases(device)
    recs = kc.check_k6(device, cases + kc.k6_literal_cases(device))
    for rec in recs:
        log(f"[k6] {rec}")
    k6 = kc.time_k6(device, cases)
    for name, t in k6.items():
        # operations: at least three a byte read (the class lookup's
        # AND, the accept test, a follow step); the bytes bound it
        t["bound_ms"], t["bound_by"] = _bound(t["bytes"],
                                              3 * t["chars_read"])
        log(f"[k6] regex_match on {name} ({t['rows']} rows, "
            f"{t['positions']} positions, {t['pattern']!r}): route "
            f"{t['route']} (DFA states {t['dfa_states']}), kernel "
            f"{t['ms']:.6f} ms, plain {t['plain_ms']:.6f} ms, bound "
            f"{t['bound_ms']:.6f} ms ({t['bound_by']}, {t['bytes']} B); "
            f"by route {t['ms_by_route']}")
    return k6, max(r["max_abs_err"] for r in recs)


def phase_hash_spans(device):
    """K7 and K8 against their plain versions, then timed."""
    from spark_rapids_tpu_torch.ops import kernel_checks as kc
    k7_cases = kc.k7_cases(device)
    k7_recs = kc.check_k7(device, k7_cases)
    for rec in k7_recs:
        log(f"[k7] {rec}")
    k7 = kc.time_k7(device, k7_cases[0])
    # operations: some 10 integer steps an 8-byte word (multiplies,
    # rotates, adds, xors) and 30 a row (the merge, tails and avalanche),
    # counted at the float32 rate; the bytes bound it
    chars = k7["bytes"] - 4 * (k7["rows"] + 1) - 17 * k7["rows"]
    k7["bound_ms"], k7["bound_by"] = _bound(
        k7["bytes"], 10 * chars // 8 + 30 * k7["rows"])
    k7["max_abs_err"] = max(r["max_abs_err"] for r in k7_recs)
    log(f"[k7] xxhash64_strings on {k7['case']} ({k7['rows']} rows): "
        f"kernel {k7['ms']:.6f} ms, plain {k7['plain_ms']:.6f} ms, bound "
        f"{k7['bound_ms']:.6f} ms ({k7['bound_by']}, {k7['bytes']} B)")
    k8_cases = kc.k8_cases(device)
    recs = kc.check_k8(device, k8_cases)
    for rec in recs:
        log(f"[k8] {rec}")
    k8 = kc.time_k8(device, k8_cases)
    for name, t in k8.items():
        # operations: at least three a byte (the class lookup's AND, the
        # accept test, a follow step); the bytes bound it
        t["bound_ms"], t["bound_by"] = _bound(t["bytes"], 3 * t["bytes"])
        log(f"[k8] find_spans on {name} ({t['rows']} rows, "
            f"{t['positions']} positions, {t['pattern'][:40]!r}): kernel "
            f"{t['ms']:.6f} ms, plain {t['plain_ms']:.6f} ms, bound "
            f"{t['bound_ms']:.6f} ms ({t['bound_by']}, {t['bytes']} B)")
    return k7, k8, max(r["max_abs_err"] for r in recs)


def _bound(nbytes, ops):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def phase_sort_gather(device):
    """K3 and K4 against their plain versions, then timed."""
    from spark_rapids_tpu_torch.ops import kernel_checks as kc
    k3_recs, k4_recs = kc.check_k3(device), kc.check_k4(device)
    k4_recs.append(kc.check_string_gather(device))
    k4_recs.extend(kc.check_nested_gather(device))
    for rec in k3_recs:
        log(f"[k3] {rec}")
    for rec in k4_recs:
        log(f"[k4] {rec}")
    k3 = kc.time_k3(device)
    for name, t in k3.items():
        # each key is read and each pair written once; the eight digit
        # extractions a key count at the card's scalar rate
        t["bound_ms"], t["bound_by"] = _bound(t["bytes"], t["ops"])
        log(f"[k3] sort_pairs on {name} ({t['n']} pairs, {t['passes']} "
            f"digit passes): kernel {t['ms']:.6f} ms, plain "
            f"{t['plain_ms']:.6f} ms, torch.sort {t['library_ms']:.6f} ms, "
            f"bound {t['bound_ms']:.6f} ms ({t['bound_by']}, "
            f"{t['bytes']} B)")
    k4 = kc.time_k4(device)
    for name, t in k4.items():
        t["bound_ms"], t["bound_by"] = _bound(t["bytes"], 0)
        log(f"[k4] gather_rows at {name} ({t['rows']} rows, "
            f"{t['live_rows']} live, reading {t['source_rows_read']} of "
            f"{t['table_rows']}): kernel {t['ms']:.6f} ms, plain "
            f"{t['plain_ms']:.6f} ms, index_select {t['library_ms']:.6f} "
            f"ms, bound {t['bound_ms']:.6f} ms ({t['bound_by']}, "
            f"{t['bytes']} B)")
    errs = (max(r["max_abs_err"] for r in k3_recs),
            max(r["max_abs_err"] for r in k4_recs))
    return k3, k4, errs


def phase_slice(device):
    import numpy as np
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.exec.base import ExecCtx
    from spark_rapids_tpu_torch.io.scan import GpuFileScanExec
    import pyarrow.parquet as pq

    t0 = time.perf_counter()
    paths = tpch.write_lineitem(
        tpch.gen_lineitem(tpch.SF1_ROWS, seed=0),
        os.path.join(ROOT, ".bench_cache", "lineitem_torch"), seed=0)
    log(f"[slice] {len(paths)} files ready in "
        f"{time.perf_counter() - t0:.3f} s")
    want, want_rows = tpch.host_q6(paths)
    conf = RapidsConf(
        {"spark.rapids.sql.format.parquet.deviceDecode.enabled": "false"})
    batch_rows = conf.batch_size_rows
    batches = sum(-(-pq.ParquetFile(p).metadata.num_rows // batch_rows)
                  for p in paths)
    plan = tpch.build_q6(GpuFileScanExec(paths,
                                         schema=tpch.LINEITEM_SCHEMA))
    out, times, ctx, launches = _counted_runs(
        plan, lambda: ExecCtx(conf, device), _counters())
    got = out.column("revenue")[0].as_py()
    rel = abs(got - want) / max(1.0, abs(want))
    log(f"[slice] revenue {got!r} oracle {want!r} rel_err {rel:.3e} "
        f"({want_rows} rows)")
    if out.num_rows != 1 or got is None or not np.isfinite(got) \
            or not rel <= ENGINE_RTOL:
        raise AssertionError(f"q6 revenue {got!r} vs oracle {want!r}")
    expected = {name: 0 for name in launches}
    expected.update(filter_product_sum=batches)
    if launches != expected:
        raise AssertionError(f"launches {launches} for {batches} batches")
    metrics = _metrics(ctx)
    dispatches = [m["kernelDispatches"] for m in metrics.values()
                  if "kernelDispatches" in m]
    if dispatches != [batches]:
        raise AssertionError(f"kernelDispatches {dispatches} for "
                             f"{batches} batches")
    med = statistics.median(times)
    log(f"[slice] q6 SF1 from parquet: {tpch.SF1_ROWS / med:.1f} rows/s "
        f"(median of {[round(t, 6) for t in times]} s); {batches} batches,"
        f" {launches['filter_product_sum']} K1 launches")
    log("[slice] metrics " + json.dumps(metrics, sort_keys=True))
    return launches, paths


def phase_join(device):
    import numpy as np
    from spark_rapids_tpu_torch import join_groupby as jg
    from spark_rapids_tpu_torch.exec.base import ExecCtx

    t0 = time.perf_counter()
    plan, li, orders = jg.build_plan(device=device)
    want = jg.host_oracle(li, orders)
    torch.cuda.synchronize()
    log(f"[join] {jg.N_LI} lineitem rows in batches of {jg.BATCH_ROWS}, "
        f"{jg.N_ORD} orders: data on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    n_batches = -(-jg.N_LI // jg.BATCH_ROWS)
    # K3: the build key's presort, one sort a partial aggregate, one for
    # the final (each key set is one word: live + null + 32 bits)
    want_k3 = 1 + n_batches + 1
    # K4: the build's sorted-key gather; per stream batch the probe's
    # gather of the build columns, the partial's permutation of keys and
    # values, and its gather of each segment's first key; the final's
    # permutation and its segment starts
    want_k4 = 1 + 3 * n_batches + 2
    out, times, ctx, launches = _counted_runs(
        plan, lambda: ExecCtx(device=device), _counters())
    months = out.column("o_month").to_pylist()
    got = out.column("revenue").to_pylist()
    rels = [abs(g - want[m]) / abs(want[m]) for m, g in zip(months, got)]
    for m, g, r in zip(months, got, rels):
        log(f"[join] month {m:2d} revenue {g!r} oracle {want[m]!r} "
            f"rel_err {r:.3e}")
    if months != list(range(1, 13)) or not all(
            np.isfinite(g) for g in got) or not max(rels) <= ENGINE_RTOL:
        raise AssertionError(f"join + group-by: months {months}, rel "
                             f"errors {rels}")
    log(f"[join] launches in one query: {launches}; expected "
        f"sort_pairs {want_k3}, gather_rows {want_k4}")
    expected = {name: 0 for name in launches}
    expected.update(sort_pairs=want_k3, gather_rows=want_k4)
    if launches != expected:
        raise AssertionError(f"launches {launches}")
    med = statistics.median(times)
    log(f"[join] join + group-by: {jg.N_LI / med:.1f} rows/s (median of "
        f"{[round(t, 6) for t in times]} s)")
    log("[join] metrics " + json.dumps(_metrics(ctx), sort_keys=True))
    return launches


def _counted_runs(plan, make_ctx, counters, placed=None, warm=True,
                  timed=3):
    """A warm-up (``warm``), then ``timed`` timed runs of ``plan``; the
    kernels' launch counts are read over the first timed run only.
    Returns ``(result, seconds of each run, ctx of the first,
    launches)``. Without ``placed`` the planner, under the run's conf,
    places no node of ``plan`` (an operator tree) on the CPU, and the
    tree runs as it is; with it, ``plan`` is a planned
    ``PhysicalPlan`` whose ``fallback_nodes()`` must be ``placed``, and
    it runs through its ``collect``."""
    from spark_rapids_tpu_torch.exec.base import collect_arrow
    from spark_rapids_tpu_torch.planner import GpuOverrides
    if placed is None:
        ctx0 = make_ctx()
        on_cpu = GpuOverrides(ctx0.conf, ctx0.device).apply(plan) \
            .fallback_nodes()
        if on_cpu:
            raise AssertionError(f"nodes on the CPU: {on_cpu}")
    elif plan.fallback_nodes() != list(placed):
        raise AssertionError(f"nodes on the CPU: {plan.fallback_nodes()}, "
                             f"expected {list(placed)}")

    def run():
        ctx = make_ctx()
        t = time.perf_counter()
        out = collect_arrow(plan, ctx) if placed is None \
            else plan.collect(ctx)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, ctx

    if warm:
        run()
    for c in counters:
        c.launches = 0
    out, secs, ctx = run()
    launches = {c.__name__: c.launches for c in counters}
    times = [secs] + [run()[1] for _ in range(timed - 1)]
    return out, times, ctx, launches


def _counters():
    from spark_rapids_tpu_torch.ops import cuda_kernels as ck
    from spark_rapids_tpu_torch.ops.parquet_decode import decode_batch
    return (decode_batch, ck.filter_product_sum, ck.masked_product_sum,
            ck.filter_product_group_sum, ck.fused_filter_agg, ck.sort_pairs,
            ck.sort_keys, ck.gather_rows, ck.gather)


def _metrics(ctx):
    return {label: {k: m.value for k, m in ms.items()}
            for label, ms in ctx.metrics.items()}


def _check_scan(metrics, want):
    """The scan's counters against ``want`` (name -> value)."""
    scans = [m for label, m in metrics.items()
             if label.startswith("FileScanExec")]
    got = {k: scans[0].get(k) for k in want} if len(scans) == 1 else None
    if got != want:
        raise AssertionError(f"scan counters {got}, expected {want}")


def phase_q6_device_decode(device, paths):
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.exec.base import ExecCtx
    from spark_rapids_tpu_torch.io.scan import GpuFileScanExec
    import numpy as np

    want, want_rows = tpch.host_q6(paths)
    conf = RapidsConf()  # device page decode on, as the reference
    plan = tpch.build_q6(GpuFileScanExec(paths,
                                         schema=tpch.LINEITEM_SCHEMA))
    out, times, ctx, launches = _counted_runs(
        plan, lambda: ExecCtx(conf, device), _counters())
    got = out.column("revenue")[0].as_py()
    rel = abs(got - want) / max(1.0, abs(want))
    log(f"[q6dd] revenue {got!r} oracle {want!r} rel_err {rel:.3e} "
        f"({want_rows} rows)")
    if out.num_rows != 1 or got is None or not np.isfinite(got) \
            or not rel <= ENGINE_RTOL:
        raise AssertionError(f"q6 (device decode) revenue {got!r} vs "
                             f"oracle {want!r}")
    metrics = _metrics(ctx)
    _check_scan(metrics, {"deviceChunks": 32, "fallbackChunks": 0,
                          "scanPrograms": 8, "fusedDispatches": 8})
    expected = {name: 0 for name in launches}
    expected.update(Q6_DD_LAUNCHES)
    log(f"[q6dd] launches in one query: {launches}")
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    med = statistics.median(times)
    log(f"[q6dd] q6 SF1 from parquet, device page decode: "
        f"{tpch.SF1_ROWS / med:.1f} rows/s (median of "
        f"{[round(t, 6) for t in times]} s)")
    log("[q6dd] metrics " + json.dumps(metrics, sort_keys=True))
    return launches, got


def phase_q6_by_linenumber(device):
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.exec.base import ExecCtx
    from spark_rapids_tpu_torch.io.scan import GpuFileScanExec
    import numpy as np

    t0 = time.perf_counter()
    paths = tpch.write_lineitem(
        tpch.gen_lineitem(tpch.SF1_ROWS, seed=0, linenumber=True),
        os.path.join(ROOT, ".bench_cache", "lineitem_grouped_torch"),
        seed=0)
    log(f"[q6ln] {len(paths)} files ready in "
        f"{time.perf_counter() - t0:.3f} s")
    want = tpch.host_q6_by_linenumber(paths)
    plan = tpch.build_q6_by_linenumber(GpuFileScanExec(
        paths, schema=tpch.LINEITEM_GROUPED_SCHEMA))
    conf = RapidsConf()
    out, times, ctx, launches = _counted_runs(
        plan, lambda: ExecCtx(conf, device), _counters())
    keys = out.column("l_linenumber").to_pylist()
    got = out.column("revenue").to_pylist()
    rels = [abs(g - want[k]) / abs(want[k]) for k, g in zip(keys, got)]
    for k, g, r in zip(keys, got, rels):
        log(f"[q6ln] l_linenumber {k} revenue {g!r} oracle {want[k]!r} "
            f"rel_err {r:.3e}")
    if keys != list(range(1, 8)) or sorted(want) != keys or not all(
            np.isfinite(g) for g in got) or not max(rels) <= ENGINE_RTOL:
        raise AssertionError(f"q6 by line number: keys {keys}, rel errors "
                             f"{rels}")
    # K5 and K2 once a batch; the final sorts the 8 partials' 64 slots
    # by the one int32 key (one K3 pass) and gathers twice with K4 (the
    # permutation, then each group's first key)
    metrics = _metrics(ctx)
    _check_scan(metrics, {"deviceChunks": 40, "fallbackChunks": 0,
                          "scanPrograms": 8, "fusedDispatches": 8})
    expected = {name: 0 for name in launches}
    expected.update(decode_batch=8, filter_product_group_sum=8,
                    sort_pairs=1, gather_rows=2)
    log(f"[q6ln] launches in one query: {launches}")
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    med = statistics.median(times)
    log(f"[q6ln] q6 by line number SF1 from parquet: "
        f"{tpch.SF1_ROWS / med:.1f} rows/s (median of "
        f"{[round(t, 6) for t in times]} s)")
    log("[q6ln] metrics " + json.dumps(metrics, sort_keys=True))
    return launches


NDS_SALES = 1 << 22
# rows of a string-keyed sort, as far as the rank words depend on them
# (ops/sort_keys.rank_pass_words: only whether there are more than one);
# every such sort of the corpus ranks a batch or several groups' partials
NDS_RANKED_ROWS = 2


def _lane_bits(t):
    """Bits of a sort key's value lane (ops/sort_keys.py): a string
    key's is its 32-bit rank, a Decimal64's its 64-bit unscaled lane."""
    import numpy as np
    from spark_rapids_tpu_torch import datatypes as dt
    if isinstance(t, (dt.StringType, dt.BinaryType)):
        return 32
    if isinstance(t, dt.BooleanType):
        return 1
    return 8 * np.dtype(t.np_dtype).itemsize


def _list_launches(t):
    """K4 launches a gather of one column of type ``t`` adds past the
    row launch (ops/gather._gather_elements): one an array or map level,
    its elements' own levels after."""
    from spark_rapids_tpu_torch import datatypes as dt
    if isinstance(t, dt.ArrayType):
        return 1 + _list_launches(t.element_type)
    if isinstance(t, dt.MapType):
        return 1 + _list_launches(t.key_type) + _list_launches(t.value_type)
    if isinstance(t, dt.StructType):
        return sum(_list_launches(f.dtype) for f in t.fields)
    return 0


def _lists(schema):
    return sum(_list_launches(f.dtype) for f in schema.fields)


def _sort_launches(bits):
    """K3 and K4 launches of one multi-word sort (ops/sort_keys.
    sort_packed): a K3 pass a word, and a K4 carry of the other words and
    the permutation after each pass once there are two words or more."""
    words = -(-bits // 64)
    return words, (words if words > 1 else 0)


def _rank_launches(longest):
    """K3 and K4 launches of one string key's ranks (ops/sort_keys.
    string_order_ranks_multi), by the engine's own rule: rank_pass_count
    refinement passes, fixed before the first, each a sort of
    rank_pass_words words (a K3 pass a word, and a K4 carry a word when
    there are two or more)."""
    from spark_rapids_tpu_torch.ops.sort_keys import (rank_pass_count,
                                                      rank_pass_words)
    k3 = k4 = 0
    for p in range(rank_pass_count(longest)):
        words = rank_pass_words(p, NDS_RANKED_ROWS)
        k3, k4 = k3 + words, k4 + (words if words > 1 else 0)
    return k3, k4


def _keyed_sort(exprs, longest):
    """K3 and K4 launches of one sort by the key expressions
    (ops/sort_keys._key_lanes: a live bit, then a null bit and a value
    lane a key), string ranks included."""
    from spark_rapids_tpu_torch import datatypes as dt
    k3, k4 = _sort_launches(1 + sum(1 + _lane_bits(e.dtype)
                                    for e in exprs))
    for e in exprs:
        if isinstance(e.dtype, (dt.StringType, dt.BinaryType)):
            r3, r4 = _rank_launches(longest[e.name])
            k3, k4 = k3 + r3, k4 + r4
    return k3, k4


def _union_sort(keys, longest):
    """K3 and K4 launches of ``ops/join.union_group_ids`` over both
    sides: one sort of a live bit and, a key, a validity bit and its
    lane, string keys ranked over both sides first."""
    from spark_rapids_tpu_torch import datatypes as dt
    k3, k4 = _sort_launches(1 + sum(1 + _lane_bits(e.dtype) for e in keys))
    for e in keys:
        if isinstance(e.dtype, (dt.StringType, dt.BinaryType)):
            r3, r4 = _rank_launches(longest[e.name])
            k3, k4 = k3 + r3, k4 + r4
    return k3, k4


def _nds_expected(root, metrics, longest, conf, root_on_device=True):
    """The launches one run of the plan under ``root`` implies, walked
    operator by operator. A node the planner placed on the CPU (the root
    when ``root_on_device`` is false, and every node between a
    ``HostToDeviceExec`` above and a ``DeviceToHostExec`` below)
    launches nothing; the device subtree under a ``DeviceToHostExec``
    launches as it would anywhere, and a ``HostToDeviceExec`` or the
    coalesce above it yields its ``numOutputBatches``. K5: one a scan
    batch. K6: one a batch for each
    LIKE or RLIKE a filter or project evaluates on the device (not a
    LIKE of one literal). A join analyses its build once where it has no
    unique hint, or has one and gathers a build string column (a sort of
    the build's keys: live bit, null bit, lane). A unique build
    (its ``uniqueBuild`` metric) on one fixed-width key is presorted
    once (live bit + lane) and its sorted key gathered once; on several
    keys or a string key each stream batch sorts both sides' keys
    (``_union_sort``) and the build's group ids (one K3). A stream batch
    on the staged path (its ``stagedBatches``) sorts both sides' keys and
    the build's group ids, and gathers its output with one K4 (semi and
    anti joins) or two; an inner or left-outer join on the fast path
    gathers its build columns into each batch (one K4, strings
    included). Right and full outer joins take the staged path for
    every stream batch and emit the unmatched build rows as the build's
    own columns under a selection (no launch). The adaptive reader's
    skew split gives the aggregate over it a partial a piece
    (``numSkewPieces.<i>``). A join without keys (the
    cross join) sorts nothing in stage A and gathers both sides (the
    stream's alone for a semi or anti join), one K4 each; the
    nested-loop join with a condition gathers both sides' pairs a stream
    batch and emits its unmatched rows under a selection, so each of its
    staged batches is two K4. A join's batches are its
    ``numOutputBatches``. The grouped aggregate sorts each partial and
    the final by its keys, then gathers keys and values once and the
    segment starts once (two K4); a MIN or MAX sorts its values by
    (group, value) and gathers them once more in each of those passes
    (``ops/segments._min_max``). An aggregate with an exact percentile
    or a collect takes the single pass instead: its keyed sort and two
    gathers once, then each percentile's or collect's sort of (dropped,
    group, value), a string value's ranks included, a set's compaction
    (one K3) and its gather (one K4), with no partials. A gather that
    moves an array or a map adds one K4 a list level
    (``_list_launches``): an ORDER BY's, a limit's compaction (one K3
    and the gather, a batch under a selection: ``compactedBatches``),
    an array item (``GetArrayItem``) a batch, and an explode's two
    gathers a batch (the repeated columns, then the elements). ORDER BY sorts once and gathers once. A window
    (``exec/window.py``) sorts once by its partition and order keys,
    then gathers the rows and its computed arguments in one K4, and one
    K4 more for each lag, lead, min and max. A union runs each child in
    turn: its batches are theirs. A string key adds its ranks' passes to
    each sort (the longest string of its column, ``longest[name]``,
    fixes their number). A node the plan reaches by several paths (a
    view's scan that a CTE's two uses, or a union's two sides, share)
    runs once a path, and its metrics sum those runs. K7: one a batch
    for each string column an ``XxHash64`` of a filter, project or
    Expand hashes on the device; K8: one a batch for each
    ``RegExpReplace`` or ``RegExpExtract`` there. Expand yields a batch
    a projection list an input batch, or one an input batch where it
    ran inside a fused stage (its ``fusedInto``), and a sample a batch
    an input batch: neither launches a kernel of its own."""
    from spark_rapids_tpu_torch import datatypes as dt
    from spark_rapids_tpu_torch.config import JOIN_VERIFY_UNIQUE_HINT
    from spark_rapids_tpu_torch.exec.aggregate import GpuHashAggregateExec
    from spark_rapids_tpu_torch.exec.aqe import GpuAQEShuffleReadExec
    from spark_rapids_tpu_torch.exec.basic import (GpuFilterExec,
                                                   GpuProjectExec)
    from spark_rapids_tpu_torch.exec.joins import (
        GpuBroadcastNestedLoopJoinExec, _BaseJoinExec)
    from spark_rapids_tpu_torch.exec.exchange import GpuCoalesceBatchesExec
    from spark_rapids_tpu_torch.exec.generate import GpuGenerateExec
    from spark_rapids_tpu_torch.exec.misc import (GpuExpandExec,
                                                  GpuSampleExec,
                                                  GpuUnionExec)
    from spark_rapids_tpu_torch.exec.sort import (GpuGlobalLimitExec,
                                                  GpuSortExec)
    from spark_rapids_tpu_torch.exec.transitions import (DeviceToHostExec,
                                                         HostToDeviceExec)
    from spark_rapids_tpu_torch.exec.window import GpuWindowExec
    from spark_rapids_tpu_torch.expr.aggregates import (GROUP_VALUE_BITS,
                                                        ApproxPercentile,
                                                        Max, Min, _Collect)
    from spark_rapids_tpu_torch.expr.complex import GetArrayItem
    from spark_rapids_tpu_torch.expr.hashes import XxHash64
    from spark_rapids_tpu_torch.expr.strings import (Like, RegExpLike,
                                                     _SpanFunction)
    from spark_rapids_tpu_torch.expr.window import Lag, Lead
    from spark_rapids_tpu_torch.io.scan import GpuFileScanExec
    from spark_rapids_tpu_torch.planner import _walk_expr
    out = {"decode_batch": 0, "sort_pairs": 0, "gather_rows": 0,
           "regex_match": 0, "xxhash64_strings": 0, "find_spans": 0}
    uses = _node_uses(root)

    def m(node, key, default=None):
        """The node's metric for one of its runs (``default`` where the
        node never set it)."""
        node_metrics = metrics.get(node.node_label(), {})
        if key not in node_metrics and default is not None:
            return default
        total = node_metrics[key]
        if total % uses[id(node)]:
            raise AssertionError(f"{node.describe()}: {key} {total} over "
                                 f"{uses[id(node)]} runs")
        return total // uses[id(node)]

    def batches(node):
        if isinstance(node, GpuFileScanExec):
            # the device-decode path counts its batches; the host path's
            # are the operator metrics'
            return m(node, "scanPrograms", 0) or m(node, "batches", 0)
        if isinstance(node, (GpuFilterExec, GpuProjectExec,
                             GpuGenerateExec, GpuSampleExec)):
            return batches(node.child)
        if isinstance(node, GpuExpandExec):
            fused = "fusedInto" in metrics.get(node.node_label(), {})
            return batches(node.child) * (1 if fused
                                          else len(node.projections))
        if isinstance(node, _BaseJoinExec):
            return m(node, "numOutputBatches", 0)
        if isinstance(node, (GpuHashAggregateExec, GpuSortExec,
                             GpuGlobalLimitExec, GpuWindowExec)):
            return 1
        if isinstance(node, GpuUnionExec):
            return sum(batches(c) for c in node.children)
        if isinstance(node, (HostToDeviceExec, GpuCoalesceBatchesExec)):
            return m(node, "numOutputBatches", 0)
        raise AssertionError(f"no batch count for {node.describe()}")

    def add(k3, k4, times=1):
        out["sort_pairs"] += k3 * times
        out["gather_rows"] += k4 * times

    def join(node):
        keys = node.right_keys
        single = len(keys) == 1 and not isinstance(
            keys[0].dtype, (dt.StringType, dt.BinaryType))
        built = m(node, "uniqueBuild", -1)
        if built == -1:  # an empty build side: nothing ran
            return
        staged = m(node, "stagedBatches", 0)
        gathers = 0 if node.semi else 1
        if node.cross:
            # stage A sorts nothing; a condition's pairs gather both
            # sides, a semi or anti cross join without one the stream's
            pair = node.condition is not None and isinstance(
                node, GpuBroadcastNestedLoopJoinExec)
            add(0, 2 if pair else gathers + 1, times=staged)
            return
        if not node.outer_build and (node.analyses_build() or (
                node.build_unique_hint and not single
                and conf.get(JOIN_VERIFY_UNIQUE_HINT))):
            add(*_keyed_sort(keys, longest))
        fast = batches(node.left) - staged
        if built:
            if single:
                k3, k4 = _sort_launches(1 + _lane_bits(keys[0].dtype))
                add(k3, k4 + 1)
            else:
                k3, k4 = _union_sort(keys, longest)
                add(k3 + 1, k4, times=fast)
            add(0, gathers, times=fast)
        k3, k4 = _union_sort(keys, longest)
        add(k3 + 1, k4 + gathers + 1, times=staged)

    def null_side_partials(node):
        """``(partials, names)``: the aggregate's partials made from a
        conditioned left or full outer join's unmatched-stream batches
        (``exec/joins._execute_conditioned`` emits, a stream batch, the
        passing pairs and then those rows beside nulls), and the build
        side's column names, whose strings are all null there: a string
        key among them ranks with no pass in those partials. Found down
        a chain of one-child operators; a coalesce mixes the batches,
        and then there are none."""
        chain = node.child
        exchange = reader = None
        while not isinstance(chain, _BaseJoinExec):
            if len(chain.children) != 1 \
                    or isinstance(chain, GpuCoalesceBatchesExec):
                return 0, ()
            if type(chain).__name__ == "GpuShuffleExchangeExec":
                exchange = chain
            if isinstance(chain, GpuAQEShuffleReadExec):
                reader = chain
            chain = chain.children[0]
        if chain.condition is None or chain.join_type not in (
                "left_outer", "full_outer") or chain.cross:
            return 0, ()
        partials = m(node, "numPartials")
        staged = m(chain, "stagedBatches")
        if exchange is not None:
            # every map batch gives each partition group but a skewed
            # one a batch, and the skewed partition its view's pieces
            # (``numSkewPieces.<i>``: map batch i's); a stream batch's
            # unmatched rows are its second map batch
            pieces = {}
            if reader is not None:
                for key, v in metrics.get(reader.node_label(), {}).items():
                    if key.startswith("numSkewPieces."):
                        pieces[int(key.split(".")[1])] = v
            per_map, rest = divmod(partials - sum(pieces.values()),
                                   m(exchange, "numInputBatches"))
            assert not rest, "partials a map batch differ"
            partials = per_map * staged + sum(
                pieces.get(2 * j + 1, 0) for j in range(staged))
        else:
            partials = staged
        return partials, tuple(chain.right.output_schema.names)

    def aggregate(node):
        if not node._wants_single_pass(conf):
            passes = m(node, "numPartials") + 1
            k3, k4 = _keyed_sort(node.group_exprs, longest)
            empty, names = null_side_partials(node)
            if empty:
                e3, e4 = _keyed_sort(node.group_exprs, dict(
                    longest, **{n: 0 for n in names if n in longest}))
                add(e3 - k3, e4 - k4, times=empty)
            add(k3, k4 + 2, times=passes)
            for a in node.aggs:
                if isinstance(a, (Min, Max)):
                    k3, k4 = _sort_launches(32 + _lane_bits(
                        a.children[0].dtype))
                    add(k3, k4 + 1, times=passes)
            return
        if node.group_exprs:
            k3, k4 = _keyed_sort(node.group_exprs, longest)
            add(k3, k4 + 2)
        for a in node.aggs:
            if isinstance(a, (ApproxPercentile, _Collect)):
                vt = a.children[0].dtype
                k3, k4 = _sort_launches(GROUP_VALUE_BITS + _lane_bits(vt))
                if isinstance(vt, (dt.StringType, dt.BinaryType)):
                    r3, r4 = _rank_launches(longest[a.children[0].name])
                    k3, k4 = k3 + r3, k4 + r4
                # a set's duplicates go by one compaction
                add(k3 + bool(getattr(a, "dedupe", False)), k4 + 1)

    def walk(node, on_device=True):
        if isinstance(node, (DeviceToHostExec, HostToDeviceExec)):
            for c in node.children:
                walk(c, isinstance(node, DeviceToHostExec))
            return
        if not on_device:
            for c in node.children:
                walk(c, False)
            return
        if isinstance(node, (GpuFilterExec, GpuProjectExec,
                             GpuExpandExec)):
            exprs = [e for root_e in node.expressions()
                     for e in _walk_expr(root_e)]
            out["xxhash64_strings"] += batches(node.child) * sum(
                isinstance(c.dtype, (dt.StringType, dt.BinaryType))
                for e in exprs if isinstance(e, XxHash64)
                for c in e.children)
            out["find_spans"] += batches(node.child) * sum(
                isinstance(e, _SpanFunction) for e in exprs)
        if isinstance(node, GpuFileScanExec):
            out["decode_batch"] += m(node, "scanPrograms", 0)
        elif isinstance(node, (GpuFilterExec, GpuProjectExec)):
            regexes = sum(isinstance(e, (Like, RegExpLike))
                          and e.program() is not None
                          for root_e in node.expressions()
                          for e in _walk_expr(root_e))
            out["regex_match"] += regexes * batches(node.child)
            # an array item is a gather of the element column
            items = sum(1 + _list_launches(e.dtype)
                        for root_e in node.expressions()
                        for e in _walk_expr(root_e)
                        if isinstance(e, GetArrayItem))
            add(0, items, times=batches(node.child))
        elif isinstance(node, _BaseJoinExec):
            join(node)
        elif isinstance(node, GpuHashAggregateExec) and node.group_exprs:
            aggregate(node)
        elif isinstance(node, GpuHashAggregateExec):
            if node._wants_single_pass(conf):
                aggregate(node)
        elif isinstance(node, GpuSortExec):
            k3, k4 = _keyed_sort([o.child for o in node.orders], longest)
            add(k3, k4 + 1 + _lists(node.output_schema))
        elif isinstance(node, GpuGlobalLimitExec):
            # a batch under a selection is compacted: one K3 sort of its
            # dropped bit, then its gather
            add(1, 1 + _lists(node.output_schema),
                times=m(node, "compactedBatches", 0))
        elif isinstance(node, GpuGenerateExec):
            # the repeated columns by source row, the elements by index
            kept = node._kept_schema
            per = (1 + _lists(kept) if kept.fields else 0) + 1 + sum(
                _list_launches(f.dtype) for f in node.output_schema.fields[
                    len(kept.fields) + int(node.position):])
            add(0, per, times=batches(node.child))
        elif isinstance(node, GpuWindowExec):
            k3, k4 = _keyed_sort(node.part_exprs
                                 + [o.child for o in node.orders], longest)
            gathers = sum(isinstance(we.func, (Lag, Lead, Min, Max))
                          for we in node.win_exprs)
            add(k3, k4 + 1 + gathers)
        for c in node.children:
            walk(c)

    walk(root, root_on_device)
    return out


def _node_uses(root):
    """How many paths from ``root`` reach each node (by id)."""
    uses = {}

    def walk(node):
        uses[id(node)] = uses.get(id(node), 0) + 1
        for c in node.children:
            walk(c)

    walk(root)
    return uses


def _nds_longest(want):
    """The longest string each string column of the query's output holds
    (bytes), from the oracle's rows: the L that fixes the rank passes of
    a sort or grouped aggregate keyed by that column
    (ops/sort_keys.py: L is the longest string among the rows the sort
    is given, dead ones included). It assumes this of the plan: every
    row that reaches a string-keyed sort or aggregate, dead or not, holds
    one of the values the output shows in that column or none longer,
    and every batch and the final hold a row of the longest. That holds
    where a filter on the string's table runs before the join that
    gathers it (the join gives an unmatched row length 0), where a CASE
    of literals makes the key and all its literals are output, and where
    no HAVING or LIMIT drops groups after the sort. A window keyed by the
    column keeps it too when a filter on its rank or row number drops rows
    after the window's sort (q_rank's ``rk <= 3``, q_rownum's ``rn = 1``):
    every partition has a row of rank 1, so the output still shows every
    value of the PARTITION BY key, though only some of its rows. A plan
    that breaks the assumption shows as a launch count that disagrees. A
    string key that the output does not show has no entry, and its lookup
    fails."""
    import pyarrow as pa
    return {f.name: max((len(v.encode())
                         for v in want.column(f.name).to_pylist()
                         if v is not None), default=0)
            for f in want.schema
            if pa.types.is_string(f.type) or pa.types.is_large_string(f.type)}


def _check_nds(q, out, want, metrics, need_chunks, floats):
    """The rows against the oracle (ints and strings exact, the
    ``floats`` columns rel 1e-9, nulls where the oracle has them, row
    order exact) and every scan's chunk counters."""
    import math
    if out.column_names != want.column_names \
            or out.num_rows != want.num_rows or out.num_rows == 0:
        raise AssertionError(f"{q}: {out.num_rows} rows {out.column_names}"
                             f", oracle {want.num_rows} "
                             f"{want.column_names}")
    worst = 0.0
    for c in out.column_names:
        if c not in floats and out.column(c).type == want.column(c).type \
                and out.column(c).equals(want.column(c)):
            continue
        g, w = out.column(c).to_pylist(), want.column(c).to_pylist()
        if c not in floats:
            if g != w:
                raise AssertionError(f"{q}: column {c} {g} vs oracle {w}")
            continue
        for a, b in zip(g, w):
            if a is None or b is None:
                if a is not b:
                    raise AssertionError(f"{q}: {c} {g} vs oracle {w}")
                continue
            rel = abs(a - b) / max(abs(b), 1e-300)
            worst = max(worst, rel)
            if not math.isfinite(a) or rel > ENGINE_RTOL:
                raise AssertionError(f"{q}: {c} {a!r} vs oracle {b!r} "
                                     f"(rel {rel:.3e})")
    _check_chunks(q, metrics, need_chunks)
    return worst


def _check_chunks(q, metrics, need_chunks):
    """Every device scan's ``(deviceChunks, fallbackChunks)`` against
    ``need_chunks`` (``_scan_chunks_needed``); a scan on the CPU keeps no
    chunk counters."""
    scans = [m for label, m in metrics.items()
             if label.startswith("FileScanExec") and "deviceChunks" in m]
    got = sorted((m["deviceChunks"], m["fallbackChunks"]) for m in scans)
    need = sorted(n if isinstance(n, tuple) else (n, 0)
                  for n in need_chunks)
    if got != need:
        raise AssertionError(f"{q}: scan chunks {got}, expected {need}")


def _scan_chunks_needed(root, chunks, root_on_device=True):
    """Chunks each scan of the plan on the device must read: its file's
    row groups x columns, once a path that reaches it; a file whose
    ``chunks`` entry is a pair ``(device, host)`` reads both (the nested
    columns are host chunks)."""
    from spark_rapids_tpu_torch.exec.transitions import (DeviceToHostExec,
                                                         HostToDeviceExec)
    from spark_rapids_tpu_torch.io.scan import GpuFileScanExec
    need, seen = [], {}

    def walk(node, on_device):
        if isinstance(node, GpuFileScanExec) and on_device:
            seen.setdefault(id(node), [node, 0])[1] += 1
        if isinstance(node, (DeviceToHostExec, HostToDeviceExec)):
            on_device = isinstance(node, DeviceToHostExec)
        for c in node.children:
            walk(c, on_device)

    walk(root, root_on_device)
    for node, runs in seen.values():
        per = [chunks[p] if isinstance(chunks[p], tuple) else (chunks[p], 0)
               for p in node.paths]
        dev, host = (runs * sum(x[i] for x in per) for i in (0, 1))
        need.append((dev, host) if host else dev)
    return need


def _nds_files():
    """The NDS tables at ``NDS_SALES`` rows, their files, and each
    file's device chunks (row groups x columns)."""
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.tools.nds_trace import nds_paths

    t0 = time.perf_counter()
    tables = nds.gen_tables(NDS_SALES)
    paths = nds_paths(NDS_SALES)
    log(f"[nds] {NDS_SALES} store_sales rows: tables and files ready in "
        f"{time.perf_counter() - t0:.3f} s")
    chunks = {}
    for p in paths.values():
        md = pq.ParquetFile(p).metadata
        chunks[p] = md.num_row_groups * md.num_columns
    return tables, paths, chunks


#: each text's oracle rows, by (oracle function, text), for phases 12
#: and 17
ORACLES = {}


def _oracle(fn, q, tables):
    """``fn(q, tables)``, computed once a run (``ORACLES``)."""
    if (fn, q) not in ORACLES:
        ORACLES[(fn, q)] = fn(q, tables)
    return ORACLES[(fn, q)]


#: the processes that compute a corpus's oracles at once: the oracles
#: are numpy and pyarrow on the host, 5 s a text at 2^22 rows, and the
#: card's machine has 8 cores
ORACLE_WORKERS = 6
#: what a forked oracle process reads: (oracle function, tables)
_ORACLE_INPUT = None


def _oracle_job(q):
    fn, tables = _ORACLE_INPUT
    return q, fn(q, tables)


def _corpus_oracles(corpus, tables):
    """``{q: corpus.oracle(q, tables)}`` for every text of ``corpus``,
    computed in ``ORACLE_WORKERS`` forked processes before the phase's
    runs (the children read the tables the fork shares, run only numpy
    and pyarrow and never touch the card; the pool ends with the
    call)."""
    import multiprocessing
    global _ORACLE_INPUT
    t0 = time.perf_counter()
    _ORACLE_INPUT = (corpus.oracle, tables)
    try:
        with multiprocessing.get_context("fork").Pool(
                min(ORACLE_WORKERS, len(corpus.QUERIES))) as pool:
            out = dict(pool.imap_unordered(_oracle_job, corpus.QUERIES))
    finally:
        _ORACLE_INPUT = None
    log(f"[oracles] {len(out)} texts in {time.perf_counter() - t0:.3f} s "
        f"({ORACLE_WORKERS} processes)")
    return out

#: by phase tag: the host seconds of each verified plan's verify_plan, and
#: the plans the verifier refused
VERIFY_STATS = {}


def _apply(conf, device, node, tag, verify=True):
    """``GpuOverrides.apply``, its verifier's host time recorded under
    ``tag``; a refusal is counted and raised (``PlanVerificationError``).
    With ``verify`` the plan must have been verified (the conf leaves
    spark.rapids.sql.verifyPlan on)."""
    from spark_rapids_tpu_torch.analysis.plan_verifier import \
        PlanVerificationError
    from spark_rapids_tpu_torch.planner import GpuOverrides
    st = VERIFY_STATS.setdefault(tag, {"verify_s": [], "refused": 0})
    try:
        pp = GpuOverrides(conf, device).apply(node)
    except PlanVerificationError:
        st["refused"] += 1
        raise
    if verify:
        _verified(pp, tag)
    return pp


def _verified(pp, tag):
    """A planned plan must have been verified clean; its verifier's host
    time is recorded under ``tag``."""
    if pp.verify_report is None or not pp.verify_report.ok:
        raise AssertionError(f"[{tag}] a plan was not verified")
    VERIFY_STATS.setdefault(tag, {"verify_s": [], "refused": 0})[
        "verify_s"].append(pp.verify_s)


def _log_verifier(tag):
    """The phase's verifier counts and verify_plan's host times."""
    st = VERIFY_STATS.get(tag, {"verify_s": [], "refused": 0})
    ms = [x * 1e3 for x in st["verify_s"]]
    out = {"verified": len(ms), "refused": st["refused"],
           "median_ms": statistics.median(ms) if ms else None,
           "max_ms": max(ms) if ms else None}
    log(f"[{tag}] verifier: {out['verified']} plans verified clean, "
        f"{out['refused']} refused; verify_plan host time median "
        f"{out['median_ms']!r} ms, max {out['max_ms']!r} ms")
    return out


def _transfer_times(metrics):
    """The transitions' summed ``downloadTime`` and ``uploadTime`` (s)."""
    out = {"downloadTime": 0.0, "uploadTime": 0.0}
    for label, m in metrics.items():
        if label.startswith(("DeviceToHostExec", "HostToDeviceExec")):
            for k in out:
                out[k] += m.get(k, 0.0)
    return out


def _run_sql_queries(device, tag, corpus, files, timed=(3, 1),
                     warm=(True, True), opm_off=False, cold=()):
    """Each of ``corpus``'s queries (a module with ``QUERIES``,
    ``SQL_QUERIES``, ``oracle`` and ``FLOAT_COLUMNS``, and optionally
    ``CONF``, a query's conf, and ``FALLBACK``, its nodes on the CPU,
    none by default) from SQL over the NDS files: planning timed apart,
    at 1 partition a warm-up and ``timed[0]`` timed runs, at 16 a
    warm-up and ``timed[1]`` (``warm`` turns each warm-up off), each
    result held to the oracle, its placement to ``FALLBACK`` and its
    device scans to their chunks, and the first timed run's K3, K4, K5
    and K6 launches (the wrappers count them as they launch, at no cost)
    to ``_nds_expected``. Every plan is verified clean (``_apply``). The
    queries in ``cold`` run without a warm-up (a CPU island's host pass
    takes seconds, and nothing of it warms). With
    ``opm_off``, the warm-up at 1 partition runs under
    spark.rapids.metrics.op.enabled=false and one more such run follows
    the first timed run: the summary's ``ms_opm_off``."""
    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.exec.base import ExecCtx
    from spark_rapids_tpu_torch.obs.opmetrics import OP_METRICS_ENABLED
    from spark_rapids_tpu_torch.tools.nds_trace import counters

    tables, paths, chunks = files
    t_phase = time.perf_counter()
    summary, launches = {}, {}
    wrappers = counters()
    oracles = _corpus_oracles(corpus, tables)
    for q in corpus.QUERIES:
        want = oracles[q]
        ORACLES[(corpus.oracle, q)] = want
        longest = _nds_longest(want)
        for parts, n_runs, warm_up in zip((1, 16), timed, warm):
            conf = dict(getattr(corpus, "CONF", {}).get(q, {}))
            conf["spark.sql.shuffle.partitions"] = str(parts)
            s = nds.session_over_files(paths, conf, device)
            # planning (GpuSession.sql + GpuOverrides.apply), timed apart
            # from the collect below
            plan_times = []
            for _ in range(3):
                t = time.perf_counter()
                node = corpus.plan(s, q)._node if hasattr(corpus, "plan") \
                    else s.sql(corpus.SQL_QUERIES[q])._node
                pp = _apply(s.conf, device, node, tag)
                plan_times.append(time.perf_counter() - t)
            on_cpu = pp.fallback_nodes()
            if on_cpu != getattr(corpus, "FALLBACK", {}).get(q, []):
                raise AssertionError(f"{q} p{parts}: nodes on the CPU "
                                     f"{on_cpu}")

            def run(off=False):
                ctx = ExecCtx(s.conf.with_settings(
                    {OP_METRICS_ENABLED.key: "false"}) if off else s.conf,
                    device)
                mem0 = _pressure_figures(ctx.mm)
                t = time.perf_counter()
                out = pp.collect(ctx)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t
                moved = _delta(_pressure_figures(ctx.mm), mem0)
                if any(moved.values()):
                    raise AssertionError(f"{q} p{parts}: the default "
                                         f"budget's run moved {moved}")
                return out, secs, ctx

            off = opm_off and parts == 1
            if warm_up and q not in cold:
                run(off=off)
            for c in wrappers.values():
                c.launches = 0
            runs = [run()]
            got = {c.__name__: c.launches for c in wrappers.values()}
            off_times = [run(off=True)[1]] if off else []
            runs += [run() for _ in range(n_runs - 1)]
            times = [r[1] for r in runs]
            out, _, ctx = runs[0]
            metrics = _metrics(ctx)
            rel = _check_nds(q, out, want, metrics,
                             _scan_chunks_needed(pp.root, chunks,
                                                 pp.root_on_device),
                             corpus.FLOAT_COLUMNS[q])
            med = statistics.median(times)
            plan_med = statistics.median(plan_times)
            moved = _transfer_times(metrics)
            summary[f"{q}_p{parts}"] = {
                "rows_per_s": NDS_SALES / med, "ms": med * 1e3,
                "times_s": times, "max_rel_err": rel,
                "plan_ms": plan_med * 1e3, "plan_times_s": plan_times,
                "fallback_nodes": on_cpu,
                "download_ms": moved["downloadTime"] * 1e3,
                "upload_ms": moved["uploadTime"] * 1e3,
                "skewed_partitions": _op_metric(
                    metrics, "AQEShuffleReadExec", "numSkewedPartitions"),
                "skew_splits": _op_metric(metrics, "AQEShuffleReadExec",
                                          "numSkewSplits")}
            if off_times:
                summary[f"{q}_p{parts}"].update(
                    ms_opm_off=statistics.median(off_times) * 1e3,
                    times_opm_off_s=off_times)
            log(f"[{tag}] {q} partitions={parts}: {NDS_SALES / med:.1f} "
                f"rows/s, {med * 1e3:.3f} ms a query in collect (median "
                f"of {[round(t, 6) for t in times]} s); planning "
                f"(sql + apply) {plan_med * 1e3:.3f} ms (median of "
                f"{[round(t, 6) for t in plan_times]} s); {out.num_rows} "
                f"rows equal to the oracle (max rel err {rel:.3e}); on "
                f"the CPU {on_cpu}, downloadTime "
                f"{moved['downloadTime'] * 1e3:.3f} ms, uploadTime "
                f"{moved['uploadTime'] * 1e3:.3f} ms")
            log(f"[{tag}] {q} partitions={parts} metrics "
                + json.dumps(metrics, sort_keys=True))
            implied = _nds_expected(pp.root, metrics, longest, s.conf,
                                    pp.root_on_device)
            log(f"[{tag}] {q} partitions={parts} launches {got}, the plan "
                f"implies {implied}")
            if got != implied:
                raise AssertionError(f"{q} p{parts}: launches {got}, "
                                     f"expected {implied}")
            launches[f"{q}_p{parts}"] = got
    summary["verifier"] = _log_verifier(tag)
    log(f"[{tag}] phase took {time.perf_counter() - t_phase:.3f} s")
    return summary, launches


def phase_nds(device, files):
    from types import SimpleNamespace

    from spark_rapids_tpu_torch import nds
    corpus = SimpleNamespace(QUERIES=nds.PORTED_QUERIES,
                             SQL_QUERIES=nds.SQL_QUERIES,
                             FLOAT_COLUMNS=nds.FLOAT_COLUMNS,
                             oracle=nds.oracle)
    # no warm-up at 16 partitions: the phase's time goes to the
    # op-metrics-off runs at 1 (phase 12's on/off figures)
    # 1 timed run at 1 partition (3, then 2, until the smoke passed
    # 1,050 s each time)
    return _run_sql_queries(device, "nds", corpus, files, timed=(1, 1),
                            warm=(True, False), opm_off=True)


def phase_nds_joins(device, files):
    from spark_rapids_tpu_torch.tools import nds_joins
    return _run_sql_queries(device, "nds-joins", nds_joins, files,
                            timed=(1, 1), warm=(True, False))


def phase_nds_fallback(device, files):
    """The eight fallback texts: a warm-up and one timed run at 1
    partition, one run at 16 (a CPU island's join or scan over 2^22 rows
    takes seconds, and the phase stays within its budget). At 16
    partitions q_outer_price's null-key partition trips the skew rule:
    the on-card witness of the adaptive reader's skew split
    (``SKEW_WITNESS``), held to a skewed partition and a split."""
    from spark_rapids_tpu_torch.tools import nds_fallback
    summary, launches = _run_sql_queries(
        device, "nds-fallback", nds_fallback, files, timed=(1, 1),
        warm=(True, False))
    got = summary[SKEW_WITNESS]
    if not (got["skewed_partitions"] > 0 and got["skew_splits"] > 0):
        raise AssertionError(f"{SKEW_WITNESS}: {got['skewed_partitions']}"
                             f" skewed partitions, {got['skew_splits']} "
                             "skew splits")
    log(f"[nds-fallback] the skew split on the card: {SKEW_WITNESS} has "
        f"{got['skewed_partitions']} skewed partition(s) and "
        f"{got['skew_splits']} skew splits")
    return summary, launches


#: phase 10's run whose partition stats trip the skew rule on the card
SKEW_WITNESS = "q_outer_price_p16"

# --- phase 11: the memory manager and the query lifecycle -------------------

#: the least share of the bytes the ledger credited a spill's own device
#: storages released (``_storage_refs``), by the function that registered the
#: entry: a sort run (its sorter drops the run before it spills it) and
#: a shuffle map batch (the transport keeps the batch its taker still
#: holds pinned, so the one evicted is let go). The percentile's inputs
#: are not held to a share: they are the shuffle's map batches, or views
#: of them, counted twice in the ledger, so of the two spills of one
#: buffer the first frees nothing.
SPILL_FREED_SHARES = {"sort.GpuSortExec._sort_out_of_core": 0.9,
                      "transport._MapEntry.__init__": 0.9}
#: how far torch.cuda.memory_allocated() may stay above its value before
#: the cancelled query
CANCEL_MARGIN_BYTES = 32 << 20
#: the first retry scopes that raise an injected OOM in the ladder run
LADDER_STORM = 16
#: the deadline that cancels q97 mid-run (its run takes well over it)
DEADLINE_S = 0.4


def _rows_equal(q, out, want, floats):
    """The rows against the oracle in order, by numpy: ints and strings
    exact, the ``floats`` columns rel ``ENGINE_RTOL``, nulls where the
    oracle has them."""
    import numpy as np
    if out.column_names != want.column_names \
            or out.num_rows != want.num_rows or out.num_rows == 0:
        raise AssertionError(f"{q}: {out.num_rows} rows {out.column_names}"
                             f", oracle {want.num_rows} "
                             f"{want.column_names}")
    worst = 0.0
    for c in out.column_names:
        g, w = out.column(c), want.column(c)
        if g.null_count != w.null_count:
            raise AssertionError(f"{q}: {c} nulls {g.null_count} vs "
                                 f"{w.null_count}")
        gn = g.to_numpy(zero_copy_only=False)
        wn = w.to_numpy(zero_copy_only=False)
        if c not in floats:
            if not (gn == wn).all():
                bad = int(np.flatnonzero(gn != wn)[0])
                raise AssertionError(f"{q}: column {c} row {bad}: "
                                     f"{gn[bad]!r} vs oracle {wn[bad]!r}")
            continue
        rel = np.abs(gn - wn) / np.maximum(np.abs(wn), 1e-300)
        worst = max(worst, float(rel.max()))
        if not np.isfinite(gn).all() or worst > ENGINE_RTOL:
            raise AssertionError(f"{q}: {c} rel err {worst:.3e}")
    return worst


def _pressure_figures(mm):
    """The manager's counts that move only under memory pressure: a
    query at the default budget leaves them where they were."""
    return {k: getattr(mm, k) for k in (
        "spill_bytes", "readback_count", "oom_retries")}


def _memory_figures(mm):
    return {k: getattr(mm, k) for k in (
        "spill_bytes", "spill_count", "disk_spill_bytes",
        "spill_read_bytes", "readback_count", "oom_retries",
        "forced_spill_bytes")}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _op_metric(metrics, prefix, name):
    return sum(m.get(name, 0) for label, m in metrics.items()
               if label.startswith(prefix))


def _mechanism(q, parts, metrics, mem):
    """Each text's own figure, which must be above 0 (its path ran)."""
    if q == "q_sales_sorted":
        fig = {"numRuns": _op_metric(metrics, "SortExec", "numRuns"),
               "mergeRounds": _op_metric(metrics, "SortExec",
                                         "mergeRounds"),
               "spillTime": _op_metric(metrics, "SortExec", "spillTime"),
               "spill_bytes": mem["spill_bytes"],
               "disk_spill_bytes": mem["disk_spill_bytes"],
               "spill_read_bytes": mem["spill_read_bytes"]}
    elif q == "q_last_purchase":
        fig = {"windowBuckets": _op_metric(metrics, "WindowExec",
                                           "windowBuckets"),
               "spillTime": _op_metric(metrics, "WindowExec", "spillTime")}
    elif q == "q_customer_items":
        fig = {"mergeRounds": _op_metric(metrics, "HashAggregateExec",
                                         "mergeRounds"),
               "spillTime": _op_metric(metrics, "HashAggregateExec",
                                       "spillTime")}
    elif q == "q_percentile":
        fig = {"cpuAggregate": _op_metric(metrics, "HashAggregateExec",
                                          "cpuAggregate")}
    else:
        fig = {"spill_bytes": mem["spill_bytes"],
               "readback_count": mem["readback_count"]}
    zero = [k for k, v in fig.items() if not v > 0]
    if zero:
        raise AssertionError(f"{q} p{parts}: the path's figures {zero} "
                             f"are 0: {fig}")
    return fig


def _spill_site():
    """The port's function that registered an entry: the first frame
    outside ``memory.py`` (``module.qualified_name``)."""
    f = sys._getframe(2)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith("spark_rapids_tpu_torch") \
                and not mod.endswith(".memory"):
            return f"{mod.rsplit('.', 1)[-1]}.{f.f_code.co_qualname}"
        f = f.f_back
    return "?"


def _storage_refs(batch):
    """``{data_ptr: (weak reference, bytes)}`` of every storage a device
    batch's tensors use (its columns, their children, its selection)."""
    from torch.multiprocessing.reductions import StorageWeakRef
    out = {}

    def add(t):
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            st = t.untyped_storage()
            out.setdefault(st.data_ptr(), (StorageWeakRef(st), st.nbytes()))

    def col(c):
        for t in (c.data, c.validity, c.offsets, c.chars):
            add(t)
        for ch in c.children or ():
            col(ch)

    for c in batch.columns:
        col(c)
    add(batch.selection)
    return out


def _spill_probe():
    """Wrap ``DeviceMemoryManager.register`` to label each entry with
    the function that registered it, and ``SpillableBatch.spill`` to
    record, for every spill that moved an entry off the card, ``(site,
    first, freed, credited)``: ``first`` is whether it was the entry's
    first spill (a re-spill follows an upload at a read), ``freed`` the
    bytes of the entry's own device storages that the spill released
    (nothing else holds them: their weak references expired), where a
    fall in memory_allocated() would also count what other threads (the
    scan's uploads) allocate meanwhile, ``credited`` the bytes the
    ledger credited. Returns (records, restore)."""
    from spark_rapids_tpu_torch.memory import (DeviceMemoryManager,
                                               SpillableBatch)
    orig_spill, orig_reg = SpillableBatch.spill, DeviceMemoryManager.register
    recs, sites = [], {}

    def register(self, batch, *a, **kw):
        # by the batch: the registration's own eviction may spill it
        sites[id(batch)] = _spill_site()
        sb = orig_reg(self, batch, *a, **kw)
        sb.probe_site = sites.pop(id(batch))
        return sb

    def spill(self, *a, **kw):
        on, first = self.on_device, self.spill_count == 0
        site = getattr(self, "probe_site", None) \
            or sites.get(id(self._device), "?")
        held = _storage_refs(self._device) if on else {}
        orig_spill(self, *a, **kw)
        if on and not self.on_device:
            recs.append((site, first,
                         sum(n for ref, n in held.values()
                             if ref.expired()),
                         self.nbytes))

    SpillableBatch.spill = spill
    DeviceMemoryManager.register = register

    def restore():
        SpillableBatch.spill = orig_spill
        DeviceMemoryManager.register = orig_reg
    return recs, restore


def _spill_shares(recs):
    """Each (site, first spill or re-spill) group's count and least and
    largest share of the credited bytes that its storages gave back."""
    out = {}
    for site, first, freed, credited in recs:
        if credited:
            key = f"{site}:{'first' if first else 're'}"
            out.setdefault(key, []).append(freed / credited)
    return {k: {"n": len(v), "min": min(v), "max": max(v)}
            for k, v in sorted(out.items())}


def _crc_timing():
    """Which CRC32C the seals use, and the port's own CRC32C timed on a
    64 MiB payload (the size of a sort run's Arrow file here) beside
    google_crc32c where it imports."""
    import numpy as np
    from spark_rapids_tpu_torch.shuffle import integrity
    payload = np.random.default_rng(0).integers(
        0, 256, 64 << 20, dtype=np.uint8).tobytes()
    t = time.perf_counter()
    own = integrity.crc32c_numpy(payload)
    own_s = time.perf_counter() - t
    out = {"impl": integrity.CRC32C_IMPL, "payload_bytes": len(payload),
           "numpy_s": own_s}
    if integrity.CRC32C_IMPL == "google_crc32c":
        t = time.perf_counter()
        ref = integrity.crc32c(payload)
        out["google_crc32c_s"] = time.perf_counter() - t
        if ref != own:
            raise AssertionError("the port's CRC32C disagrees with "
                                 "google_crc32c")
    if integrity.crc32c_numpy(b"123456789") != 0xE3069283:
        raise AssertionError("CRC32C check value")
    log(f"[nds-memory] CRC32C: {out['impl']} seals the spill files; the "
        f"port's own over {len(payload)} bytes took {own_s * 1e3:.3f} ms"
        + (f", google_crc32c {out['google_crc32c_s'] * 1e3:.3f} ms"
           if "google_crc32c_s" in out else ""))
    return out


def _real_oom(device, paths, tables):
    """q_pivot at 1 partition: every retry scope's need is measured on an
    unconstrained run, then the run repeats with the process's memory
    fraction cut, at the scope that needs most, to the memory reserved
    there plus 0.6 of its need: the stage raises torch.OutOfMemoryError,
    with_retry halves it, and the rows equal the unconstrained run's."""
    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.exec.base import ExecCtx
    from spark_rapids_tpu_torch.memory import DeviceMemoryManager
    q = "q_pivot"
    # no feeder thread: nothing else allocates while the limit is cut
    s = nds.session_over_files(paths, {"spark.sql.shuffle.partitions": "1",
                                       "spark.rapids.sql.scan.uploadThreads":
                                       "0"}, device)
    pp = _apply(s.conf, device, s.sql(nds.SQL_QUERIES[q])._node,
                "nds-memory")
    orig = DeviceMemoryManager.with_retry
    total = torch.cuda.get_device_properties(device).total_memory
    state = {"depth": 0, "calls": 0, "needs": [], "cut_at": None,
             "cut": None}

    def with_retry(self, batch, fn, depth=0, qctx=None):
        if state["depth"]:
            return orig(self, batch, fn, depth, qctx)
        idx = state["calls"]
        state["calls"] += 1
        state["depth"] += 1
        try:
            if state["cut_at"] == idx:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                limit = torch.cuda.memory_reserved() \
                    + int(0.6 * state["needs"][idx])
                state["cut"] = limit
                torch.cuda.set_per_process_memory_fraction(limit / total)
                try:
                    return orig(self, batch, fn, depth, qctx)
                finally:
                    torch.cuda.set_per_process_memory_fraction(1.0)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = orig(self, batch, fn, depth, qctx)
            torch.cuda.synchronize()
            state["needs"].append(torch.cuda.max_memory_allocated() - base)
            return out
        finally:
            state["depth"] -= 1

    DeviceMemoryManager.with_retry = with_retry
    try:
        free = pp.collect(ExecCtx(s.conf, device))
        needs = list(state["needs"])
        state.update(calls=0, needs=needs,
                     cut_at=max(range(len(needs)), key=needs.__getitem__))
        ctx = ExecCtx(s.conf, device)
        before = ctx.mm.oom_retries
        cut = pp.collect(ctx)
    finally:
        DeviceMemoryManager.with_retry = orig
        torch.cuda.set_per_process_memory_fraction(1.0)
    halvings = ctx.mm.oom_retries - before
    rungs = dict(pp.last_qctx.ladder.counts)
    if halvings < 1 or set(rungs) - {"halve"}:
        raise AssertionError(f"{q}: under a limit of {state['cut']} bytes "
                             f"(needs {needs}) halved {halvings} times, "
                             f"rungs {rungs}")
    # the halves' partials add in another order: floats rel ENGINE_RTOL
    _rows_equal(q, cut, free, nds.FLOAT_COLUMNS[q])
    _rows_equal(q, cut, nds.oracle(q, tables), nds.FLOAT_COLUMNS[q])
    out = {"query": q, "stage_need_bytes": needs[state["cut_at"]],
           "scope": state["cut_at"], "scopes": len(needs),
           "limit_bytes": state["cut"], "halvings": halvings}
    log(f"[nds-memory] real OOM: {q} p1, retry scope {out['scope']} of "
        f"{out['scopes']} needs {out['stage_need_bytes']} bytes; under a "
        f"limit of {out['limit_bytes']} reserved bytes it raised "
        f"torch.OutOfMemoryError and was halved {halvings} time(s); rows "
        "equal the unconstrained run's and the oracle")
    return out


def _ladder(device, paths, tables):
    """q3 under injectRetryOOM.storm: halve -> spill -> width1 -> cpu,
    the CPU rerun's rows held to the oracle."""
    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.exec.base import ExecCtx
    conf = {"spark.sql.shuffle.partitions": "1",
            "spark.rapids.sql.test.injectRetryOOM.storm": str(LADDER_STORM)}
    s = nds.session_over_files(paths, conf, device)
    pp = _apply(s.conf, device, s.sql(nds.SQL_QUERIES["q3"])._node,
                "nds-memory")
    ctx = ExecCtx(s.conf, device)
    t = time.perf_counter()
    out = pp.collect(ctx)
    secs = time.perf_counter() - t
    counts = dict(pp.last_qctx.ladder.counts)
    fell = _op_metric(_metrics(ctx), pp.root.pretty_name(),
                      "ladderCpuFallback")
    rel = _rows_equal("q3", out, nds.oracle("q3", tables),
                      nds.FLOAT_COLUMNS["q3"])
    if fell != 1 or [r for r in ("halve", "spill", "width1", "cpu")
                     if not counts.get(r)]:
        raise AssertionError(f"ladder: rungs {counts}, ladderCpuFallback "
                             f"{fell}")
    log(f"[nds-memory] ladder: q3 p1 under injectRetryOOM.storm="
        f"{LADDER_STORM}: rungs {counts}, ladderCpuFallback {fell}, "
        f"{secs * 1e3:.3f} ms, rows equal the oracle (max rel err "
        f"{rel:.3e})")
    return {"rungs": counts, "ladderCpuFallback": fell, "ms": secs * 1e3}


def _deadline(device, paths, spill_root):
    """q97 under the memory conf (budget and a cut host tier) and a
    deadline it cannot meet: QueryCancelled(reason="deadline") mid-run,
    then no catalog entry, no ledger byte, no spill file, and
    memory_allocated() back within CANCEL_MARGIN_BYTES."""
    import gc
    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.exec.base import ExecCtx
    from spark_rapids_tpu_torch.lifecycle import QueryCancelled
    from spark_rapids_tpu_torch.tools import nds_memory as nm
    conf = dict(nm.conf_for("q_sales_sorted", nm.CHIP_BUDGET))
    conf.update({"spark.sql.shuffle.partitions": "1",
                 "spark.rapids.memory.spillDir": spill_root,
                 "spark.rapids.query.deadline": str(DEADLINE_S)})
    s = nds.session_over_files(paths, conf, device)
    pp = _apply(s.conf, device, s.sql(nds.SQL_QUERIES["q97"])._node,
                "nds-memory")
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    ctx = ExecCtx(s.conf, device)
    t = time.perf_counter()
    try:
        pp.collect(ctx)
    except QueryCancelled as e:
        reason = e.reason
    else:
        raise AssertionError(f"q97 finished inside a {DEADLINE_S} s "
                             "deadline")
    secs = time.perf_counter() - t
    rows_read = _op_metric(_metrics(ctx), "FileScanExec", "numOutputRows")
    gc.collect()
    time.sleep(0.2)  # the scan's feeder lets go of what it held
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    mm = ctx.mm
    files = []
    if os.path.isdir(mm.spill_dir):
        for _, _, names in os.walk(mm.spill_dir):
            files += names
    report = mm.leak_report()
    ok = (reason == "deadline" and rows_read > 0
          and report == "no leaked catalog entries"
          and mm.device_bytes == 0 and not files
          and after - before <= CANCEL_MARGIN_BYTES)
    out = {"reason": reason, "ms": secs * 1e3, "rows_read": rows_read,
           "leak_report": report, "ledger_device_bytes": mm.device_bytes,
           "spill_files": len(files), "allocated_before": before,
           "allocated_after": after}
    log(f"[nds-memory] deadline: q97 cancelled [{reason}] after "
        f"{secs * 1e3:.3f} ms with {rows_read} rows scanned; leak report "
        f"{report!r}, ledger device bytes {mm.device_bytes}, spill files "
        f"{len(files)}, memory_allocated {before} -> {after} (margin "
        f"{CANCEL_MARGIN_BYTES})")
    if not ok:
        raise AssertionError(f"deadline: {out}")
    return out


def _find_node(root, label):
    stack = [root]
    while stack:
        n = stack.pop()
        if n.node_label() == label:
            return n
        stack.extend(n.children)
    raise AssertionError(f"no node {label}")


def _plan_under_budget(session, device, node, q, parts):
    """Plan a memory text under its cut budget with the verifier on. A
    refusal must name only ``hbm_over_budget``, each on a node whose
    ``resident_footprint()`` holds; the text is then planned with
    spark.rapids.sql.verifyPlan=false, as the reference's run would be.
    Returns the plan and the verdict (printed)."""
    from spark_rapids_tpu_torch.analysis.plan_verifier import (
        PlanVerificationError, verify_plan)
    from spark_rapids_tpu_torch.config import VERIFY_PLAN
    try:
        pp = _apply(session.conf, device, node, "nds-memory")
        rep = pp.verify_report
    except PlanVerificationError as e:
        rep = e.report
        pp = _apply(session.conf.with_settings({VERIFY_PLAN.key: "false"}),
                    device, node, "nds-memory", verify=False)
        # the same pass over the plan that runs, to find its nodes
        again = verify_plan(pp.root, session.conf, device)
        if rep.reasons() != ["hbm_over_budget"] \
                or again.reasons() != ["hbm_over_budget"] \
                or not all(_find_node(pp.root, v.op).resident_footprint()
                           for v in again.violations):
            raise AssertionError(f"{q} p{parts}: refused for "
                                 f"{rep.summary()}")
    verdict = {"ok": rep.ok, "reasons": rep.reasons(),
               "violations": [v.to_dict() for v in rep.violations],
               "hbm_estimate_bytes": rep.hbm_estimate_bytes,
               "hbm_budget_bytes": rep.hbm_budget_bytes}
    log(f"[nds-memory] {q} partitions={parts} verifier under the "
        f"{rep.hbm_budget_bytes}-byte budget: "
        + ("verified clean" if rep.ok else
           f"refused {rep.reasons()} ({rep.summary()}); run with "
           "spark.rapids.sql.verifyPlan=false")
        + f"; estimate {rep.hbm_estimate_bytes} bytes")
    return pp, verdict


def phase_nds_memory(device, files, skew_witness=None):
    """Phase 11 (module docstring): the memory texts under their budgets
    at 1 and 16 partitions beside the default budget, a real OOM, the
    ladder and a deadline."""
    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.exec.base import ExecCtx
    from spark_rapids_tpu_torch.tools import nds_memory as nm
    from spark_rapids_tpu_torch.tools.nds_trace import counters

    tables, paths, _ = files
    t_phase = time.perf_counter()
    spill_root = os.path.join(ROOT, ".bench_cache", "spill_torch")
    crc = _crc_timing()
    wrappers = counters()
    summary, launches, sites_seen = {}, {}, set()
    for q, want in _corpus_oracles(nm, tables).items():
        ORACLES.setdefault((nm.oracle, q), want)
    for q in nm.QUERIES:
        want = _oracle(nm.oracle, q, tables)
        for parts in nm.PARTITIONS[q]:
            base = {"spark.sql.shuffle.partitions": str(parts),
                    "spark.rapids.memory.spillDir": spill_root}
            s0 = nds.session_over_files(paths, base, device)
            sb = nds.session_over_files(paths, dict(base, **nm.CONF[q]),
                                        device)
            pp0 = _apply(s0.conf, device, s0.sql(nm.SQL_QUERIES[q])._node,
                         "nds-memory")
            pp, verdict = _plan_under_budget(
                sb, device, sb.sql(nm.SQL_QUERIES[q])._node, q, parts)
            # the default budget first (it warms the text up), then the
            # cut budget, counted
            ctx0 = ExecCtx(s0.conf, device)
            spilled0 = ctx0.mm.spill_bytes
            t = time.perf_counter()
            free = pp0.collect(ctx0)
            torch.cuda.synchronize()
            free_s = time.perf_counter() - t
            if ctx0.mm.spill_bytes != spilled0:
                raise AssertionError(f"{q}: spilled at the default budget")
            ctx = ExecCtx(sb.conf, device)
            mem0 = _memory_figures(ctx.mm)
            recs, restore = _spill_probe()
            for c in wrappers.values():
                c.launches = 0
            try:
                t = time.perf_counter()
                out = pp.collect(ctx)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t
            finally:
                restore()
            got = {k: c.launches for k, c in wrappers.items()}
            mem = _delta(_memory_figures(ctx.mm), mem0)
            metrics = _metrics(ctx)
            rel = _rows_equal(q, out, want, nm.FLOAT_COLUMNS[q])
            _rows_equal(q, free, want, nm.FLOAT_COLUMNS[q])
            fig = _mechanism(q, parts, metrics, mem)
            by_site = _spill_shares(recs)
            low = [(site, round(f / c, 4)) for site, _, f, c in recs
                   if c and f / c < SPILL_FREED_SHARES.get(site, 0.0)]
            if low:
                raise AssertionError(f"{q} p{parts}: spills freed less "
                                     f"than their site's share: {low}")
            sites_seen.update(site for site, _, _, c in recs if c)
            skewed = _op_metric(metrics, "AQEShuffleReadExec",
                                "numSkewedPartitions")
            splits = _op_metric(metrics, "AQEShuffleReadExec",
                                "numSkewSplits")
            if skewed and not splits:
                raise AssertionError(f"{q} p{parts}: {skewed} skewed "
                                     "partitions, no split")
            leak = ctx.mm.leak_report()
            if leak != "no leaked catalog entries" or ctx.mm.device_bytes:
                raise AssertionError(f"{q} p{parts}: {leak}; ledger "
                                     f"{ctx.mm.device_bytes} bytes")
            key = f"{q}_p{parts}"
            summary[key] = {"ms": secs * 1e3, "default_budget_ms":
                            free_s * 1e3, "max_rel_err": rel,
                            "verdict": verdict,
                            "budget_bytes": nm.CHIP_BUDGET, "figures": fig,
                            "ledger": mem, "skewed_partitions": skewed,
                            "skew_splits": splits,
                            "spills_probed": len(recs),
                            "spill_freed_shares": by_site}
            launches[key] = got
            log(f"[nds-memory] {q} partitions={parts}: {secs * 1e3:.3f} ms "
                f"under a {nm.CHIP_BUDGET}-byte budget, "
                f"{free_s * 1e3:.3f} ms at the default; {out.num_rows} rows "
                f"equal to the oracle (max rel err {rel:.3e}); figures "
                f"{fig}; ledger {mem}; skewed partitions {skewed}, skew "
                f"splits {splits}; launches {got}")
            log(f"[nds-memory] {q} partitions={parts} spills freed, as a "
                "share of the bytes credited, by site: "
                + json.dumps(by_site, sort_keys=True))
    missing = set(SPILL_FREED_SHARES) - sites_seen
    if missing:
        raise AssertionError(f"no spill of an entry from {missing}")
    log("[nds-memory] every spill from "
        + ", ".join(f"{k} freed at least {v}" for k, v in
                    sorted(SPILL_FREED_SHARES.items()))
        + " of the bytes the ledger credited in memory_allocated()")
    if not any(v["skewed_partitions"] for v in summary.values()
               if "skewed_partitions" in v):
        log("[nds-memory] no text of this phase trips the skew rule; the "
            "skew split's witness on the card is phase 10's "
            f"{SKEW_WITNESS}"
            + (f" ({skew_witness['skewed_partitions']} skewed partition(s)"
               f", {skew_witness['skew_splits']} splits)"
               if skew_witness else " (not run with --memory-only)")
            + ", and the CPU tests hold it to the reference "
            "(tests/test_torch_out_of_core.py)")
    summary["real_oom"] = _real_oom(device, paths, tables)
    summary["ladder"] = _ladder(device, paths, tables)
    summary["deadline"] = _deadline(device, paths, spill_root)
    summary["verifier"] = _log_verifier("nds-memory")
    summary["crc32c"] = crc
    summary["spill_freed_share_floors"] = SPILL_FREED_SHARES
    log(f"[nds-memory] phase took {time.perf_counter() - t_phase:.3f} s")
    return summary, launches


# --- phase 12: per-operator metrics ------------------------------------------

#: the texts phase 12 analyses, by corpus module name
OPM_QUERIES = (("q3", "nds"), ("q97", "nds"), ("q_rank", "nds"),
               ("q_full_halves", "nds_joins"),
               ("q_outer_price", "nds_fallback"))


def _corpus_module(name):
    import importlib
    if name == "nds":
        return importlib.import_module("spark_rapids_tpu_torch.nds")
    return importlib.import_module(f"spark_rapids_tpu_torch.tools.{name}")


def _preorder(root):
    """Every node once, pre-order (an aliased subtree once)."""
    out, seen = [], set()

    def walk(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        out.append(n)
        for c in n.children:
            walk(c)

    walk(root)
    return out


def _placement(root, root_on_device):
    """Each node's side: on the device, or in a CPU island (the
    transitions switch it)."""
    from spark_rapids_tpu_torch.exec.transitions import (DeviceToHostExec,
                                                         HostToDeviceExec)
    side = {}

    def walk(node, on_device):
        side[id(node)] = on_device
        if isinstance(node, DeviceToHostExec):
            on_device = True
        elif isinstance(node, HostToDeviceExec):
            on_device = False
        for c in node.children:
            walk(c, on_device)

    walk(root, root_on_device)
    return side


def _sync_calls(run):
    """``run()`` under torch.cuda.set_sync_debug_mode("warn"): its result
    and how many synchronizing calls it made."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n = sum("synchronizing CUDA operation" in str(w.message) for w in seen)
    return out, n


def _check_analyzed(q, parts, pp, ctx, out, files, card):
    """Phase 12's assertions on one analysed run (module docstring)."""
    import re

    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.obs.opmetrics import (fold_ctx,
                                                      read_profiles,
                                                      top_op_sinks)
    _, paths, _ = files
    folded = fold_ctx(ctx)
    nodes = _preorder(pp.root)
    ids = [n._op_id for n in nodes]
    if len(set(ids)) != len(ids) or None in ids:
        raise AssertionError(f"{q} p{parts}: op ids {ids}")
    text = pp.explain_analyze()
    if sorted(set(int(i) for i in re.findall(r"\(op(\d+)\)", text))) \
            != sorted(ids):
        raise AssertionError(f"{q} p{parts}: EXPLAIN ANALYZE ids\n{text}")

    def metrics(n):
        return folded.get(f"op{n._op_id}", {}).get("metrics", {})

    if metrics(pp.root).get("rows") != out.num_rows:
        raise AssertionError(f"{q} p{parts}: root rows "
                             f"{metrics(pp.root).get('rows')}, result "
                             f"{out.num_rows}")
    uses = _node_uses(pp.root)
    for n in nodes:
        if n.pretty_name() == "FileScanExec":
            want = uses[id(n)] * sum(pq.ParquetFile(p).metadata.num_rows
                                     for p in n.paths)
            if metrics(n).get("rows") != want:
                raise AssertionError(f"{q} p{parts}: {n.node_label()} rows "
                                     f"{metrics(n).get('rows')}, files "
                                     f"{want}")
    side = _placement(pp.root, pp.root_on_device)
    for n in nodes:
        flagged = metrics(n).get("cpuFallback") == 1
        if flagged == side[id(n)] and metrics(n).get("batches"):
            raise AssertionError(f"{q} p{parts}: {n.node_label()} on the "
                                 f"{'device' if side[id(n)] else 'CPU'}, "
                                 f"cpuFallback {flagged}")
    island = [n.node_label() for n in nodes if not side[id(n)]]
    stamps = dict(ctx.opm.stamps)
    if stamps["wall"] or stamps["wedged"] or not stamps["event"]:
        raise AssertionError(f"{q} p{parts}: stage stamps {stamps}")
    stage_op = sum(metrics(n).get("opTime", 0.0) for n in nodes
                   if "dispatchTime" in metrics(n))
    stage_disp = sum(metrics(n).get("dispatchTime", 0.0) for n in nodes)
    if not stage_op >= stage_disp > 0:
        raise AssertionError(f"{q} p{parts}: fused stages' opTime "
                             f"{stage_op}, dispatchTime {stage_disp}")
    profiles = read_profiles(pp.conf.get("spark.rapids.history.dir"))
    if len(profiles) != 1 or profiles[0][1]["device_kind"] != card \
            or profiles[0][0] != pp.last_profile_path:
        raise AssertionError(f"{q} p{parts}: profiles "
                             f"{[(p, d['device_kind']) for p, d in profiles]}")
    top = top_op_sinks(folded, 3)
    return {"stamps": stamps, "stage_op_ms": stage_op * 1e3,
            "stage_dispatch_ms": stage_disp * 1e3, "island": island,
            "top": top, "nodes": len(nodes), "text": text}


def phase_opmetrics(device, files, card, smi, nds_summary):
    """Phase 12 (module docstring)."""
    import tempfile
    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.exec.base import ExecCtx
    from spark_rapids_tpu_torch.obs.opmetrics import OP_METRICS_ENABLED
    tables, paths, _ = files
    t_phase = time.perf_counter()
    summary = {}
    for q, corpus_name in OPM_QUERIES:
        corpus = _corpus_module(corpus_name)
        want = ORACLES.get((corpus.oracle, q))
        if want is None:
            want = corpus.oracle(q, tables)
        for parts in (1, 16):
            conf = dict(getattr(corpus, "CONF", {}).get(q, {}))
            conf["spark.sql.shuffle.partitions"] = str(parts)
            with tempfile.TemporaryDirectory() as hist:
                s = nds.session_over_files(
                    paths, dict(conf, **{"spark.rapids.history.dir": hist}),
                    device)
                pp = _apply(s.conf, device,
                            s.sql(corpus.SQL_QUERIES[q])._node, "opm")
                ctx = ExecCtx(s.conf, device)
                t = time.perf_counter()
                out, n_on = _sync_calls(lambda: pp.collect(ctx))
                secs = time.perf_counter() - t
                rel = _rows_equal(q, out, want, corpus.FLOAT_COLUMNS[q])
                rec = _check_analyzed(q, parts, pp, ctx, out, files, card)
            s_off = nds.session_over_files(
                paths, dict(conf, **{OP_METRICS_ENABLED.key: "false"}),
                device)
            pp_off = _apply(s_off.conf, device,
                            s_off.sql(corpus.SQL_QUERIES[q])._node, "opm")
            ctx_off = ExecCtx(s_off.conf, device)
            out_off, n_off = _sync_calls(lambda: pp_off.collect(ctx_off))
            _rows_equal(q, out_off, want, corpus.FLOAT_COLUMNS[q])
            if n_on != n_off or [k for ms in ctx_off.metrics.values()
                                 for k in ms if k in ("rows", "batches")]:
                raise AssertionError(f"{q} p{parts}: {n_on} synchronizing "
                                     f"calls with op metrics on, {n_off} "
                                     "off")
            text = rec.pop("text")
            log(f"[opm] {q} partitions={parts}: EXPLAIN ANALYZE "
                f"({secs * 1e3:.3f} ms in collect with the sync debug "
                f"mode on; rows equal to the oracle, max rel err "
                f"{rel:.3e}):\n" + text)
            top = ", ".join(f"{t['op']} {t['time_s'] * 1e3:.3f} ms "
                            f"({t['rows']} rows)" for t in rec["top"])
            log(f"[opm] {q} partitions={parts}: top operators by opTime: "
                f"{top}; fused stages' opTime {rec['stage_op_ms']:.3f} ms, "
                f"dispatchTime {rec['stage_dispatch_ms']:.3f} ms; stage "
                f"stamps {rec['stamps']}; CPU island {rec['island']}; "
                f"synchronizing calls {n_on} with op metrics on, {n_off} "
                f"off; one profile, device_kind {card!r}")
            summary[f"{q}_p{parts}"] = dict(
                rec, ms_sync_debug=secs * 1e3, sync_calls_on=n_on,
                sync_calls_off=n_off, max_rel_err=rel)
    if nds_summary is not None:
        onoff = {q: (nds_summary[f"{q}_p1"]["ms"],
                     nds_summary[f"{q}_p1"]["ms_opm_off"])
                 for q in nds.PORTED_QUERIES}
        on_total = sum(a for a, _ in onoff.values())
        off_total = sum(b for _, b in onoff.values())
        log(f"[opm] phase 8 at 1 partition, ms a query in collect with "
            f"spark.rapids.metrics.op.enabled on (median of 2) / off (one "
            f"run, after the first timed run), on {card} ({smi}): "
            + ", ".join(f"{q} {a:.3f} / {b:.3f}"
                        for q, (a, b) in onoff.items())
            + f"; summed {on_total:.3f} / {off_total:.3f}")
        summary["phase8_ms_on_off"] = onoff
    summary["verifier"] = _log_verifier("opm")
    log(f"[opm] phase took {time.perf_counter() - t_phase:.3f} s")
    return summary


# --- phase 13: the SQL function registry -------------------------------------

#: the texts phase 13 traces (device busy time, top device operations)
FUNCTIONS_TRACED = ("q_fn_strings", "q_fn_casts")


def phase_functions(device, files, card, smi):
    """The ten function texts at 1 and 16 partitions (module docstring,
    phase 13)."""
    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.exec.base import ExecCtx
    from spark_rapids_tpu_torch.tools import nds_functions as fn
    from spark_rapids_tpu_torch.tools.nds_trace import counters

    tables, paths, _ = files
    t_phase = time.perf_counter()
    wrappers = counters()
    summary, launches = {}, {}
    oracles = _corpus_oracles(fn, tables)
    for q in fn.QUERIES:
        want = oracles[q]
        for parts in (1, 16):
            conf = {"spark.sql.shuffle.partitions": str(parts)}
            s = nds.session_over_files(paths, conf, device)
            pp = _apply(s.conf, device, s.sql(fn.SQL_QUERIES[q])._node,
                        "functions")
            out, times, ctx, got = _counted_runs(
                pp, lambda: ExecCtx(s.conf, device), wrappers.values(),
                placed=fn.FALLBACK[q], warm=parts == 1, timed=1)
            fn.check(q, out, tables, want)
            med = statistics.median(times)
            got = {k: got[c.__name__] for k, c in wrappers.items()}
            summary[f"{q}_p{parts}"] = {
                "ms": med * 1e3, "times_s": times, "rows": out.num_rows,
                "launches": got, "fallback_nodes": pp.fallback_nodes()}
            launches[f"{q}_p{parts}"] = got
            log(f"[functions] {q} partitions={parts}: {med * 1e3:.3f} ms a "
                f"query in collect ({[round(t, 6) for t in times]} s) on "
                f"{card} ({smi}); "
                f"{out.num_rows} rows equal to the oracle; launches {got}; "
                f"on the CPU {pp.fallback_nodes()}")
    summary["verifier"] = _log_verifier("functions")
    took = time.perf_counter() - t_phase
    log(f"[functions] phase took {took:.3f} s (its traces apart)")
    summary["phase_s"] = took
    return summary, launches


def phase_function_traces(card, smi, summary):
    """Phase 13's traces of ``FUNCTIONS_TRACED``, each in a process of
    its own (``_trace_query``)."""
    t0 = time.perf_counter()
    for q in FUNCTIONS_TRACED:
        tr = _trace_query(q)
        top = dict(list(tr["top_device_ops"].items())[:5])
        summary[f"trace_{q}"] = {
            "device_busy_us": tr["device_busy_us"], "wall_us": tr["wall_us"],
            "device_idle_share": tr["device_idle_share"],
            "top_device_ops": top, "kernels": tr["kernels"]}
        log(f"[functions] trace {q} partitions=1 on {card} ({smi}): device "
            f"busy {tr['device_busy_us']:.1f} us of {tr['wall_us']:.1f} us "
            f"(idle share {tr['device_idle_share']:.4f}); top device ops "
            + json.dumps(top, sort_keys=True))
    took = time.perf_counter() - t0
    log(f"[functions] traces took {took:.3f} s; phase 13 in all "
        f"{summary['phase_s'] + took:.3f} s")


# --- phase 14: decimals -----------------------------------------------------

#: the decimal text phase 14 traces
DECIMALS_TRACED = "q_dec_arith"


def _decimal_files():
    """The decimal NDS tables at ``NDS_SALES`` rows, their files (written
    once, as Spark writes decimals), and each file's chunks."""
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.tools import nds_decimals as nd
    from spark_rapids_tpu_torch.tools.nds_trace import decimal_paths

    t0 = time.perf_counter()
    tables = nd.decimal_tables(nds.gen_tables(NDS_SALES))
    paths = decimal_paths(NDS_SALES, tables)
    log(f"[decimals] {NDS_SALES} store_sales rows with DECIMAL(7,2) money "
        f"columns: tables and files ready in "
        f"{time.perf_counter() - t0:.3f} s")
    chunks = {}
    for p in paths.values():
        md = pq.ParquetFile(p).metadata
        chunks[p] = md.num_row_groups * md.num_columns
    return tables, paths, chunks


def phase_decimals(device, card, smi):
    """The decimal texts at 1 and 16 partitions (module docstring, phase
    14); a text with a CPU island runs without a warm-up."""
    from spark_rapids_tpu_torch.tools import nds_decimals as nd

    t_phase = time.perf_counter()
    files = _decimal_files()
    summary, launches = _run_sql_queries(
        device, "decimals", nd, files, timed=(1, 1), warm=(True, False),
        cold=[q for q in nd.QUERIES if nd.FALLBACK[q]])
    for k, v in summary.items():
        if k != "verifier":
            log(f"[decimals] {k}: {v['ms']:.3f} ms a query on {card} "
                f"({smi})")
    took = time.perf_counter() - t_phase
    log(f"[decimals] phase took {took:.3f} s (its trace apart)")
    summary["phase_s"] = took
    return summary, launches


def phase_decimal_trace(card, smi, summary):
    """Phase 14's trace of ``DECIMALS_TRACED``, in a process of its own
    (``_trace_query``)."""
    t0 = time.perf_counter()
    tr = _trace_query(DECIMALS_TRACED, decimals=True)
    top = dict(list(tr["top_device_ops"].items())[:5])
    summary[f"trace_{DECIMALS_TRACED}"] = {
        "device_busy_us": tr["device_busy_us"], "wall_us": tr["wall_us"],
        "device_idle_share": tr["device_idle_share"],
        "top_device_ops": top, "kernels": tr["kernels"]}
    log(f"[decimals] trace {DECIMALS_TRACED} partitions=1 on {card} "
        f"({smi}): device busy {tr['device_busy_us']:.1f} us of "
        f"{tr['wall_us']:.1f} us (idle share "
        f"{tr['device_idle_share']:.4f}); top device ops "
        + json.dumps(top, sort_keys=True))
    log(f"[decimals] trace took {time.perf_counter() - t0:.3f} s")


def _nested_files():
    """The NDS tables with ``ticket`` at ``NDS_SALES`` rows, their files
    (row groups of 2^16), and each file's chunks: ``(flat columns, nested
    columns) x row groups`` for a file with a nested column."""
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.tools import nds_nested as nn
    from spark_rapids_tpu_torch.tools.nds_trace import nested_paths

    t0 = time.perf_counter()
    tables = nn.nested_tables(nds.gen_tables(NDS_SALES))
    paths = nested_paths(NDS_SALES, tables)
    log(f"[nested] {NDS_SALES} store_sales rows, "
        f"{tables['ticket'].num_rows} tickets: tables and files ready in "
        f"{time.perf_counter() - t0:.3f} s")
    chunks = {}
    for name, p in paths.items():
        groups = pq.ParquetFile(p).metadata.num_row_groups
        nested = nn.nested_columns(tables[name])
        flat = tables[name].num_columns - nested
        chunks[p] = (groups * flat, groups * nested) if nested \
            else groups * flat
    return tables, paths, chunks


def phase_nested(device, card, smi):
    """The nested texts at 1 and 16 partitions (module docstring, phase
    16); a text with a CPU island runs without a warm-up."""
    from spark_rapids_tpu_torch.tools import nds_nested as nn

    t_phase = time.perf_counter()
    files = _nested_files()
    summary, launches = _run_sql_queries(
        device, "nested", nn, files, timed=(1, 1), warm=(True, False),
        cold=[q for q in nn.QUERIES if nn.FALLBACK[q]])
    for k, v in summary.items():
        if k != "verifier":
            log(f"[nested] {k}: {v['ms']:.3f} ms a query on {card} "
                f"({smi})")
    took = time.perf_counter() - t_phase
    log(f"[nested] phase took {took:.3f} s (its trace apart)")
    summary["phase_s"] = took
    return summary, launches


def phase_nested_trace(card, smi, summary):
    """Phase 16's trace of ``NESTED_TRACED``, in a process of its own."""
    t0 = time.perf_counter()
    tr = _traced_apart(
        ["-m", "spark_rapids_tpu_torch.tools.nds_trace", "--query",
         NESTED_TRACED, "--partitions", "1", "--n-sales", str(NDS_SALES),
         "--nested"])
    top = dict(list(tr["top_device_ops"].items())[:5])
    summary[f"trace_{NESTED_TRACED}"] = {
        "device_busy_us": tr["device_busy_us"], "wall_us": tr["wall_us"],
        "device_idle_share": tr["device_idle_share"],
        "top_device_ops": top, "kernels": tr["kernels"]}
    log(f"[nested] trace {NESTED_TRACED} partitions=1 on {card} ({smi}): "
        f"device busy {tr['device_busy_us']:.1f} us of "
        f"{tr['wall_us']:.1f} us (idle share "
        f"{tr['device_idle_share']:.4f}); top device ops "
        + json.dumps(top, sort_keys=True) + "; kernels "
        + json.dumps(tr["kernels"], sort_keys=True))
    log(f"[nested] trace took {time.perf_counter() - t0:.3f} s")


# --- phase 17: telemetry ----------------------------------------------------

#: phase 17's NDS texts; q_like_intl holds a CPU island (nds_fallback)
TELEMETRY_TEXTS = ("q3", "q_rank", "q97", "q_like_intl")
#: interleaved off/on pairs of the telemetry's cost
TELEMETRY_PAIRS = 5


def _sample(name, label=""):
    """One series of the port's registry: a counter's or gauge's value,
    a histogram's count."""
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    fam = REGISTRY.snapshot().get(name)
    if fam is None:
        return 0
    v = fam["samples"].get(label, 0)
    return v["count"] if isinstance(v, dict) else v


def _telemetry_dirs(tag):
    """Fresh warehouse, event-log and trace directories under
    ``.bench_cache/telemetry_torch/<tag>/``, and the conf that turns the
    three sinks on."""
    import shutil
    base = os.path.join(ROOT, ".bench_cache", "telemetry_torch", tag)
    shutil.rmtree(base, ignore_errors=True)
    d = {k: os.path.join(base, k) for k in ("warehouse", "events", "trace")}
    return d, {"spark.rapids.warehouse.dir": d["warehouse"],
               "spark.rapids.eventLog.dir": d["events"],
               "spark.rapids.trace.dir": d["trace"]}


def _telemetry_nds(device, card, smi, files):
    """The four texts twice at 1 partition and once at 16, every sink
    on: rows against the oracle, one warehouse row a collect (the card's
    ``device_kind``, its outcome, its per-operator rows the folded op
    metrics), one trace with one ``query`` span and every operator id,
    one event-log line; then ``drift_report`` over the runs."""
    from types import SimpleNamespace
    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.exec.base import ExecCtx
    from spark_rapids_tpu_torch.obs import warehouse
    from spark_rapids_tpu_torch.obs.opmetrics import fold_ctx
    from spark_rapids_tpu_torch.tools import nds_fallback as fb
    from spark_rapids_tpu_torch.obs.tracer import load_chrome_trace
    from spark_rapids_tpu_torch.tools.event_log import read_event_logs
    from spark_rapids_tpu_torch.tools.telemetry_q6 import (plan_op_ids,
                                                           traced_op_ids)
    tables, paths, chunks = files
    dirs, sinks = _telemetry_dirs("nds")
    corpus = SimpleNamespace(SQL_QUERIES=nds.SQL_QUERIES, CONF={},
                             FLOAT_COLUMNS=nds.FLOAT_COLUMNS,
                             oracle=nds.oracle)
    out_rows = {}
    for q in TELEMETRY_TEXTS:
        c = fb if q in fb.SQL_QUERIES else corpus
        want = _oracle(c.oracle, q, tables)
        # two runs at 1 partition (the drift report's pair), one at 16
        for parts, n_runs in ((1, 2), (16, 1)):
            conf = dict(c.CONF.get(q, {}), **sinks)
            conf["spark.sql.shuffle.partitions"] = str(parts)
            s = nds.session_over_files(paths, conf, device)
            for run in range(n_runs):
                pp = _apply(s.conf, device, s.sql(c.SQL_QUERIES[q])._node,
                            "telemetry")
                n_rows = len(warehouse.read_rows(dirs["warehouse"]))
                traces = set(os.listdir(dirs["trace"])) \
                    if os.path.isdir(dirs["trace"]) else set()
                ctx = ExecCtx(s.conf, device)
                t = time.perf_counter()
                out = pp.collect(ctx)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t
                metrics = _metrics(ctx)
                _check_nds(q, out, want, metrics,
                           _scan_chunks_needed(pp.root, chunks,
                                               pp.root_on_device),
                           c.FLOAT_COLUMNS[q])
                rows = warehouse.read_rows(dirs["warehouse"])
                if len(rows) != n_rows + 1:
                    raise AssertionError(f"{q} p{parts}: {len(rows)} "
                                         f"warehouse rows after {n_rows}")
                row = rows[-1]
                outcome = "degraded" if pp.fallback_nodes() else "completed"
                folded = {k: int(st["metrics"].get("rows", 0))
                          for k, st in fold_ctx(ctx).items()}
                ops = {k: v["rows"] for k, v in row["ops"].items()}
                (new,) = set(os.listdir(dirs["trace"])) - traces
                n_query, ran = traced_op_ids(load_chrome_trace(
                    os.path.join(dirs["trace"], new)))
                bad = [msg for ok, msg in (
                    (row["device_kind"] == card, "device_kind"),
                    (row["outcome"] == outcome, "outcome"),
                    (ops == folded, "per-operator rows"),
                    (n_query == 1, "query spans"),
                    (ran == plan_op_ids(pp.root), "op spans")) if not ok]
                if bad:
                    raise AssertionError(
                        f"{q} p{parts}: {bad}: row {row['device_kind']!r} "
                        f"{row['outcome']!r} ops {ops} folded {folded}; "
                        f"{n_query} query spans, ran {sorted(ran)} of "
                        f"{sorted(plan_op_ids(pp.root))}")
                out_rows[f"{q}_p{parts}_run{run}"] = {
                    "ms": secs * 1e3, "outcome": row["outcome"],
                    "fallback_reasons": row["fallback_reasons"],
                    "scan": row["scan"], "fingerprint": row["fingerprint"]}
                log(f"[telemetry] {q} partitions={parts} run {run}: "
                    f"{secs * 1e3:.3f} ms on {card} ({smi}), rows equal to "
                    f"the oracle; warehouse row {row['outcome']} on "
                    f"{row['device_kind']!r}, {len(ops)} operators' rows "
                    f"equal the folded op metrics, scan {row['scan']}; "
                    f"trace: 1 query span, {len(ran)} operator ids")
    lines = list(read_event_logs(dirs["events"]))
    n_runs = len(TELEMETRY_TEXTS) * 3
    if [e.get("type", "query") for e in lines] != ["query"] * n_runs:
        raise AssertionError(f"event log: {len(lines)} lines for "
                             f"{n_runs} collects")
    report, rc = warehouse.drift_report(dirs["warehouse"])
    log("[telemetry] drift over two runs of each text: rc "
        f"{rc}; " + report.replace("\n", " | "))
    if rc != 0:
        raise AssertionError(f"drift_report rc {rc}: {report}")
    return {"runs": out_rows, "drift_rc": rc}


def _telemetry_memory(device, files):
    """q_sales_sorted under 64 MiB with its first two disk writes
    refused (``injectDiskFull=2``) and q3 under injectRetryOOM, every
    sink on:
    the registry's spill and OOM-retry deltas equal the manager's
    attributes, the event log holds the query lines and the refused
    write's ``disk_pressure`` line, and the flight ring's memory timeline
    is not empty and ends with the ledger empty (its high water, printed
    beside the budget, counts the scan's pinned in-flight blobs)."""
    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.exec.base import ExecCtx
    from spark_rapids_tpu_torch.obs.recorder import RECORDER, memory_timeline
    from spark_rapids_tpu_torch.tools import nds_memory as nm
    from spark_rapids_tpu_torch.tools.event_log import read_event_logs
    tables, paths, _ = files
    fams = {"rapids_memory_spill_bytes_total": "spill_bytes",
            "rapids_memory_disk_spill_bytes_total": "disk_spill_bytes",
            "rapids_spill_read_bytes_total": "spill_read_bytes",
            "rapids_memory_oom_retries_total": "oom_retries"}
    spill_root = os.path.join(ROOT, ".bench_cache", "spill_torch")
    out = {}
    for case, q, extra in (
            # the first two disk writes refused: a disk_pressure line
            ("budget", "q_sales_sorted",
             {"spark.rapids.memory.test.injectDiskFull": "2"}),
            ("oom_retry", "q3",
             {"spark.rapids.sql.test.injectRetryOOM": "3"})):
        dirs, sinks = _telemetry_dirs(f"memory_{case}")
        conf = dict(nm.CONF[q] if case != "oom_retry" else {}, **sinks,
                    **extra)
        conf.update({"spark.sql.shuffle.partitions": "1",
                     "spark.rapids.memory.spillDir": spill_root})
        s = nds.session_over_files(paths, conf, device)
        pp = _apply(s.conf, device, s.sql(nm.SQL_QUERIES[q])._node,
                    "telemetry")
        ctx = ExecCtx(s.conf, device)
        before = {f: _sample(f) for f in fams}
        attrs = {a: getattr(ctx.mm, a) for a in fams.values()}
        enospc = _sample("rapids_spill_write_failures_total", "enospc")
        t0 = time.time()
        t = time.perf_counter()
        got = pp.collect(ctx)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        oracle = _oracle(nm.oracle, q, tables)
        floats = nm.FLOAT_COLUMNS[q]
        _rows_equal(q, got, oracle, floats)
        deltas = {a: _sample(f) - before[f] for f, a in fams.items()}
        moved = {a: getattr(ctx.mm, a) - v for a, v in attrs.items()}
        lines = [e.get("type", "query")
                 for e in read_event_logs(dirs["events"])]
        tl = memory_timeline([e for e in RECORDER.snapshot(since=t0)
                              if e.get("budget") == ctx.mm.budget])
        rec = {"ms": secs * 1e3, "registry_deltas": deltas,
               "manager_deltas": moved, "event_lines": lines,
               "timeline_events": len(tl["events"]),
               "high_water_bytes": tl["high_water_bytes"],
               "budget_bytes": ctx.mm.budget,
               "enospc": _sample("rapids_spill_write_failures_total",
                                 "enospc") - enospc}
        need = {"budget": moved["spill_bytes"] > 0
                and moved["disk_spill_bytes"] > 0
                and lines == ["disk_pressure", "query"]
                and rec["enospc"] == ctx.mm.spill_write_failures.get(
                    "enospc", 0) == 1,
                "oom_retry": moved["oom_retries"] >= 1
                and lines == ["query"]}[case]
        # the ledger charges the scan's pinned in-flight blobs, which it
        # cannot evict, so its high water may pass the budget (printed);
        # every byte is released by the query's end
        ok = (need and deltas == moved and tl["events"]
              and tl["high_water_bytes"] > 0
              and tl["events"][-1]["device"] == 0 == ctx.mm.device_bytes)
        log(f"[telemetry] memory {case}: {q} {secs * 1e3:.3f} ms, rows "
            f"equal to the oracle; registry deltas {deltas}, the "
            f"manager's {moved}; event log {lines}; flight timeline "
            f"{len(tl['events'])} events, high water "
            f"{tl['high_water_bytes']} of {ctx.mm.budget} B")
        if not ok:
            raise AssertionError(f"memory {case}: {rec}")
        out[case] = rec
    return out


def _telemetry_refusals(device, files):
    """A deadline that cancels q97 and a plan the verifier refuses, every
    sink on: the cancelled query's warehouse row, counter, flight events
    and event-log line; the refusal's flight event and line."""
    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.analysis.plan_verifier import \
        PlanVerificationError
    from spark_rapids_tpu_torch.exec.aqe import GpuAQEShuffleReadExec
    from spark_rapids_tpu_torch.exec.base import ExecCtx, \
        HostBatchSourceExec
    from spark_rapids_tpu_torch.exec.exchange import GpuShuffleExchangeExec
    from spark_rapids_tpu_torch.lifecycle import QueryCancelled
    from spark_rapids_tpu_torch.obs import warehouse
    from spark_rapids_tpu_torch.obs.recorder import RECORDER
    from spark_rapids_tpu_torch.planner import GpuOverrides
    from spark_rapids_tpu_torch.shuffle.partitioner import \
        SinglePartitioning
    from spark_rapids_tpu_torch.tools.event_log import read_event_logs
    tables, paths, _ = files
    dirs, sinks = _telemetry_dirs("refusals")
    conf = dict(sinks, **{"spark.sql.shuffle.partitions": "1",
                          "spark.rapids.query.deadline": str(DEADLINE_S)})
    s = nds.session_over_files(paths, conf, device)
    pp = _apply(s.conf, device, s.sql(nds.SQL_QUERIES["q97"])._node,
                "telemetry")
    before = _sample("rapids_query_cancelled_total", "deadline")
    t0 = time.time()
    t = time.perf_counter()
    try:
        pp.collect(ExecCtx(s.conf, device))
    except QueryCancelled as e:
        reason = e.reason
    else:
        raise AssertionError(f"q97 finished inside {DEADLINE_S} s")
    secs = time.perf_counter() - t
    (row,) = warehouse.read_rows(dirs["warehouse"])
    evs = [e for e in RECORDER.snapshot(since=t0)
           if e["kind"] == "lifecycle"]
    counted = _sample("rapids_query_cancelled_total", "deadline") - before
    # an adaptive reader over a source, not an exchange: refused
    # malformed_aqe_wrapper before anything runs
    src = HostBatchSourceExec(tables["store"].to_batches())
    bad = GpuAQEShuffleReadExec(GpuShuffleExchangeExec(
        SinglePartitioning(), src)).with_new_children([src])
    t1 = time.time()
    try:
        GpuOverrides(s.conf.with_settings(
            {"spark.sql.adaptive.enabled": "false"}), device).apply(bad)
    except PlanVerificationError as e:
        refused = e.report.reasons()
    else:
        raise AssertionError("the verifier passed a malformed plan")
    rejected = [e for e in RECORDER.snapshot(since=t1)
                if e.get("ev") == "plan_rejected"]
    lines = [e.get("type", "query") for e in read_event_logs(dirs["events"])]
    out = {"reason": reason, "ms": secs * 1e3, "outcome": row["outcome"],
           "cancel": row["cancel"], "counted": counted,
           "flight": [e["ev"] for e in evs], "refused": refused,
           "rejected_events": len(rejected), "event_lines": lines}
    log(f"[telemetry] q97 cancelled [{reason}] after {secs * 1e3:.3f} ms: "
        f"warehouse row {row['outcome']} {row['cancel']}, "
        f"rapids_query_cancelled_total{{deadline}} +{counted}, flight "
        f"{out['flight']}; the verifier refused {refused}: "
        f"{len(rejected)} plan_rejected event(s); event log {lines}")
    if not (reason == "deadline" and row["outcome"] == "cancelled"
            and row["cancel"]["reason"] == "deadline" and counted == 1
            and out["flight"] == ["cancel", "cancelled_query"]
            and refused == ["malformed_aqe_wrapper"] and len(rejected) == 1
            and lines == ["query_cancelled", "plan_rejected"]):
        raise AssertionError(f"refusals: {out}")
    return out


def _telemetry_cost(device, card, smi, files, q6_paths):
    """Interleaved off/on pairs of q6 (device decode) and q3 at 1
    partition, each warm from the earlier phases: off, the flight
    recorder off and no sink; on, the flight recorder, warehouse, tracer
    and event log on (``bench.py``'s ``obs_overhead_frac`` pairs). Each
    side's median and spread (max - min over the median) and the
    overhead fraction, not gated (host noise between runs reaches tens
    of percent)."""
    from spark_rapids_tpu_torch import nds, tpch
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.exec.base import ExecCtx
    from spark_rapids_tpu_torch.io.scan import GpuFileScanExec
    from spark_rapids_tpu_torch.obs.recorder import RECORDER
    from spark_rapids_tpu_torch.planner import GpuOverrides
    _, paths, _ = files
    _, sinks = _telemetry_dirs("cost")
    off = {"spark.rapids.flight.enabled": "false"}
    on = dict(sinks, **{"spark.rapids.flight.enabled": "true"})
    plans = {}
    for side, extra in (("off", off), ("on", on)):
        plans[("q6", side)] = GpuOverrides(RapidsConf(extra), device).apply(
            tpch.build_q6(GpuFileScanExec(q6_paths,
                                          schema=tpch.LINEITEM_SCHEMA)))
        s = nds.session_over_files(
            paths, dict(extra, **{"spark.sql.shuffle.partitions": "1"}),
            device)
        plans[("q3", side)] = _apply(
            s.conf, device, s.sql(nds.SQL_QUERIES["q3"])._node, "telemetry")
    out = {}
    for q in ("q6", "q3"):
        times = {"off": [], "on": []}
        for _ in range(TELEMETRY_PAIRS):
            for side in ("off", "on"):
                pp = plans[(q, side)]
                ctx = ExecCtx(pp.conf, device)
                t = time.perf_counter()
                pp.collect(ctx)
                torch.cuda.synchronize()
                times[side].append(time.perf_counter() - t)
        rec = {}
        for side, ts in times.items():
            med = statistics.median(ts)
            rec[side] = {"median_ms": med * 1e3,
                         "spread": (max(ts) - min(ts)) / med,
                         "times_s": ts}
        rec["overhead_frac"] = rec["on"]["median_ms"] / \
            rec["off"]["median_ms"] - 1.0
        log(f"[telemetry] cost {q}: off {rec['off']['median_ms']:.3f} ms "
            f"(spread {rec['off']['spread']:.1%}), on "
            f"{rec['on']['median_ms']:.3f} ms (spread "
            f"{rec['on']['spread']:.1%}), overhead "
            f"{rec['overhead_frac']:+.2%} over {TELEMETRY_PAIRS} "
            f"interleaved pairs on {card} ({smi})")
        out[q] = rec
    units = _telemetry_unit_costs(ExecCtx(plans[("q6", "on")].conf,
                                          device).mm)
    log(f"[telemetry] host microseconds a call on {card} ({smi})'s host: "
        + ", ".join(f"{k} {v:.3f}" for k, v in units.items()))
    for q in ("q6", "q3"):
        calls, writes_ms = _telemetry_calls(plans[(q, "on")], device)
        events_ms = sum(calls[k] * units[k] for k in calls) / 1e3
        bound_ms = events_ms + sum(writes_ms.values())
        out[q].update(calls=calls, events_ms=events_ms,
                      writes_ms=writes_ms, bound_ms=bound_ms,
                      bound_frac=bound_ms / out[q]["on"]["median_ms"])
        log(f"[telemetry] cost bound {q}: calls a query {calls} x the "
            f"microseconds above = {events_ms:.6f} ms, plus the query's "
            f"writes {({k: round(v, 6) for k, v in writes_ms.items()})} "
            f"ms = {bound_ms:.6f} ms, {out[q]['bound_frac']:.4%} of the "
            f"on side's median {out[q]['on']['median_ms']:.3f} ms (an "
            f"upper bound: the gauge sets of a sync, the flight tap of a "
            f"span and the fingerprint of an event-log line are counted "
            f"in both rows)")
    out["unit_us"] = units
    RECORDER.configure(RapidsConf())
    return out


#: the telemetry's per-event calls, counted: key -> (module, class,
#: method)
TELEMETRY_SITES = {
    "flight": ("obs.recorder", "FlightRecorder", "record"),
    "span": ("obs.tracer", "Tracer", "_record"),
    "sync_gauges": ("memory", "DeviceMemoryManager", "_sync_gauges"),
    "counter": ("obs.metrics", "_Counter", "inc"),
    "gauge_set": ("obs.metrics", "_Gauge", "set"),
    "gauge_inc": ("obs.metrics", "_Gauge", "inc"),
    "gauge_dec": ("obs.metrics", "_Gauge", "dec"),
    "histogram": ("obs.metrics", "_Histogram", "observe")}
#: its once-a-query writes, timed: key -> (module, class or None, name)
TELEMETRY_WRITES = {
    "attribution_begin": ("obs.attribution", "QueryAttribution", "begin"),
    "warehouse_row": ("planner", "PhysicalPlan", "_emit_warehouse"),
    "chrome_trace": ("obs.tracer", "Tracer", "write_chrome"),
    "event_log": ("tools.event_log", None, "log_query_event"),
    "fingerprint": ("tools.event_log", None, "plan_fingerprint")}


def _telemetry_calls(pp, device):
    """One more run of ``pp`` with each of ``TELEMETRY_SITES`` and
    ``TELEMETRY_WRITES`` counted and timed (every thread's calls): how
    many flight-ring appends, spans, gauge syncs and registry updates
    one query makes, and the host milliseconds of its writes. Returns
    ``(counts, write milliseconds)``."""
    import importlib
    import threading
    from spark_rapids_tpu_torch.exec.base import ExecCtx
    sites = dict(TELEMETRY_SITES, **TELEMETRY_WRITES)
    counts = dict.fromkeys(sites, 0)
    secs = dict.fromkeys(sites, 0.0)
    lock = threading.Lock()

    def counting(key, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t
                with lock:
                    counts[key] += 1
                    secs[key] += dt
        return call

    saved = []
    for k, (mod, cls, name) in sites.items():
        owner = importlib.import_module(f"spark_rapids_tpu_torch.{mod}")
        if cls is not None:
            owner = getattr(owner, cls)
        # the raw attribute (a classmethod stays one when put back)
        raw = vars(owner)[name]
        saved.append((owner, name, raw))
        setattr(owner, name, counting(k, getattr(owner, name)))
    try:
        pp.collect(ExecCtx(pp.conf, device))
        torch.cuda.synchronize()
    finally:
        for owner, name, raw in saved:
            setattr(owner, name, raw)
    writes_ms = {k: secs[k] * 1e3 for k in TELEMETRY_WRITES}
    return {k: counts[k] for k in TELEMETRY_SITES}, writes_ms


def _telemetry_unit_costs(mm, n=20000):
    """Host microseconds a call of each of ``TELEMETRY_SITES``, the mean
    of ``n`` calls: a flight-ring append of a memory event into a ring at
    its default bounds, a span into a tracer (with its flight tap), the
    manager's ``_sync_gauges``, and a labelled counter, gauge and
    transfer histogram of a registry of its own."""
    from spark_rapids_tpu_torch.obs import metrics
    from spark_rapids_tpu_torch.obs.recorder import FlightRecorder
    from spark_rapids_tpu_torch.obs.tracer import Tracer
    reg = metrics.MetricsRegistry()
    counter = reg.counter("cost_total", "", ("kind",))
    gauge = reg.gauge("cost_bytes", "", ("kind",))
    hist = reg.histogram("cost_seconds", "", ("stage",),
                         buckets=metrics.TRANSFER_BUCKETS)
    ring = FlightRecorder()
    tracer = Tracer(max_spans=n)

    def span():
        with tracer.span("op", "op", args={"op_id": 1}):
            pass

    calls = {
        "flight": lambda: ring.record("mem", ev="reserve", bytes=1 << 20,
                                      device=1 << 24, host=0,
                                      budget=1 << 30),
        "span": span,
        "sync_gauges": mm._sync_gauges,
        "counter": lambda: counter.labels("device").inc(),
        "gauge_set": lambda: gauge.labels("device").set(1.0),
        "gauge_inc": lambda: gauge.labels("device").inc(),
        "gauge_dec": lambda: gauge.labels("device").dec(),
        "histogram": lambda: hist.labels("upload").observe(0.003)}
    out = {}
    for k, fn in calls.items():
        t = time.perf_counter()
        for _ in range(n):
            fn()
        out[k] = (time.perf_counter() - t) / n * 1e6
    return out


def phase_telemetry(device, card, smi, files, q6_paths):
    """Phase 17 in this process (module docstring); its q6 run with the
    profiler is ``phase_telemetry_q6``, in a process of its own."""
    t_phase = time.perf_counter()
    summary = {"nds": _telemetry_nds(device, card, smi, files),
               "memory": _telemetry_memory(device, files),
               "refusals": _telemetry_refusals(device, files),
               "cost": _telemetry_cost(device, card, smi, files, q6_paths),
               "verifier": _log_verifier("telemetry")}
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"[telemetry] phase took {summary['phase_s']:.3f} s (its q6 "
        "profile apart)")
    return summary


def phase_telemetry_q6(card, smi, summary, q6_paths, revenue=None,
                       launches=None):
    """q6 SF1 with device decode and every sink on, ``profile.path`` set,
    in a process of its own (``tools/telemetry_q6.py``): its revenue the
    oracle's (and phase 6's), one ``query`` span and every operator id in
    the trace, the profiler trace naming exactly as many K5 and K1
    kernels as the process's wrappers launched and phase 6 counted
    (``launches``; ``Q6_DD_LAUNCHES`` without it), the scan's 32 device
    chunks in the registry's delta and the folded metrics."""
    import shutil
    from spark_rapids_tpu_torch import tpch
    t0 = time.perf_counter()
    out_dir = os.path.join(ROOT, ".bench_cache", "telemetry_torch", "q6")
    shutil.rmtree(out_dir, ignore_errors=True)
    r = _traced_apart(["-m", "spark_rapids_tpu_torch.tools.telemetry_q6",
                       "--out", out_dir])
    want, _ = tpch.host_q6(q6_paths)
    rel = abs(r["revenue"] - want) / max(1.0, abs(want))
    wh = r["warehouse_rows"]
    want_k = launches or Q6_DD_LAUNCHES
    want_k = {"k1": want_k["filter_product_sum"],
              "k5": want_k["decode_batch"]}
    checks = {
        "revenue": r["rows"] == 1 and rel <= ENGINE_RTOL
        and (revenue is None or r["revenue"] == revenue),
        "trace": r["query_spans"] == 1
        and r["traced_op_ids"] == r["plan_op_ids"],
        "profiler": r["profiler_kernel_launches"]
        == r["wrapper_launches"] == want_k,
        "chunks": r["scan_device_chunks_delta"] == 32
        == r["folded_device_chunks"],
        "warehouse": len(wh) == 1 and wh[0]["outcome"] == "completed"
        and wh[0]["device_kind"] == card,
        "event_log": r["event_lines"] == ["query"]}
    summary["q6"] = dict(r, checks=checks, rel_err=rel,
                         seconds=time.perf_counter() - t0)
    log(f"[telemetry] q6 SF1 device decode, every sink on, profile.path "
        f"set, in a process of its own on {card} ({smi}): revenue "
        f"{r['revenue']!r} (oracle {want!r}, phase 6 {revenue!r}); "
        f"{r['query_spans']} query span, op ids {r['traced_op_ids']} of "
        f"{r['plan_op_ids']}; profiler kernels "
        f"{r['profiler_kernel_launches']} (the wrappers "
        f"{r['wrapper_launches']}, phase 6 {want_k}); device chunks "
        f"{r['scan_device_chunks_delta']} (folded "
        f"{r['folded_device_chunks']}); warehouse {wh}; event log "
        f"{r['event_lines']}; {r['profiler_device_kernels']} device "
        f"kernels in the profile; wall {r['wall_s'] * 1e3:.3f} ms with "
        f"the profiler, the process's first query; "
        f"{summary['q6']['seconds']:.3f} s with the process")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"telemetry q6: {failed}: {r}")


# --- phase 18: the process cluster ------------------------------------------

#: phase 18's texts at 16 partitions, each with its corpus module's name;
#: q_like_intl holds a CPU island in a worker
CLUSTER_TEXTS = (("q3", "nds"), ("q_rank", "nds"), ("q97", "nds"),
                 ("q_like_intl", "nds_fallback"))
#: the workers phase 18's cluster runs on the one card
CLUSTER_WORKERS = 2
#: the launch counters phase 18 reads a worker, by kernel
CLUSTER_KERNELS = {"K1": "filter_product_sum",
                   "K2": "filter_product_group_sum", "K3": "sort_pairs",
                   "K4": "gather_rows", "K5": "decode_batch",
                   "K6": "regex_match"}


#: by query id, the last cluster's winning attempts (stage, task, worker,
#: ms from claim)
CLUSTER_TASK_MS = {}


def _cluster_corpus(name):
    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.tools import nds_fallback
    return {"nds": nds, "nds_fallback": nds_fallback}[name]


def _chunks_of(metrics):
    """The device chunks of every scan of an in-process run."""
    return sum(m.get("deviceChunks", 0) for label, m in metrics.items()
               if label.startswith("FileScanExec"))


def _worker_kernels(cluster):
    """The last query's launches of each kernel, summed a worker (the
    winning attempts')."""
    return {w: {k: launches.get(name, 0)
                for k, name in CLUSTER_KERNELS.items()}
            for w, launches in sorted(cluster.kernel_launches().items())}


def _cluster_query(cluster, pp, conf=None):
    """One timed query on the cluster: its rows, ms, launches a worker,
    the workers' device-chunk delta and its kernel reports; the winning
    attempts' run times (claim to commit, a stage each) are logged."""
    before = cluster.worker_counter("rapids_scan_device_chunks_total")
    t = time.perf_counter()
    out = cluster.run_query(pp, conf)
    ms = (time.perf_counter() - t) * 1e3
    chunks = cluster.worker_counter(
        "rapids_scan_device_chunks_total") - before
    tasks = [(e["stage"], e["task"], e["worker"], round(e["wall_s"] * 1e3, 3))
             for e in cluster.last_scheduler.events
             if e["event"] == "task_ok"]
    log(f"[cluster] tasks (stage, task, worker, ms from claim): {tasks}")
    CLUSTER_TASK_MS[cluster._query_seq] = tasks
    return out, ms, _worker_kernels(cluster), chunks, \
        list(cluster.last_kernel_reports)


def _in_process(pp, device):
    """One in-process run of a planned text: rows, ms, launches, metrics
    and its per-operator rows."""
    from spark_rapids_tpu_torch.cluster import launch_counters
    from spark_rapids_tpu_torch.exec.base import ExecCtx
    from spark_rapids_tpu_torch.obs.opmetrics import fold_ctx
    wrappers = launch_counters().values()
    for c in wrappers:
        c.launches = 0
    ctx = ExecCtx(pp.conf, device)
    t = time.perf_counter()
    out = pp.collect(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches = {c.__name__: c.launches for c in wrappers}
    rows = {k: int(v["metrics"]["rows"])
            for k, v in fold_ctx(ctx).items() if "rows" in v["metrics"]}
    return out, ms, launches, _metrics(ctx), rows


def phase_cluster(device, card, smi, files, q6_paths, q6_launches=None):
    """Phase 18: ``GpuProcessCluster(n_workers=2)`` on the one card
    (module docstring)."""
    import shutil
    from spark_rapids_tpu_torch import nds, tpch
    from spark_rapids_tpu_torch.cluster import GpuProcessCluster
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.io.scan import GpuFileScanExec
    from spark_rapids_tpu_torch.planner import GpuOverrides

    tables, paths, _ = files
    t_phase = time.perf_counter()
    if device.type == "cuda":
        # the workers share the card with this process: give back what
        # the earlier phases' allocator holds
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    root = os.path.join(ROOT, ".bench_cache", "cluster_torch")
    shutil.rmtree(root, ignore_errors=True)
    base = {"spark.rapids.metrics.enabled": "true",
            "spark.rapids.tpu.scheduler.stageTimeout": "300"}
    conf16 = dict(base, **{"spark.sql.shuffle.partitions": "16"})
    summary = {"texts": {}, "workers": {}}
    reports = []
    t0 = time.perf_counter()
    cluster = GpuProcessCluster(CLUSTER_WORKERS, root=root,
                                device=device, conf=RapidsConf(base))
    summary["start_s"] = time.perf_counter() - t0
    try:
        def planned(q, corpus, extra=None):
            s = nds.session_over_files(
                paths, dict(conf16, **getattr(corpus, "CONF", {}).get(q, {}),
                            **(extra or {})), device)
            return _apply(s.conf, device,
                          s.sql(corpus.SQL_QUERIES[q])._node, "cluster")

        in_proc = {}
        for q, mod in CLUSTER_TEXTS:
            corpus = _cluster_corpus(mod)
            want = _oracle(corpus.oracle, q, tables)
            floats = corpus.FLOAT_COLUMNS[q]
            out_l, ms_l, launches_l, metrics_l, rows_l = _in_process(
                planned(q, corpus), device)
            _rows_equal(q, out_l, want, floats)
            in_proc[q] = rows_l
            out, ms, kernels, chunks, reps = _cluster_query(
                cluster, planned(q, corpus))
            reports += reps
            rel = _rows_equal(q, out, want, floats)
            want_chunks = _chunks_of(metrics_l)
            if chunks != want_chunks:
                raise AssertionError(f"cluster {q}: device chunks {chunks}"
                                     f" in the workers, {want_chunks} in "
                                     "process")
            summary["texts"][q] = {
                "ms": ms, "ms_in_process": ms_l, "max_rel_err": rel,
                "kernels_by_worker": kernels, "device_chunks": chunks,
                "launches_in_process": {
                    k: launches_l[n] for k, n in CLUSTER_KERNELS.items()},
                "scheduler": cluster.last_scheduler.summary()}
            log(f"[cluster] {q} partitions=16 on {CLUSTER_WORKERS} workers:"
                f" {ms:.3f} ms ({ms_l:.3f} in process); {out.num_rows} rows"
                f" equal to the oracle (max rel err {rel:.3e}); launches a "
                f"worker {kernels} (in process "
                f"{summary['texts'][q]['launches_in_process']}); device "
                f"chunks {chunks} (in process {want_chunks})")
        # q3 again: the workers' second run of a text
        out, ms, _, _, _ = _cluster_query(cluster,
                                          planned("q3", _cluster_corpus(
                                              "nds")))
        q3_map_ms = [t[3] for t in CLUSTER_TASK_MS[cluster._query_seq]
                     if t[0].startswith("map")][0]
        summary["texts"]["q3"]["ms_second_run"] = ms
        log(f"[cluster] q3 partitions=16, the cluster's second run: "
            f"{ms:.3f} ms")
        # q6: no exchange, one worker runs the whole plan (K5 and K1)
        want_rev, _ = tpch.host_q6(q6_paths)
        q6_conf = RapidsConf(base)
        q6 = tpch.build_q6(GpuFileScanExec(q6_paths,
                                           schema=tpch.LINEITEM_SCHEMA))
        if q6_launches is None:
            pp6 = GpuOverrides(q6_conf, device).apply(q6)
            _, _, launches_l, metrics_l, _ = _in_process(pp6, device)
            q6_launches = dict(launches_l, chunks=_chunks_of(metrics_l))
        out, ms, kernels, chunks, reps = _cluster_query(cluster, q6,
                                                        q6_conf)
        reports += reps
        got = out.column("revenue")[0].as_py()
        rel = abs(got - want_rev) / max(1.0, abs(want_rev))
        k1 = sum(k["K1"] for k in kernels.values())
        k5 = sum(k["K5"] for k in kernels.values())
        want_k1 = q6_launches["filter_product_sum"]
        want_k5 = q6_launches["decode_batch"]
        on_card = device.type == "cuda"
        if out.num_rows != 1 or not rel <= ENGINE_RTOL or k1 != want_k1 \
                or k5 != want_k5 or len(kernels) != 1 \
                or chunks != q6_launches["chunks"] \
                or (on_card and (k1, k5) != (
                    Q6_DD_LAUNCHES["filter_product_sum"],
                    Q6_DD_LAUNCHES["decode_batch"])):
            raise AssertionError(
                f"cluster q6: revenue {got!r} vs {want_rev!r}, K1 {k1} vs "
                f"{want_k1}, K5 {k5} vs {want_k5}, workers {kernels}, "
                f"chunks {chunks} vs {q6_launches['chunks']}")
        summary["texts"]["q6"] = {"ms": ms, "rel_err": rel,
                                  "kernels_by_worker": kernels,
                                  "device_chunks": chunks}
        log(f"[cluster] q6 SF1 (no exchange: one worker): {ms:.3f} ms; "
            f"revenue {got!r} (oracle {want_rev!r}, rel {rel:.3e}); "
            f"launches a worker {kernels}, K1 {k1} (in process {want_k1})"
            f", device chunks {chunks} from the workers' registries")
        # q3 in process over the host-file shuffle, both modes
        nds_mod = _cluster_corpus("nds")
        want3 = _oracle(nds_mod.oracle, "q3", tables)
        for mode in ("HOST", "MULTITHREADED"):
            pp = planned("q3", nds_mod, {"spark.rapids.shuffle.mode": mode})
            out, ms, _, _, _ = _in_process(pp, device)
            rel = _rows_equal("q3", out, want3, nds_mod.FLOAT_COLUMNS["q3"])
            summary[f"q3_{mode.lower()}_ms"] = ms
            log(f"[cluster] q3 in process, spark.rapids.shuffle.mode={mode}"
                f": {ms:.3f} ms, rows equal to the oracle (max rel err "
                f"{rel:.3e})")
        # chaos: a crashed map task retried, corrupt map output rerun
        for mode, what in (("crash", "workers_respawned"),
                           ("corrupt", "stage_reruns")):
            qid = cluster._query_seq + 1
            conf = RapidsConf(dict(conf16, **{
                "spark.rapids.tpu.test.injectFaults":
                    f"{mode}:q{qid}s*m0:0"}))
            out, ms, kernels, _, reps = _cluster_query(
                cluster, planned("q3", nds_mod), conf)
            reports += reps
            _rows_equal("q3", out, want3, nds_mod.FLOAT_COLUMNS["q3"])
            sched = cluster.last_scheduler.summary()
            if mode == "crash" and not (sched["failures"] >= 1
                                        and sched[what] >= 1):
                raise AssertionError(f"cluster crash run: {sched}")
            if mode == "corrupt" and not (sched["fetch_failures"] >= 1
                                          and sched[what] >= 1):
                raise AssertionError(f"cluster corrupt run: {sched}")
            summary[f"q3_{mode}"] = {"ms": ms, "scheduler": sched}
            log(f"[cluster] q3 with {mode} of a map task: {ms:.3f} ms, rows"
                f" equal to the oracle; scheduler {sched}")
        # a worker killed while its map task runs on the card: its
        # respawned incarnation rebuilds from the files alone
        summary["q3_kill"] = _cluster_kill_midtask(
            cluster, planned("q3", nds_mod), want3,
            nds_mod.FLOAT_COLUMNS["q3"], q3_map_ms / 2e3)
        # EXPLAIN ANALYZE over the cluster against the in-process one
        text = cluster.explain_analyze(planned("q3", nds_mod))
        remote = {k: int(v["metrics"]["rows"])
                  for k, v in cluster.last_opmetrics.items()
                  if "rows" in v["metrics"]}
        common = sorted(set(remote) & set(in_proc["q3"]))
        diff = {k: (remote[k], in_proc["q3"][k]) for k in common
                if remote[k] != in_proc["q3"][k]}
        if not text.startswith("== Analyzed Physical Plan (process") \
                or len(common) < len(remote) or diff:
            raise AssertionError(f"cluster EXPLAIN ANALYZE: {diff}, "
                                 f"{len(common)} of {len(remote)} ops")
        log("[cluster] EXPLAIN ANALYZE q3 over the cluster, rows equal to "
            f"the in-process run's on {len(common)} operators:\n" + text)
    finally:
        cluster.shutdown()
    workers = {}
    for r in reports:
        w = workers.setdefault(r["worker"], {"names": set(), "modules": set(),
                                             "pids": set()})
        w["names"].add(r["device_name"])
        w["modules"].update(r["reference_modules"])
        w["pids"].add(r["pid"])
    want_name = card if device.type == "cuda" else "cpu"
    bad = {k: v for k, v in workers.items()
           if v["names"] != {want_name} or v["modules"]}
    if bad or sorted(workers) != list(range(CLUSTER_WORKERS)):
        raise AssertionError(f"cluster workers: {workers}")
    summary["workers"] = {w: {"device_names": sorted(v["names"]),
                              "processes": len(v["pids"])}
                          for w, v in workers.items()}
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"[cluster] every worker ran on {want_name} ({smi}) and loaded no "
        f"jax: {summary['workers']}; the cluster started in "
        f"{summary['start_s']:.3f} s; phase took {summary['phase_s']:.3f} s")
    return summary


def _cluster_kill_midtask(cluster, pp, want, floats, after_s):
    """Run ``pp`` on the cluster and kill the worker of its first map
    attempt ``after_s`` seconds after the claim (half the same task's
    time in a clean run: mid-task), and the query must still equal the
    oracle, through a respawn and a retry."""
    import threading
    qid = cluster._query_seq + 1
    tasks = os.path.join(cluster.root, "tasks")
    killed = []

    def killer():
        t0 = time.monotonic()
        while time.monotonic() - t0 < 120 and not killed:
            for n in os.listdir(tasks):
                if n.startswith(f"q{qid}s") and n.endswith(".task.claim"):
                    time.sleep(after_s)
                    w = int(n.split(".w")[1].split(".")[0])
                    cluster.pool.kill(w)
                    killed.append((n, w))
                    return
            time.sleep(0.01)

    th = threading.Thread(target=killer, daemon=True)
    th.start()
    t = time.perf_counter()
    out = cluster.run_query(pp)
    ms = (time.perf_counter() - t) * 1e3
    th.join(timeout=5)
    _rows_equal("q3", out, want, floats)
    sched = cluster.last_scheduler.summary()
    died = [e for e in cluster.last_scheduler.events
            if e["event"] == "task_failed" and "died" in e["reason"]]
    if not killed or not died or sched["workers_respawned"] < 1:
        raise AssertionError(f"cluster kill run: killed {killed}, "
                             f"{sched}")
    log(f"[cluster] q3 with its map task's worker killed {after_s:.3f} s "
        f"after the claim ({killed[0][0]}): {ms:.3f} ms, rows equal to the "
        f"oracle; scheduler {sched}")
    return {"ms": ms, "scheduler": sched, "killed": killed[0][0]}


def _cluster_launches(summary, kernel):
    """``{text: launches}`` of one of phase 18's kernels, summed over the
    workers."""
    return {q: sum(k[kernel] for k in t["kernels_by_worker"].values())
            for q, t in summary["texts"].items()}


# --- phase 19: the DataFrame API's rest ----------------------------------------

def _counted(run, device, counters):
    """``run()`` timed, its launches counted: ``(its result, seconds,
    launches)``."""
    for c in counters:
        c.launches = 0
    t = time.perf_counter()
    out = run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t
    return out, secs, {c.__name__: c.launches for c in counters}


def _implied(pp, ctx, want_longest):
    """The launches a run of ``pp`` under ``ctx`` implies."""
    return _nds_expected(pp.root, _metrics(ctx), want_longest, pp.conf,
                         pp.root_on_device)


def _dataframe_run(pp, device, want_longest, counters):
    """One counted, timed collect of a planned plan: ``(rows, seconds,
    ctx, launches, the launches the plan implies)``."""
    from spark_rapids_tpu_torch.exec.base import ExecCtx
    ctx = ExecCtx(pp.conf, device)
    out, secs, got = _counted(lambda: pp.collect(ctx), device, counters)
    return out, secs, ctx, got, _implied(pp, ctx, want_longest)


def _dataframe_chunks(q, pp, ctx, chunks):
    """The device scans' chunk counters against their files'."""
    _check_chunks(q, _metrics(ctx), _scan_chunks_needed(
        pp.root, chunks, pp.root_on_device))


def _file_chunks(files):
    """A written Parquet file's device chunks: row groups x columns."""
    import pyarrow.parquet as pq
    out = {}
    for f in files:
        md = pq.ParquetFile(f).metadata
        out[f] = md.num_row_groups * md.num_columns
    return out


def phase_dataframe(device, files, card, smi):
    """Phase 19 (module docstring): ``tools/nds_dataframe``'s texts and
    round trips at 1 and 16 partitions, one timed run each."""
    import shutil
    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.tools import nds_dataframe as ndf
    from spark_rapids_tpu_torch.tools.nds_trace import counters

    tables, paths, chunks = files
    t_phase = time.perf_counter()
    out_dir = os.path.join(ROOT, ".bench_cache", "dataframe_torch")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    E = ndf.port_namespace()
    wrappers = list(counters().values())
    names = {c.__name__: k for k, c in counters().items()}
    t0 = time.perf_counter()
    oracles = {q: ndf.oracle(q, tables) for q in ndf.TEXTS}
    oracles.update({k: ndf.roundtrip_oracle(k, tables, out_dir)
                    for k in ndf.ROUNDTRIPS})
    log(f"[dataframe] oracles in {time.perf_counter() - t0:.3f} s")
    summary, launches = {}, {}

    def record(key, secs, got, implied, extra):
        if got != implied:
            raise AssertionError(f"{key}: launches {got}, the plan "
                                 f"implies {implied}")
        by_kernel = {names[k]: v for k, v in got.items()}
        summary[key] = dict(extra, ms=secs * 1e3, launches=by_kernel)
        launches[key] = got
        log(f"[dataframe] {key}: {secs * 1e3:.3f} ms on {card} ({smi}); "
            f"launches {by_kernel} as the plan implies; "
            + json.dumps(extra, sort_keys=True))

    for parts in (1, 16):
        conf = {"spark.sql.shuffle.partitions": str(parts)}
        for q in ndf.TEXTS:
            s = nds.session_over_files(paths, conf, device)
            want = oracles[q]
            t = time.perf_counter()
            pp = _apply(s.conf, device, ndf.BUILDERS[q](s, E)._node,
                        "dataframe")
            plan_s = time.perf_counter() - t
            if pp.fallback_nodes():
                raise AssertionError(f"{q}: nodes on the CPU "
                                     f"{pp.fallback_nodes()}")
            out, secs, ctx, got, implied = _dataframe_run(
                pp, device, _nds_longest(want), wrappers)
            rel = ndf.check(q, out, want)
            _dataframe_chunks(q, pp, ctx, chunks)
            record(f"{q}_p{parts}", secs, got, implied,
                   {"rows": out.num_rows, "max_rel_err": rel,
                    "plan_ms": plan_s * 1e3})
        for k in ndf.ROUNDTRIPS:
            s = nds.session_over_files(paths, conf, device)
            src, fmt, part_by = ndf.roundtrip_source(k, s, E)
            where = os.path.join(out_dir, f"{k}_p{parts}")
            # the user's entry point; its plan stays on the DataFrame
            written, w_secs, w_got = _counted(
                lambda: src.write(where, fmt, partition_by=part_by),
                device, wrappers)
            pp = src.last_write_plan
            _verified(pp, "dataframe")
            w_ctx = pp.last_ctx
            w_implied = _implied(pp, w_ctx, {})
            _dataframe_chunks(k, pp, w_ctx, chunks)
            write_time = _op_metric(_metrics(w_ctx), "FileWriteExec",
                                    "writeTime")
            rpp = _apply(s.conf, device, ndf.roundtrip_read(
                k, s, written, src.schema)._node, "dataframe")
            out, r_secs, r_ctx, r_got, r_implied = _dataframe_run(
                rpp, device, {}, wrappers)
            if fmt == "parquet":  # the other formats upload Arrow
                _dataframe_chunks(k, rpp, r_ctx, _file_chunks(written))
            rel = ndf.check(k, out, oracles[k], keys=out.column_names)
            got = {n: w_got[n] + r_got[n] for n in w_got}
            implied = {n: w_implied[n] + r_implied[n] for n in w_implied}
            record(f"{k}_p{parts}", w_secs + r_secs, got, implied,
                   {"rows": out.num_rows, "files": len(written),
                    "write_ms": w_secs * 1e3, "read_ms": r_secs * 1e3,
                    "writeTime_ms": write_time * 1e3,
                    "max_rel_err": rel})
    for parts in (1, 16):
        if not (launches[f"df_hash_p{parts}"]["xxhash64_strings"]
                and launches[f"df_regex_p{parts}"]["find_spans"]):
            raise AssertionError(f"K7 or K8 not launched at {parts} "
                                 "partitions")
    summary["verifier"] = _log_verifier("dataframe")
    took = time.perf_counter() - t_phase
    summary["phase_s"] = took
    log(f"[dataframe] phase took {took:.3f} s")
    shutil.rmtree(out_dir, ignore_errors=True)
    return summary, launches


def main():
    global _log_file
    memory_only, opm_only, functions_only, decimals_only, nested_only, \
        telemetry_only, cluster_only, dataframe_only, log_path = _args()
    if log_path:
        os.makedirs(os.path.dirname(os.path.abspath(log_path)),
                    exist_ok=True)
        _log_file = open(log_path, "w")
        import atexit
        atexit.register(_log_file.close)
    name, count, smi = phase_card()
    device = torch.device("cuda", 0)
    phase_build()
    if memory_only:
        # a quick check of phase 11 alone; the full run takes no argument
        summary, _ = phase_nds_memory(device, _nds_files())
        log("[nds-memory] " + json.dumps(summary, sort_keys=True))
        return
    if opm_only:
        # a quick check of phase 12 alone
        summary = phase_opmetrics(device, _nds_files(), name, smi, None)
        log("[opm] " + json.dumps(summary, sort_keys=True))
        return
    if functions_only:
        # a quick check of phase 13 alone
        summary, _ = phase_functions(device, _nds_files(), name, smi)
        phase_function_traces(name, smi, summary)
        log("[functions] " + json.dumps(summary, sort_keys=True))
        return
    if decimals_only:
        # a quick check of phase 14 alone
        summary, _ = phase_decimals(device, name, smi)
        phase_decimal_trace(name, smi, summary)
        log("[decimals] " + json.dumps(summary, sort_keys=True))
        return
    if nested_only:
        # a quick check of phase 16 alone
        summary, _ = phase_nested(device, name, smi)
        phase_nested_trace(name, smi, summary)
        log("[nested] " + json.dumps(summary, sort_keys=True))
        return
    if telemetry_only:
        # a quick check of phase 17 alone (q6 held to the oracle only)
        from spark_rapids_tpu_torch import tpch
        q6_paths = tpch.write_lineitem(
            tpch.gen_lineitem(tpch.SF1_ROWS, seed=0),
            os.path.join(ROOT, ".bench_cache", "lineitem_torch"), seed=0)
        summary = phase_telemetry(device, name, smi, _nds_files(),
                                  q6_paths)
        phase_telemetry_q6(name, smi, summary, q6_paths)
        log("[telemetry] " + json.dumps(summary, sort_keys=True))
        return
    if dataframe_only:
        # a quick check of phase 19 alone
        summary, _ = phase_dataframe(device, _nds_files(), name, smi)
        log("[dataframe] " + json.dumps(summary, sort_keys=True))
        return
    if cluster_only:
        # a quick check of phase 18 alone
        from spark_rapids_tpu_torch import tpch
        q6_paths = tpch.write_lineitem(
            tpch.gen_lineitem(tpch.SF1_ROWS, seed=0),
            os.path.join(ROOT, ".bench_cache", "lineitem_torch"), seed=0)
        summary = phase_cluster(device, name, smi, _nds_files(), q6_paths)
        log("[cluster] " + json.dumps(summary, sort_keys=True))
        return
    times = phase_kernels(device)
    k3, k4, (k3_err, k4_err) = phase_sort_gather(device)
    k5, k2 = phase_decode_group(device)
    k6, k6_err = phase_regex(device)
    k7, k8, k8_err = phase_hash_spans(device)
    launches, paths = phase_slice(device)
    join_launches = phase_join(device)
    dd_launches, dd_revenue = phase_q6_device_decode(device, paths)
    ln_launches = phase_q6_by_linenumber(device)
    nds_files = _nds_files()
    nds_summary, nds_launches = phase_nds(device, nds_files)
    joins_summary, joins_launches = phase_nds_joins(device, nds_files)
    fb_summary, fb_launches = phase_nds_fallback(device, nds_files)
    mem_summary, mem_launches = phase_nds_memory(
        device, nds_files, fb_summary[SKEW_WITNESS])
    opm_summary = phase_opmetrics(device, nds_files, name, smi, nds_summary)
    fn_summary, fn_launches = phase_functions(device, nds_files, name, smi)
    dec_summary, dec_launches = phase_decimals(device, name, smi)
    nested_summary, nested_launches = phase_nested(device, name, smi)
    tel_summary = phase_telemetry(device, name, smi, nds_files, paths)
    cluster_summary = phase_cluster(
        device, name, smi, nds_files, paths,
        dict(dd_launches, chunks=Q6_DD_CHUNKS))
    df_summary, df_launches = phase_dataframe(device, nds_files, name, smi)
    # the traces last, each in a process of its own
    per_call = phase_k1_kernels_per_call()
    phase_function_traces(name, smi, fn_summary)
    phase_decimal_trace(name, smi, dec_summary)
    phase_nested_trace(name, smi, nested_summary)
    phase_telemetry_q6(name, smi, tel_summary, paths, dd_revenue,
                       dd_launches)
    loaded = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.")
              or m == "spark_rapids_tpu" or m.startswith("spark_rapids_tpu.")]
    if loaded:
        raise AssertionError(f"the smoke test loaded {loaded}")
    e, c = times["engine"], times["contract"]
    log(f"[k1-contract] masked_product_sum: ms={c['ms']!r} "
        f"plain_ms={c['plain_ms']!r} "
        f"bound_ms={c['bound_ms']!r} max_abs_err={c['max_abs_err']!r}; "
        f"not on the main path")
    log("[nds] " + json.dumps(nds_summary, sort_keys=True))
    log("[nds-joins] " + json.dumps(joins_summary, sort_keys=True))
    log("[nds-fallback] " + json.dumps(fb_summary, sort_keys=True))
    log("[nds-memory] " + json.dumps(mem_summary, sort_keys=True))
    log("[opm] " + json.dumps(opm_summary, sort_keys=True))
    log("[functions] " + json.dumps(fn_summary, sort_keys=True))
    log("[decimals] " + json.dumps(dec_summary, sort_keys=True))
    log("[nested] " + json.dumps(nested_summary, sort_keys=True))
    log("[telemetry] " + json.dumps(tel_summary, sort_keys=True))
    log("[cluster] " + json.dumps(cluster_summary, sort_keys=True))
    log("[dataframe] " + json.dumps(df_summary, sort_keys=True))
    main_sort = k3["partial_2^21"]
    span_main = k8[f"text_0_2^{K8_MAIN_ROWS_LOG2}"]
    probe = k4["probe_2^21_from_2^17"]
    like = k6["q_like_item_32768"]
    log(json.dumps({"kernels": [{
        "name": "masked_product_sum (engine edition, filter_product_sum)",
        "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
        "launches": launches["filter_product_sum"],
        "max_abs_err": e["max_abs_err"],
        "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
        "bound_by": e["bound_by"], "library_ms": None,
        "kernels_per_call": per_call,
        "bound_share": e["bound_ms"] / e["ms"],
        "ms_by_rows": e["ms_by_rows"],
        "empty_launch_ms": e["empty_launch_ms"],
        "launches_q6_device_decode": dd_launches["filter_product_sum"],
        "launches_telemetry_q6_profiled":
            tel_summary["q6"]["profiler_kernel_launches"]["k1"],
        "launches_cluster": _cluster_launches(cluster_summary, "K1")}, {
        "name": "radix_sort (engine edition, sort_pairs)",
        "route": "cuda", "source": K3_SOURCE, "replaces": K3_REPLACES,
        "launches": join_launches["sort_pairs"], "max_abs_err": k3_err,
        "ms": main_sort["ms"], "plain_ms": main_sort["plain_ms"],
        "bound_ms": main_sort["bound_ms"],
        "bound_by": main_sort["bound_by"],
        "library_ms": main_sort["library_ms"],
        "shape": "a partial aggregate's month words, 2^21 pairs",
        "by_shape": k3,
        "shape_string_rank": "a string-rank pass's words, 2^20 pairs",
        "string_rank": {k: v for k, v in k3.items()
                        if k.startswith("string_rank")},
        "shape_window": "a window sort's words, 2^15 pairs",
        "window": {k: v for k, v in k3.items() if k.startswith("window")},
        "launches_nds": {k: v["sort_pairs"]
                         for k, v in nds_launches.items()},
        "launches_nds_joins": {k: v["sort_pairs"]
                               for k, v in joins_launches.items()},
        "launches_nds_fallback": {k: v["sort_pairs"]
                                  for k, v in fb_launches.items()},
        "launches_nds_memory": {k: v["K3"]
                                for k, v in mem_launches.items()},
        "launches_functions": {k: v["K3"]
                               for k, v in fn_launches.items()},
        "launches_decimals": {k: v["sort_pairs"]
                              for k, v in dec_launches.items()},
        "launches_nested": {k: v["sort_pairs"]
                            for k, v in nested_launches.items()},
        "launches_cluster": _cluster_launches(cluster_summary, "K3"),
        "nested_compaction": k3[NESTED_K3_SHAPE]}, {
        "name": "gather (engine edition, gather_rows)",
        "route": "cuda", "source": K4_SOURCE, "replaces": K4_REPLACES,
        "launches": join_launches["gather_rows"], "max_abs_err": k4_err,
        "ms": probe["ms"], "plain_ms": probe["plain_ms"],
        "bound_ms": probe["bound_ms"], "bound_by": probe["bound_by"],
        "library_ms": probe["library_ms"],
        "shape": "2^21 rows x 2 int32 columns from 2^17",
        "by_shape": k4,
        "launches_nds": {k: v["gather_rows"]
                         for k, v in nds_launches.items()},
        "launches_nds_joins": {k: v["gather_rows"]
                               for k, v in joins_launches.items()},
        "launches_nds_fallback": {k: v["gather_rows"]
                                  for k, v in fb_launches.items()},
        "launches_nds_memory": {k: v["K4"]
                                for k, v in mem_launches.items()},
        "launches_functions": {k: v["K4"]
                               for k, v in fn_launches.items()},
        "launches_decimals": {k: v["gather_rows"]
                              for k, v in dec_launches.items()},
        "launches_nested": {k: v["gather_rows"]
                            for k, v in nested_launches.items()},
        "launches_cluster": _cluster_launches(cluster_summary, "K4"),
        "nested_elements": k4[NESTED_K4_SHAPE]}, {
        "name": "parquet_decode (decode_batch)",
        "route": "cuda", "source": K5_SOURCE, "replaces": K5_REPLACES,
        "launches": dd_launches["decode_batch"],
        "max_abs_err": k5["max_abs_err"], "ms": k5["ms"],
        "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
        "bound_by": k5["bound_by"], "library_ms": None,
        "shape": "a q6 batch: 750,152 rows x 4 columns",
        "launches_q6_by_linenumber": ln_launches["decode_batch"],
        "launches_nds": {k: v["decode_batch"]
                         for k, v in nds_launches.items()},
        "launches_nds_joins": {k: v["decode_batch"]
                               for k, v in joins_launches.items()},
        "launches_nds_fallback": {k: v["decode_batch"]
                                  for k, v in fb_launches.items()},
        "launches_nds_memory": {k: v["K5"]
                                for k, v in mem_launches.items()},
        "launches_functions": {k: v["K5"]
                               for k, v in fn_launches.items()},
        "launches_decimals": {k: v["decode_batch"]
                              for k, v in dec_launches.items()},
        "launches_nested": {k: v["decode_batch"]
                            for k, v in nested_launches.items()},
        "launches_telemetry_q6_profiled":
            tel_summary["q6"]["profiler_kernel_launches"]["k5"],
        "launches_cluster": _cluster_launches(cluster_summary, "K5")}, {
        "name": "fused_filter_agg (engine edition, "
                "filter_product_group_sum)",
        "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
        "launches": ln_launches["filter_product_group_sum"],
        "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
        "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"], "library_ms": None,
        "shape": "a q6 batch: 750,152 rows, 7 groups",
        "contract_max_rel_err": k2["contract_max_rel_err"],
        "launches_cluster": _cluster_launches(cluster_summary, "K2")}, {
        "name": "regex_match (the LIKE/RLIKE automaton)",
        "route": "cuda", "source": K6_SOURCE, "replaces": K6_REPLACES,
        "launches": nds_launches["q_like_p1"]["regex_match"],
        "max_abs_err": k6_err, "ms": like["ms"],
        "plain_ms": like["plain_ms"], "bound_ms": like["bound_ms"],
        "bound_by": like["bound_by"], "library_ms": None,
        "shape": "q_like's item batch: 32,768 strings, '%o%s%', "
                 "32 positions",
        "routes": {k: v["route"] for k, v in k6.items()},
        "by_shape": k6,
        "launches_nds": {k: v["regex_match"]
                         for k, v in nds_launches.items()},
        "launches_functions": {k: v["K6"]
                               for k, v in fn_launches.items()},
        "launches_cluster": _cluster_launches(cluster_summary, "K6")}, {
        "name": "xxhash64 (xxhash64_strings)",
        "route": "cuda", "source": K7_SOURCE, "replaces": K7_REPLACES,
        "launches": df_launches["df_hash_p1"]["xxhash64_strings"],
        "max_abs_err": k7["max_abs_err"], "ms": k7["ms"],
        "plain_ms": k7["plain_ms"], "bound_ms": k7["bound_ms"],
        "bound_by": k7["bound_by"], "library_ms": None,
        "shape": "2^20 strings of 0-100 bytes after four fixed columns",
        "launches_dataframe": {k: v["xxhash64_strings"]
                               for k, v in df_launches.items()}}, {
        "name": "regex_spans (find_spans)",
        "route": "cuda", "source": K8_SOURCE, "replaces": K8_REPLACES,
        "launches": df_launches["df_regex_p1"]["find_spans"],
        "max_abs_err": k8_err, "ms": span_main["ms"],
        "plain_ms": span_main["plain_ms"],
        "bound_ms": span_main["bound_ms"],
        "bound_by": span_main["bound_by"], "library_ms": None,
        "shape": "2^20 text rows of 20-120 bytes, '[aeiou]+'",
        "by_shape": k8,
        "launches_dataframe": {k: v["find_spans"]
                               for k, v in df_launches.items()}}]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))


if __name__ == "__main__":
    main()
