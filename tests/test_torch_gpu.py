"""Card-only checks of the port: K1's two editions against
their plain versions at the main path's shape, its edge cases and every
bound's neighbours (``kernel_checks.check_k1``), one kernel a call, and
q6 through the engine with one K1 launch per batch; K3 and K4
against their plain versions (exactly, bit for bit; K3 also against
``torch.sort``) at the join + group-by path's shapes and edge cases, and a small join + group-by
through the engine with the launches its plan implies; every NDS query
the port runs from SQL on the card against the CPU, and string ranks on
the card against the CPU's; the window operator on the card against the
CPU; K6 (the LIKE/RLIKE automaton) against its plain version bit for
bit through each of its routes, LIKE through K6 once a batch, the
staged join on the card against the CPU, a full outer hash join and
a full outer nested-loop join from SQL on the card against the CPU, and
a spill round trip of a card batch that frees its bytes in
``torch.cuda.memory_allocated()`` and brings the same rows back; the
nested gathers and the ticket batch's compaction on the card against
the same calls on CPU tensors, and the nested texts on the card against
their oracle.
Run on a machine with a CUDA device: ``python -m pytest
tests/test_torch_gpu.py``; elsewhere they skip."""
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU "
                    "mode)")
    return torch.device("cuda", 0)


def test_k1_editions_match_plain_versions(cuda_device):
    from spark_rapids_tpu_torch.ops import kernel_checks as kc
    recs = kc.check_k1(cuda_device)
    cases = {c.name for c in kc.k1_cases("cpu")}
    assert {"main", "ragged", "nulls_nan", "columns_at_4B", "masks_at_1B",
            "rows_0", "rows_5", "rows_2^23", "int32_slots_0_3"} <= cases
    got = {(r["case"], r["edition"]) for r in recs}
    # every case in both editions (the contract where its slots fit),
    # the edges of the card's geometry, the same bits again, and the
    # bound sweep at both alignments
    assert {(c, "engine") for c in cases} <= got
    assert (("main", "contract") in got
            and ("int32_slots_0_3", "contract") not in got)
    assert any(c.startswith("length_") for c, e in got)
    assert {(name, e) for e in ("engine", "contract")
            for name in ("two_launches", "two_streams", "bounds_sweep_at_0B",
                         "bounds_sweep_at_4B")} <= got
    assert kc.k1_kernels_per_call(cuda_device) == 1


def test_q6_on_the_card_launches_k1_per_batch(cuda_device, tmp_path):
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.exec.base import ExecCtx, collect_arrow
    from spark_rapids_tpu_torch.io.scan import GpuFileScanExec
    from spark_rapids_tpu_torch.ops import cuda_kernels as ck
    paths = tpch.write_lineitem(tpch.gen_lineitem(100_000), str(tmp_path),
                                n_files=3, row_group_size=1 << 14)
    conf = RapidsConf({
        "spark.rapids.sql.format.parquet.deviceDecode.enabled": "false",
        "spark.rapids.sql.batchSizeRows": str(1 << 15)})
    plan = tpch.build_q6(GpuFileScanExec(paths,
                                         schema=tpch.LINEITEM_SCHEMA))
    before = ck.filter_product_sum.launches
    got = collect_arrow(plan, ExecCtx(conf, cuda_device))
    want, _ = tpch.host_q6(paths)
    revenue = got.column("revenue")[0].as_py()
    assert abs(revenue - want) <= 1e-9 * max(1.0, abs(want))
    # 33,334 rows a file in batches of 1 << 15: two batches each
    assert ck.filter_product_sum.launches - before == 6


def test_k3_editions_match_plain_versions(cuda_device):
    from spark_rapids_tpu_torch.ops import kernel_checks as kc
    recs = kc.check_k3(cuda_device)
    assert all(r["max_abs_err"] == 0.0 for r in recs)
    assert {r["n"] for r in recs} >= set(kc.K3_SHAPES) | {1_000_003}
    engine = {r["case"]: r for r in recs if "library_equal" in r}
    assert all(r["library_equal"] for r in engine.values())
    # the skip rule: one pass where one digit varies, none for equal keys
    assert engine["sign_bit_only_2^21"]["passes"] == [11]
    assert engine["all_equal"]["passes"] == []
    assert engine["partial_2^21"]["passes"] == [4]


def test_k4_editions_match_plain_versions(cuda_device):
    from spark_rapids_tpu_torch.ops import kernel_checks as kc
    recs = kc.check_k4(cuda_device)
    assert all(r["data_equal"] and r["validity_equal"] for r in recs)


def test_join_groupby_on_the_card_launches_k3_and_k4(cuda_device):
    from spark_rapids_tpu_torch import join_groupby as jg
    from spark_rapids_tpu_torch.exec.base import ExecCtx, collect_arrow
    from spark_rapids_tpu_torch.ops import cuda_kernels as ck
    plan, li, orders = jg.build_plan(1 << 16, 1 << 10, 1 << 14,
                                     device=cuda_device)
    sorts, gathers = ck.sort_pairs.launches, ck.gather_rows.launches
    got = collect_arrow(plan, ExecCtx(device=cuda_device)).to_pydict()
    want = jg.host_oracle(li, orders)
    assert got["o_month"] == list(range(1, 13))
    for m, g in zip(got["o_month"], got["revenue"]):
        assert abs(g - want[m]) <= 1e-9 * abs(want[m])
    # 4 stream batches: presort + 4 partials + final; 1 + 3 x 4 + 2
    assert ck.sort_pairs.launches - sorts == 6
    assert ck.gather_rows.launches - gathers == 15


def test_k5_matches_plain_version(cuda_device):
    from spark_rapids_tpu_torch.ops import kernel_checks as kc
    recs = kc.check_k5(cuda_device)
    assert all(r["data_equal"] and r["validity_equal"]
               and r["strings_equal"] for r in recs)
    assert any(r["scan_jobs"] for r in recs)
    # the Parquet shapes, the NDS path's batches (a string column among
    # them, held to pyarrow too) and the hand-made tile walks ran
    assert {"shapes", "nds_store_sales_batch", "nds_item_batch",
            "nds_store_batch", "nds_customer_batch", "rle_runs_of_one",
            "widths", "nulls", "delta_identity"} <= {r["case"] for r in recs}
    assert any(r["string_columns"] for r in recs)
    assert all(r["pyarrow_equal"] for r in recs if "pyarrow_equal" in r)


def test_string_gather_at_the_join_shape(cuda_device):
    from spark_rapids_tpu_torch.ops import kernel_checks as kc
    rec = kc.check_string_gather(cuda_device)
    assert rec["offsets_equal"] and rec["chars_equal"] \
        and rec["validity_equal"]


def test_k2_editions_match_plain_versions(cuda_device):
    from spark_rapids_tpu_torch.ops import kernel_checks as kc
    recs = kc.check_k2(cuda_device)
    assert {r["edition"] for r in recs} == {"engine", "contract"}
    assert all(r["counts_equal"] for r in recs if r["edition"] == "engine")
    # the scalar loop, int64 keys, a few rows, and the same bits again
    assert {"columns_key_at_4B", "int64_key_at_8B", "masks_at_1B",
            "rows_1", "rows_3", "rows_5", "two_launches",
            "two_streams"} <= {r["case"] for r in recs}


def _device_decode_query(cuda_device, tmp_path, grouped):
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.exec.base import ExecCtx, collect_arrow
    from spark_rapids_tpu_torch.io.scan import GpuFileScanExec
    from spark_rapids_tpu_torch.ops import cuda_kernels as ck
    from spark_rapids_tpu_torch.ops.parquet_decode import decode_batch
    paths = tpch.write_lineitem(
        tpch.gen_lineitem(100_000, linenumber=grouped), str(tmp_path),
        n_files=3, row_group_size=1 << 14)
    conf = RapidsConf({"spark.rapids.sql.batchSizeRows": str(1 << 15)})
    build = tpch.build_q6_by_linenumber if grouped else tpch.build_q6
    schema = tpch.LINEITEM_GROUPED_SCHEMA if grouped \
        else tpch.LINEITEM_SCHEMA
    counters = (decode_batch, ck.filter_product_sum,
                ck.filter_product_group_sum)
    before = [c.launches for c in counters]
    got = collect_arrow(build(GpuFileScanExec(paths, schema=schema)),
                        ExecCtx(conf, cuda_device))
    launches = [c.launches - b for c, b in zip(counters, before)]
    return paths, got, launches


def test_q6_device_decode_on_the_card(cuda_device, tmp_path):
    from spark_rapids_tpu_torch import tpch
    paths, got, (k5, k1, k2) = _device_decode_query(cuda_device, tmp_path,
                                                    False)
    want, _ = tpch.host_q6(paths)
    revenue = got.column("revenue")[0].as_py()
    assert abs(revenue - want) <= 1e-9 * max(1.0, abs(want))
    # about 33,333 rows a file in row groups of 16,384, 16,384 and ~566,
    # coalesced in order into batches of at most 32,768 rows: 5
    assert (k5, k1, k2) == (5, 5, 0)


def test_q6_by_linenumber_on_the_card(cuda_device, tmp_path):
    from spark_rapids_tpu_torch import tpch
    paths, got, (k5, k1, k2) = _device_decode_query(cuda_device, tmp_path,
                                                    True)
    want = tpch.host_q6_by_linenumber(paths)
    keys = got.column("l_linenumber").to_pylist()
    assert keys == list(range(1, 8))
    for k, g in zip(keys, got.column("revenue").to_pylist()):
        assert abs(g - want[k]) <= 1e-9 * abs(want[k])
    assert (k5, k1, k2) == (5, 0, 5)


# sums of a few rows each taken as prefix differences, as in the
# reference: q_rolling's day a store (about one sale at these 2^14 rows:
# ops/segments' block-local prefixes of 1024 rows) and its window's
# 7-day frames (exec/window.py: a prefix over the whole batch). Their
# error scales with the running total over the sum, and the card's scan
# adds in another order than the CPU's; the window slice states rel
# 1e-9 for them
PREFIX_DIFFERENCE_SUMS = {("q_rolling", "rev"), ("q_rolling", "avg7")}


@pytest.mark.parametrize("parts", [1, 16])
def test_nds_sql_on_the_card_matches_the_cpu(cuda_device, tmp_path, parts):
    """Every query the port runs from SQL over Parquet on the card: the
    CPU run's rows (ints and strings exact, floats rel 1e-12, sums of a
    few rows by prefix difference rel 1e-9), the oracle's, and Murmur3
    partition ids, string gathers and string ranks equal to the CPU's
    bit for bit."""
    import math

    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.columnar import arrow_to_device
    from spark_rapids_tpu_torch.ops.hash import hash_columns
    from spark_rapids_tpu_torch.ops.sort_keys import string_order_ranks
    from spark_rapids_tpu_torch.ops.strings import gather_strings
    tables = nds.gen_tables(1 << 14)
    paths = nds.write_tables(tables, str(tmp_path))
    conf = {"spark.sql.shuffle.partitions": str(parts)}
    for q in nds.PORTED_QUERIES:
        rows = [nds.session_over_files(paths, conf, dev)
                .sql(nds.SQL_QUERIES[q]).collect()
                for dev in (cuda_device, "cpu")]
        want = nds.oracle(q, tables)
        for name in want.column_names:
            a, b, c = (t.column(name).to_pylist() for t in rows + [want])
            if name in nds.FLOAT_COLUMNS[q]:
                rtol = 1e-9 if (q, name) in PREFIX_DIFFERENCE_SUMS \
                    else 1e-12
                gaps = [abs(x - y) / max(abs(x), abs(y)) for x, y in
                        zip(a + a, b + c)
                        if x is not None and y is not None and x != y]
                print(f"[gap] {q}.{name} partitions={parts}: worst "
                      f"relative gap card-vs-cpu and card-vs-oracle "
                      f"{max(gaps, default=0.0):.3e} (limit {rtol:g})")
                assert all(x is y if x is None or y is None else
                           math.isclose(x, y, rel_tol=rtol)
                           for x, y in zip(a + a, b + c)), (q, name)
            else:
                assert a == b == c, (q, name)
    rb = tables["item"].combine_chunks().to_batches()[0]
    host, card = (arrow_to_device(rb, None, d) for d in ("cpu", cuda_device))
    assert torch.equal(hash_columns(card.columns).cpu(),
                       hash_columns(host.columns))
    s = rb.schema.get_field_index("i_category")
    idx = torch.randint(0, rb.num_rows, (host.capacity,),
                        generator=torch.Generator().manual_seed(parts))
    a = gather_strings(host.columns[s], idx, 1 << 20)
    b = gather_strings(card.columns[s], idx.to(cuda_device), 1 << 20)
    assert torch.equal(a.offsets, b.offsets.cpu())
    assert torch.equal(a.chars, b.chars.cpu())
    live = torch.rand(a.capacity, generator=torch.Generator()
                      .manual_seed(parts)) < 0.9
    assert torch.equal(string_order_ranks(a, live),
                       string_order_ranks(b, live.to(cuda_device)).cpu())


def test_window_on_the_card_matches_the_cpu(cuda_device):
    """``GpuWindowExec`` on the card against the CPU over one input (a
    filter's dead rows included): every ranking function, lag and lead
    over strings, each aggregate over rows and range frames, RANGE
    literal offsets, a min/max frame wide enough for the sparse table;
    ints, strings and nulls exact, the row order exact, floats rel 1e-9
    (a frame's float sum is a prefix difference over the batch, whose
    order of additions differs between the card's scan and the CPU's)."""
    import math

    import numpy as np
    import pyarrow as pa

    from spark_rapids_tpu_torch import datatypes as dt
    from spark_rapids_tpu_torch import expr as E
    from spark_rapids_tpu_torch.exec.base import (ExecCtx,
                                                  HostBatchSourceExec,
                                                  collect_arrow)
    from spark_rapids_tpu_torch.exec.basic import GpuFilterExec
    from spark_rapids_tpu_torch.exec.sort import SortOrder
    from spark_rapids_tpu_torch.exec.window import GpuWindowExec
    from spark_rapids_tpu_torch.expr import window as W
    rng = np.random.default_rng(3)
    n = 5000

    def nulls(frac):
        return rng.random(n) < frac
    rb = pa.record_batch({
        "p": pa.array(rng.choice(["a", "bb", "ccc", "dddddddddd"], n)),
        "o": pa.array(rng.integers(0, 400, n), pa.int32(),
                      mask=nulls(0.05)),
        "v": pa.array(rng.integers(-10**6, 10**6, n), pa.int64(),
                      mask=nulls(0.1)),
        "d": pa.array(rng.uniform(0, 100, n), mask=nulls(0.1)),
        "s": pa.array(rng.choice(["x", "yy", "zzz"], n).tolist(),
                      mask=nulls(0.1))})
    col = E.UnresolvedColumn
    order = [SortOrder(col("o"))]

    def w(fn, frame=None):
        return W.WindowExpression(fn, [col("p")], order, frame)
    exprs = [w(W.RowNumber()), w(W.Rank()), w(W.DenseRank()),
             w(W.PercentRank()), w(W.NTile(7)), w(W.Lag(col("s"), 2)),
             w(W.Lead(col("v"), 1, E.Literal(-1, dt.INT64)))]
    for frame in (None, W.WindowFrame("rows", -3, 2),
                  W.WindowFrame("rows", -1500, 1500),
                  W.WindowFrame("range", -20, 5),
                  W.WindowFrame("range", 0, None)):
        for f in (E.Sum, E.Count, E.Min, E.Max, E.Average):
            exprs += [w(f(col("v")), frame), w(f(col("d")), frame)]
    exprs = [E.Alias(e, f"w{i}") for i, e in enumerate(exprs)]
    src = GpuFilterExec(E.GreaterThan(col("o"), E.Literal(10)),
                        HostBatchSourceExec([rb]))
    plan = GpuWindowExec(exprs, src)
    got, want = (collect_arrow(plan, ExecCtx(device=d))
                 for d in (cuda_device, "cpu"))
    assert got.num_rows == want.num_rows > 0
    for name in want.column_names:
        a, b = got.column(name).to_pylist(), want.column(name).to_pylist()
        if pa.types.is_floating(want.schema.field(name).type):
            assert all(x is y if x is None or y is None else
                       (math.isnan(x) and math.isnan(y))
                       or math.isclose(x, y, rel_tol=1e-9)
                       for x, y in zip(a, b)), name
        else:
            assert a == b, name


def test_k6_matches_plain_version(cuda_device):
    """Both routes bit for bit: every case whose DFA fits through the DFA
    and through position sets, the blow-up case at 2^20 rows through
    position sets."""
    from spark_rapids_tpu_torch.ops import kernel_checks as kc
    recs = kc.check_k6(cuda_device)
    by_name = {r["case"]: r for r in recs}
    assert {"q_like_item_32768", "text_like_2^20", "text_rlike_2^20",
            "text_blowup_2^20", "edges_no_chars"} <= set(by_name)
    assert all(r["equal"] for r in recs)
    assert by_name["q_like_item_32768"]["equal_re"]
    both = {"dfa", "positions"}
    for name, r in by_name.items():
        want = both - {"dfa"} if name == "text_blowup_2^20" else both
        assert set(r["equal_by_route"]) == want, name
        assert r["route"] == ("positions" if name == "text_blowup_2^20"
                              else "dfa"), name


def test_like_launches_k6_once_a_batch(cuda_device):
    """A LIKE beyond the exact shape runs on K6, one launch a batch; the
    result equals the CPU's."""
    import pyarrow as pa

    from spark_rapids_tpu_torch import expr as E
    from spark_rapids_tpu_torch.exec.base import (ExecCtx,
                                                  HostBatchSourceExec,
                                                  collect_arrow)
    from spark_rapids_tpu_torch.exec.basic import GpuFilterExec
    from spark_rapids_tpu_torch.expr.strings import Like
    from spark_rapids_tpu_torch.ops import regex
    words = ["Electronics", "Home", "Sports", None, "", "Müsic\nos"]
    rbs = [pa.record_batch({"s": pa.array(words * (50 + i))})
           for i in range(3)]
    plan = GpuFilterExec(Like(E.UnresolvedColumn("s"), "%o%s%"),
                         HostBatchSourceExec(rbs))
    before = regex.regex_match.launches
    got = collect_arrow(plan, ExecCtx(device=cuda_device))
    assert regex.regex_match.launches - before == len(rbs)
    want = collect_arrow(plan, ExecCtx(device="cpu"))
    assert got.column("s").to_pylist() == want.column("s").to_pylist()
    assert got.num_rows > 0


def test_staged_join_on_the_card_matches_the_cpu(cuda_device):
    """A join whose build repeats its keys takes the staged path on the
    card (two stream batches, a string key and a string payload, every
    covered type) and gives the CPU's rows, exactly."""
    import numpy as np
    import pyarrow as pa

    from spark_rapids_tpu_torch import expr as E
    from spark_rapids_tpu_torch.exec.base import (ExecCtx,
                                                  HostBatchSourceExec,
                                                  collect_arrow)
    from spark_rapids_tpu_torch.exec.joins import GpuShuffledHashJoinExec
    rng = np.random.default_rng(2)

    def side(n, prefix):
        keys = rng.integers(0, 40, n)
        return pa.record_batch({
            f"{prefix}k": pa.array(keys.astype(np.int32),
                                   mask=rng.random(n) < 0.1),
            f"{prefix}s": pa.array([f"k{k % 7}" for k in keys]),
            f"{prefix}v": pa.array(rng.normal(0, 1, n))})
    left = [side(3000, "l"), side(2000, "l")]
    right = [side(1500, "r")]
    col = E.UnresolvedColumn
    for keys in (["lk"], ["lk", "ls"]):
        for jt in ("inner", "left_outer", "left_semi", "left_anti"):
            plan = GpuShuffledHashJoinExec(
                [col(k) for k in keys], [col("r" + k[1:]) for k in keys],
                jt, HostBatchSourceExec(left), HostBatchSourceExec(right))
            ctx = ExecCtx(device=cuda_device)
            got = collect_arrow(plan, ctx)
            assert ctx.metrics[plan.node_label()]["stagedBatches"].value \
                == 2
            want = collect_arrow(plan, ExecCtx(device="cpu"))
            assert got.num_rows == want.num_rows > 0, (keys, jt)
            for name in want.column_names:
                assert got.column(name).to_pylist() \
                    == want.column(name).to_pylist(), (keys, jt, name)


@pytest.mark.parametrize("q", ["q_full_halves", "q_band_full"])
def test_outer_and_nested_loop_joins_on_the_card_match_the_cpu(
        cuda_device, tmp_path, q):
    """A full outer hash join (q_full_halves, its build's matched mask
    across stream batches) and a full outer nested-loop join
    (q_band_full) from SQL at 2^16 store_sales rows, at partitions 1 and
    16: the card's rows equal the CPU's and the oracle's exactly (counts
    only)."""
    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.tools import nds_joins
    tables = nds.gen_tables(1 << 16)
    paths = nds.write_tables(tables, str(tmp_path))
    want = nds_joins.oracle(q, tables)
    for parts in (1, 16):
        conf = {"spark.sql.shuffle.partitions": str(parts)}
        card, cpu = (nds.session_over_files(paths, conf, dev)
                     .sql(nds_joins.SQL_QUERIES[q]).collect()
                     for dev in (cuda_device, "cpu"))
        assert card.num_rows == want.num_rows > 0, (q, parts)
        for name in want.column_names:
            assert card.column(name).to_pylist() \
                == cpu.column(name).to_pylist() \
                == want.column(name).to_pylist(), (q, parts, name)


def test_spill_round_trip_frees_the_card(cuda_device, tmp_path):
    import gc

    import numpy as np
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.arrow_bridge import (
        arrow_to_device, device_to_arrow)
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.memory import DeviceMemoryManager
    rng = np.random.default_rng(2)
    n = 1 << 20
    rb = pa.record_batch({
        "a": pa.array(rng.integers(0, 1 << 40, n), pa.int64()),
        "b": pa.array(rng.normal(size=n), pa.float64()),
        "s": pa.array([f"k{v}" for v in rng.integers(0, 999, n)])})
    mm = DeviceMemoryManager(RapidsConf({
        "spark.rapids.memory.device.budgetBytes": 1 << 30,
        "spark.rapids.memory.host.spillStorageSize": 1,
        "spark.rapids.memory.spillDir": str(tmp_path)}), cuda_device)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    sb = mm.register(arrow_to_device(rb, None, cuda_device))
    held = torch.cuda.memory_allocated() - base
    assert held >= sb.nbytes > 0
    sb.spill()  # to the host, and on to a sealed disk file
    assert sb.on_disk and mm.device_bytes == 0
    torch.cuda.synchronize()
    freed = base + held - torch.cuda.memory_allocated()
    assert freed >= 0.9 * sb.nbytes
    back = sb.get()
    assert back.device == cuda_device
    assert device_to_arrow(back).equals(rb)
    sb.release()
    del back
    gc.collect()
    assert mm.device_bytes == 0 and mm.disk_in_use_bytes == 0
    assert torch.cuda.memory_allocated() <= base + (1 << 20)


def test_nested_gathers_match_their_plain_versions(cuda_device):
    """K4 moving a struct's children and a list's elements (a second
    launch a list level), and K3 then K4 compacting the ticket batch,
    bit for bit against the same calls on CPU tensors."""
    from spark_rapids_tpu_torch.ops import kernel_checks as kc
    recs = kc.check_nested_gather(cuda_device)
    assert all(r["equal"] for r in recs)
    launches = {r["case"]: r["k4_launches"] for r in recs}
    assert launches["nested_gather_t_customer"] == 1
    assert launches["nested_gather_array<array<int32>>"] == 3


def test_nested_texts_on_the_card_match_their_oracle(cuda_device,
                                                     tmp_path):
    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.tools import nds_nested as nn
    tables = nn.nested_tables(nds.gen_tables(1 << 14))
    paths = nn.write_tables(tables, str(tmp_path))
    for q in nn.QUERIES:
        for parts in (1, 16):
            s = nds.session_over_files(
                paths, {"spark.sql.shuffle.partitions": str(parts)},
                cuda_device)
            nn.check(q, nn.plan(s, q).collect(), tables)
