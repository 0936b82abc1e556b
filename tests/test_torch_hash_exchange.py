"""Murmur3, hash partitioning, the local exchange and the adaptive
reader, the port against the JAX package on the CPU.

Hashes and partition ids must equal the reference's bit for bit
(``hash_columns_numpy``, ``hash_columns_device``, ``HashPartitioning``)
over every fixed-width type and strings, with nulls, ``-0.0``, NaN and
the extremes. An exchange plus aggregate gives the same rows as the
reference's with 1 and 16 partitions and with the adaptive reader on
and off (sums at rel 1e-12, a one-row group's sum its row's value
exactly, keys and counts exactly). A coalesced group's read is one view
a map batch; under a budget the transport keeps the map batch its taker
holds pinned."""
import math

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import datatypes as jdt
from spark_rapids_tpu.columnar.arrow_bridge import arrow_to_device as j_up
from spark_rapids_tpu.exec.aqe import plan_partition_groups as jplan
from spark_rapids_tpu.exec.base import ExecCtx as JCtx
from spark_rapids_tpu.ops.hash import hash_columns_device, hash_columns_numpy
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.shuffle.partitioner import HashPartitioning as JHash
from spark_rapids_tpu.expr import UnresolvedColumn as jcol
from spark_rapids_tpu.expr.aggregates import Count as JCount
from spark_rapids_tpu.expr.aggregates import Sum as JSum
from spark_rapids_tpu.expr.base import Alias as JAlias
from spark_rapids_tpu_torch import datatypes as tdt
from spark_rapids_tpu_torch.columnar import arrow_to_device
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exec.aqe import plan_partition_groups
from spark_rapids_tpu_torch.exec.base import ExecCtx, HostBatchSourceExec
from spark_rapids_tpu_torch.exec.exchange import GpuShuffleExchangeExec
from spark_rapids_tpu_torch.expr import UnresolvedColumn as tcol
from spark_rapids_tpu_torch.expr.aggregates import Count, Sum
from spark_rapids_tpu_torch.expr.base import Alias
from spark_rapids_tpu_torch.ops.hash import hash_columns, pmod
from spark_rapids_tpu_torch.session import GpuSession
from spark_rapids_tpu_torch.shuffle.partitioner import HashPartitioning
from spark_rapids_tpu_torch.shuffle.transport import LocalShuffleTransport

N = 600


def _table(seed):
    rng = np.random.default_rng(seed)

    def masked(arr):
        return pa.array(arr, mask=rng.uniform(0, 1, N) < 0.15)

    i32 = rng.integers(-50, 50, N).astype(np.int32)
    i32[:4] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, 0, -1]
    i64 = rng.integers(-(1 << 62), 1 << 62, N)
    i64[:3] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0]
    f32 = rng.normal(0, 1e3, N).astype(np.float32)
    f32[:6] = [-0.0, 0.0, np.nan, np.inf, -np.inf, np.finfo(np.float32).max]
    f64 = rng.normal(0, 1e9, N)
    f64[:6] = [-0.0, 0.0, -np.nan, np.inf, -np.inf, 5e-324]
    words = ["", "a", "abcd", "abcde", "Electronics", "héllo", "長い",
             "\xff\x80", "x" * 33]
    return pa.table({
        "i8": masked(rng.integers(-128, 128, N).astype(np.int8)),
        "i16": masked(rng.integers(-3000, 3000, N).astype(np.int16)),
        "i32": masked(i32), "i64": masked(i64),
        "f32": masked(f32), "f64": masked(f64),
        "date": masked(rng.integers(-1000, 30000, N).astype(np.int32))
        .cast(pa.date32()),
        "ts": masked(rng.integers(0, 1 << 50, N)).cast(pa.timestamp("us")),
        "b": masked(rng.integers(0, 2, N).astype(bool)),
        "s": masked(np.array([words[i] for i in
                              rng.integers(0, len(words), N)], object)),
    })


COLUMNS = ["i8", "i16", "i32", "i64", "f32", "f64", "date", "ts", "b", "s"]


@pytest.mark.parametrize("names", [[c] for c in COLUMNS]
                         + [["i32", "s", "f64"], COLUMNS],
                         ids=COLUMNS + ["three", "all"])
def test_murmur3_matches_reference_bit_for_bit(names):
    t = _table(len(names))
    rb = t.select(names).combine_chunks().to_batches()[0]
    b = arrow_to_device(rb, None, "cpu")
    got = hash_columns(b.columns)[:N].numpy()
    types = [tdt.from_arrow(rb.schema.field(n).type) for n in names]
    jtypes = [jdt.from_arrow(rb.schema.field(n).type) for n in names]
    want = hash_columns_numpy([rb.column(i) for i in range(len(names))],
                              jtypes, N)
    assert np.array_equal(got, want)
    # the JAX CPU backend flushes subnormal floats to zero before it
    # hashes them (its numpy oracle, CPU Spark and the port do not), so
    # rows holding one are left out of the comparison with its device
    # path only
    sub = np.zeros(N, bool)
    for n, t in zip(names, types):
        if tdt.is_floating(t):
            v = rb.column(names.index(n)).to_numpy(zero_copy_only=False)
            sub |= (v != 0) & (np.abs(v) < np.finfo(v.dtype).tiny)
    jb = j_up(rb)
    dev = np.asarray(hash_columns_device(jb.columns))[:N]
    assert np.array_equal(got[~sub], dev[~sub])


@pytest.mark.parametrize("n", [1, 2, 7, 16, 200])
def test_partition_ids_match_reference(n):
    t = _table(n)
    rb = t.select(["i64", "s", "f32"]).combine_chunks().to_batches()[0]
    keys = ["i64", "s", "f32"]
    b = arrow_to_device(rb, None, "cpu")
    tp = HashPartitioning([tcol(k) for k in keys], n).bind(b.schema)
    got = tp.partition_ids(b, None)[:N].numpy()
    jb = j_up(rb)
    jp = JHash([jcol(k) for k in keys], n).bind(jb.schema)
    assert np.array_equal(got, np.asarray(jp.partition_ids_device(
        jb, JCtx().eval_ctx))[:N])
    assert np.array_equal(got, jp.partition_ids_cpu(rb, JCtx().eval_ctx))
    assert got.min() >= 0 and got.max() < n
    h = torch.tensor([-7, -1, 0, 5, -(1 << 31), (1 << 31) - 1],
                     dtype=torch.int32)
    assert pmod(h, 3).tolist() == [2, 2, 0, 2, 1, 1]


def test_exchange_partitions_hold_their_rows():
    t = _table(5).select(["i32", "s"])
    rbs = t.combine_chunks().to_batches(max_chunksize=250)
    src = HostBatchSourceExec(rbs)
    ex = GpuShuffleExchangeExec(HashPartitioning([tcol("s")], 7), src)
    ctx = ExecCtx(device="cpu")
    handle = ex.materialize(ctx)
    seen = []
    for p in range(7):
        for b in handle.read(p):
            pids = HashPartitioning([tcol("s")], 7).bind(
                b.schema).partition_ids(b, None)
            live = b.live_mask()
            assert bool((pids[live] == p).all())
            seen.append(int(live.sum()))
    assert sum(seen) == N
    handle.close()


def test_writer_side_stats_spread_bytes_by_live_rows():
    t = _table(6).select(["i32", "f64"])
    rbs = t.combine_chunks().to_batches(max_chunksize=300)
    tr = LocalShuffleTransport()
    ex = GpuShuffleExchangeExec(HashPartitioning([tcol("i32")], 4),
                                HostBatchSourceExec(rbs), transport=tr)
    handle = ex.materialize(ExecCtx(device="cpu"))
    stats = handle.partition_stats()
    assert stats is not None and len(stats) == 4
    assert abs(sum(stats) - tr.stage_bytes(handle.sid)) <= 4 * len(rbs)
    handle.close()


@pytest.mark.parametrize("seed", range(6))
def test_partition_group_planning_matches_reference(seed):
    rng = np.random.default_rng(seed)
    stats = [int(v) for v in rng.integers(0, 1 << 20, 16)]
    if seed % 2:
        stats[3] = 40 << 20
    for coalesce in (True, False):
        args = (stats, 3 << 20, 5, 1 << 20, coalesce)
        assert plan_partition_groups(*args) == jplan(*args)


def test_merge_views_unions_selections_of_one_batch():
    """A coalesced group's read: one view a map batch, sharing its
    buffers, whose live rows are the union of the group's partitions'."""
    t = _table(5).select(["i32", "s"])
    rbs = t.combine_chunks().to_batches(max_chunksize=250)
    ex = GpuShuffleExchangeExec(HashPartitioning([tcol("s")], 7),
                                HostBatchSourceExec(rbs))
    handle = ex.materialize(ExecCtx(device="cpu"))
    merged = list(handle.read_range(2, 4))
    assert len(merged) == len(rbs)
    for i, b in enumerate(merged):
        singles = [list(handle.read(p))[i] for p in (2, 3, 4)]
        assert all(x is y for v in singles
                   for x, y in zip(v.columns, b.columns))
        union = singles[0].live_mask() | singles[1].live_mask() \
            | singles[2].live_mask()
        assert torch.equal(b.live_mask(), union)
    assert sum(int(b.live_mask().sum()) for b in merged) == sum(
        int(b.live_mask().sum()) for p in (2, 3, 4) for b in handle.read(p))
    handle.close()


def test_the_map_batch_its_taker_holds_stays_pinned(tmp_path):
    """Under a budget smaller than a map batch, the ledger spills the
    batches written before, never the one the exchange's loop still
    holds; a read keeps the entry whose view it handed over pinned
    until it hands over the next, and unpins the one before."""
    t = _table(7).select(["i32", "f64"])
    rbs = t.combine_chunks().to_batches(max_chunksize=200)
    tr = LocalShuffleTransport()
    ctx = ExecCtx(RapidsConf({
        "spark.rapids.memory.device.budgetBytes": 1024,
        "spark.rapids.memory.spillDir": str(tmp_path)}), device="cpu")
    mm = ctx.mm
    ex = GpuShuffleExchangeExec(HashPartitioning([tcol("i32")], 4),
                                HostBatchSourceExec(rbs), transport=tr)
    handle = ex.materialize(ctx)
    entries = [e for _, e in sorted(tr._shuffles[handle.sid],
                                    key=lambda x: x[0])]
    assert len(entries) == len(rbs) >= 3

    def pinned(e):
        return mm._pin_counts.get(id(e._sb), 0) > 0

    # a write evicts the entry unpinned at the write before it: the last
    # two stay, the last pinned
    assert [e._sb.on_device for e in entries] \
        == [False] * (len(entries) - 2) + [True, True]
    assert [pinned(e) for e in entries] \
        == [False] * (len(entries) - 1) + [True]
    reader = handle.read(0)
    rows = int(next(reader).live_mask().sum())
    assert pinned(entries[0]) and entries[0]._sb.on_device
    assert not entries[-2]._sb.on_device and entries[-1]._sb.on_device
    assert not pinned(entries[-1])
    rows += int(next(reader).live_mask().sum())
    assert pinned(entries[1]) and not pinned(entries[0])
    rows += sum(int(b.live_mask().sum()) for b in reader)
    assert rows == sum(int(b.live_mask().sum()) for b in handle.read(0))
    assert mm.spill_bytes > 0 and mm.readback_count > 0
    handle.close()
    assert mm.device_bytes == 0 and not mm._pin_counts


def _reference_rows(t, parts, aqe):
    s = TpuSession(conf={"spark.sql.shuffle.partitions": str(parts),
                         "spark.sql.adaptive.enabled": aqe})
    df = s.create_dataframe(t).group_by("i16").agg(
        JAlias(JSum(jcol("f64")), "s"), JAlias(JCount(), "n"))
    return df.collect()


def _rows(table):
    return sorted(zip(*[table.column(c).to_pylist()
                        for c in table.column_names]),
                  key=lambda r: (r[0] is not None, r[0]))


@pytest.mark.parametrize("aqe", ["true", "false"])
@pytest.mark.parametrize("parts", [1, 16])
def test_exchange_and_aggregate_match_reference(parts, aqe):
    t = _table(11).select(["i16", "f64"])
    t = pa.Table.from_batches(t.combine_chunks().to_batches(
        max_chunksize=150))
    s = GpuSession({"spark.sql.shuffle.partitions": str(parts),
                    "spark.sql.adaptive.enabled": aqe}, device="cpu")
    df = s.create_dataframe(t).group_by("i16").agg(
        Alias(Sum(tcol("f64")), "s"), Alias(Count(), "n"))
    tree = df._plan().root.tree_string()
    assert ("AQEShuffleReadExec" in tree) == (aqe == "true")
    got = _rows(df.collect())
    want = _rows(_reference_rows(t, parts, aqe))
    assert [(k, n) for k, _, n in got] == [(k, n) for k, _, n in want]
    # a one-row group's sum is its row's value, exact, as in Spark (the
    # reference's block prefix difference absorbs a denormal); the other
    # groups' sums are the reference's, rel 1e-12
    alone = {}
    for k, v in zip(t.column("i16").to_pylist(), t.column("f64").to_pylist()):
        alone[k] = v if k not in alone else None
    for (k, a, n), (_, b, _) in zip(got, want):
        if n == 1 and alone[k] is not None:
            assert a == alone[k] or (math.isnan(a) and math.isnan(alone[k]))
            continue
        assert (a is None and b is None) or math.isclose(
            a, b, rel_tol=1e-12) or (math.isnan(a) and math.isnan(b))
