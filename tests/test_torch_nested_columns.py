"""Nested columns on the CPU: the port's struct, array and map layouts
held to the JAX package on the same seeded batches
(``tests/data_gen.py``'s generators, ``NESTED_GENS`` of
``tests/test_complex_types.py``).

- ``arrow_to_device``/``device_to_arrow`` round-trip every generator's
  type, Arrow types equal (a map comes back as ``pa.map_``) and values
  equal to the reference's round trip;
- a filter's compaction (``compact_batch``: K3's plain version, then
  K4's) keeps the rows the reference's ``TpuFilterExec`` keeps;
- a gather by random rows with dead rows, the concat of batches with
  absolute offsets (split halves) and the coalesce, against the
  reference's concat;
- split-and-retry's halving (``memory.split_batch``), a struct's children
  with its rows, an array's elements shared, and the ledger's bytes
  counting children; a spill's download and upload;
- the transitions carry nested columns both ways;
- the nested Parquet scan on both paths: the rows pyarrow reads, a
  nested column a host chunk of reason ``nested`` on the device-decode
  path, the flat ones device chunks; the reference's device-decode scan
  reads a nested column as nulls and counts no chunk for it (ROADMAP
  queue C), so its rows are taken with device decode off.
"""
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from data_gen import (ArrayGen, DoubleGen, IntegerGen, LongGen, MapGen,
                      StringGen, StructGen, gen_table)
from asserts import _norm_nested as _norm
from test_complex_types import NESTED_GENS

from spark_rapids_tpu.columnar.arrow_bridge import \
    arrow_to_device as j_to_device
from spark_rapids_tpu.columnar.arrow_bridge import \
    device_to_arrow as j_to_arrow
from spark_rapids_tpu.exec import HostBatchSourceExec as JSource
from spark_rapids_tpu.exec import TpuFilterExec
from spark_rapids_tpu.exec.exchange import TpuCoalesceBatchesExec
from spark_rapids_tpu.expr import GreaterThan as JGt
from spark_rapids_tpu.expr import Literal as JLit
from spark_rapids_tpu.expr import UnresolvedColumn as jcol
from spark_rapids_tpu.planner import overrides
from spark_rapids_tpu import datatypes as jdt

from spark_rapids_tpu_torch import datatypes as tdt
from spark_rapids_tpu_torch.columnar.arrow_bridge import (arrow_to_device,
                                                          device_to_arrow)
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exec.base import ExecCtx, HostBatchSourceExec, \
    collect_arrow
from spark_rapids_tpu_torch.io.scan import GpuFileScanExec
from spark_rapids_tpu_torch.memory import DeviceMemoryManager, split_batch
from spark_rapids_tpu_torch.ops.concat import concat_batches_bounded
from spark_rapids_tpu_torch.ops.gather import compact_batch, gather_batch

CPU = torch.device("cpu")
IDS = [g.dtype.simple_string()[:40] for g in NESTED_GENS]


def _up(rb):
    return arrow_to_device(rb, None, CPU)


def _rows(rb_or_table):
    return _norm(rb_or_table.to_pylist())


@pytest.mark.parametrize("gen", NESTED_GENS, ids=IDS)
def test_round_trip_keeps_types_and_values(gen):
    rb = gen_table([gen, IntegerGen()], 300, seed=5)
    out = device_to_arrow(_up(rb))
    out.validate(full=True)
    assert out.schema == rb.schema
    ref = j_to_arrow(j_to_device(rb))
    assert out.schema.types == ref.schema.types
    assert _rows(out) == _rows(ref) == _rows(rb)


@pytest.mark.parametrize("gen", NESTED_GENS, ids=IDS)
def test_filter_compaction_matches_reference(gen):
    rb = gen_table([gen, IntegerGen(null_frac=0.0)], 250, seed=77)
    b = _up(rb)
    got = device_to_arrow(compact_batch(b, b.columns[1].data > 0))
    want = overrides(TpuFilterExec(JGt(jcol("c1"), JLit(0, jdt.INT32)),
                                   JSource([rb]))).collect()
    assert got.schema == want.schema
    assert _rows(got) == _rows(want)


@pytest.mark.parametrize("gen", NESTED_GENS, ids=IDS)
def test_gather_with_dead_rows(gen):
    rb = gen_table([gen, LongGen()], 200, seed=9)
    b = _up(rb)
    rng = np.random.default_rng(3)
    idx = np.r_[rng.permutation(rb.num_rows),
                np.arange(rb.num_rows, b.capacity)].astype(np.int32)
    keep = int(rb.num_rows * 0.6)
    got = device_to_arrow(gather_batch(b, torch.from_numpy(idx), keep))
    want = rb.take(pa.array(idx[:keep]))
    assert _rows(got) == _rows(want)


@pytest.mark.parametrize("gen", NESTED_GENS, ids=IDS)
def test_concat_of_halves_and_batches(gen):
    rbs = [gen_table([gen, IntegerGen()], n, seed=40 + n)
           for n in (60, 128, 33)]
    b = _up(rbs[1])
    lo, hi = split_batch(b)
    parts = [_up(rbs[0]), hi, lo, _up(rbs[2])]
    got = device_to_arrow(concat_batches_bounded(parts))
    want = pa.Table.from_batches([rbs[0], rbs[1].slice(64), rbs[1]
                                  .slice(0, 64), rbs[2]])
    assert _rows(got) == _rows(want)


def test_coalesce_matches_reference():
    from spark_rapids_tpu_torch.exec.exchange import GpuCoalesceBatchesExec
    rbs = [gen_table([ArrayGen(IntegerGen(null_frac=0.2), null_frac=0.2),
                      StructGen([("a", LongGen()),
                                 ("b", StringGen(max_len=6))]),
                      MapGen(StringGen(max_len=4, nullable=False),
                             LongGen()),
                      StringGen(max_len=5)], 60, seed=30 + i)
           for i in range(4)]
    want = overrides(TpuCoalesceBatchesExec(JSource(rbs),
                                            target_rows=150)).collect()
    got = collect_arrow(GpuCoalesceBatchesExec(HostBatchSourceExec(rbs),
                                               target_rows=150),
                        ExecCtx(device="cpu"))
    assert got.schema == want.schema
    assert _rows(got) == _rows(want)


def test_split_halves_and_the_ledger():
    """A struct's children split with its rows, an array's elements stay
    shared (absolute offsets), and the bytes count every child."""
    rb = gen_table([StructGen([("a", IntegerGen()),
                               ("b", StringGen(max_len=6))]),
                    ArrayGen(ArrayGen(IntegerGen(), max_len=3)),
                    MapGen(StringGen(max_len=4, nullable=False),
                           LongGen())], 200, seed=11)
    b = _up(rb)
    lo, hi = split_batch(b)
    assert lo.row_count == 128 and hi.row_count == 72
    assert lo.columns[0].children[0].capacity == 128
    assert hi.columns[1].children[0] is b.columns[1].children[0]
    got = pa.Table.from_batches([device_to_arrow(lo), device_to_arrow(hi)])
    assert _rows(got) == _rows(rb)
    arrays = b.columns[1].arrays()
    assert len(arrays) == 6  # validity, offsets; elements' 2; ints' 2
    assert b.device_size_bytes() == sum(
        a.numel() * a.element_size() for c in b.columns for a in c.arrays())
    assert b.device_size_bytes() > sum(
        a.numel() * a.element_size() for c in b.columns
        for a in (c.validity, c.offsets, c.data) if a is not None)


def test_spill_download_and_upload():
    rb = gen_table([ArrayGen(StringGen(max_len=5)),
                    StructGen([("in", StructGen([("x", DoubleGen())]))])],
                   150, seed=13)
    mm = DeviceMemoryManager.host()
    sb = mm.register(_up(rb))
    try:
        sb.spill()
        assert not sb.on_device
        back = sb.get()
        assert _rows(device_to_arrow(back)) == _rows(rb)
    finally:
        sb.release()


def test_transitions_carry_nested_columns():
    """A sort by a struct runs on the CPU between the transitions: the
    nested columns go down and come back up."""
    from spark_rapids_tpu_torch.exec.basic import GpuProjectExec
    from spark_rapids_tpu_torch.exec.sort import GpuSortExec, SortOrder
    from spark_rapids_tpu_torch.expr import GetStructField
    from spark_rapids_tpu_torch.expr import UnresolvedColumn as tcol
    from spark_rapids_tpu_torch.expr.base import Alias
    from spark_rapids_tpu_torch.planner import GpuOverrides
    rb = gen_table([StructGen([("a", IntegerGen(min_val=0, max_val=5))]),
                    ArrayGen(LongGen())], 120, seed=21)
    plan = GpuProjectExec(
        [tcol("c0"), tcol("c1"),
         Alias(GetStructField(tcol("c0"), "a"), "a")],
        GpuSortExec([SortOrder(tcol("c0"))], HostBatchSourceExec([rb])))
    pp = GpuOverrides(device="cpu").apply(plan)
    assert pp.fallback_nodes() == ["SortExec"]
    ctx = ExecCtx(device="cpu")
    got = pp.collect(ctx)
    names = set(ctx.metrics)
    assert any(n.startswith("DeviceToHostExec") for n in names)
    assert any(n.startswith("HostToDeviceExec") for n in names)
    keys = [(r is not None, None if r is None else r["a"])
            for r in got.column("c0").to_pylist()]
    assert keys == sorted(keys, key=lambda k: (k[0], k[1] is not None,
                                               k[1] or 0))
    assert sorted(map(repr, _norm(got.select(["c0", "c1"]).to_pylist()))) \
        == sorted(map(repr, _rows(rb)))


@pytest.fixture(scope="module")
def nested_file(tmp_path_factory):
    rb = gen_table([LongGen(nullable=False),
                    StructGen([("sk", LongGen()), ("by", IntegerGen())]),
                    ArrayGen(StructGen([("i", LongGen()),
                                        ("p", DoubleGen())])),
                    MapGen(StringGen(max_len=4, nullable=False),
                           IntegerGen()),
                    StringGen(max_len=6)], 400, seed=3,
                   names=["k", "s", "l", "m", "t"])
    path = str(tmp_path_factory.mktemp("nested") / "n.parquet")
    pq.write_table(pa.Table.from_batches([rb]), path, row_group_size=150)
    return path, rb


@pytest.mark.parametrize("device_decode", ["true", "false"])
def test_nested_scan_on_both_paths(nested_file, device_decode):
    path, rb = nested_file
    conf = RapidsConf({"spark.rapids.sql.format.parquet.deviceDecode"
                       ".enabled": device_decode})
    ctx = ExecCtx(conf, "cpu")
    got = collect_arrow(GpuFileScanExec([path]), ctx)
    assert got.equals(pa.Table.from_batches([rb]).combine_chunks()
                      .cast(got.schema))
    (label, m), = [(k, v) for k, v in ctx.metrics.items()
                   if k.startswith("FileScanExec")]
    if device_decode == "true":
        # 3 row groups: k and t on K5, s, l and m host chunks
        assert m["deviceChunks"].value == 3 * 2
        assert m["fallbackChunks"].value == 3 * 3
        assert m["fallbackChunks.nested"].value == 3 * 3
    else:
        assert "deviceChunks" not in m


def test_reference_reads_nested_columns_as_nulls_on_device_decode(
        nested_file):
    """The departure this port does not copy: the reference looks a
    column's chunk up by its leaf name, misses a nested one and fills it
    with nulls, counting no chunk; its device chunks equal the port's."""
    from spark_rapids_tpu.config import RapidsConf as JConf
    from spark_rapids_tpu.exec.base import ExecCtx as JCtx
    from spark_rapids_tpu.io.scan import TpuFileScanExec
    path, rb = nested_file
    jctx = JCtx(JConf({}))
    want = overrides(TpuFileScanExec([path])).collect(jctx)
    assert want.column("s").null_count == want.num_rows
    assert want.column("k").equals(pa.chunked_array([rb.column(0)]))
    jm = [v for k, v in jctx.metrics.items()
          if k.startswith("FileScanExec")][0]
    ctx = ExecCtx(RapidsConf({}), "cpu")
    collect_arrow(GpuFileScanExec([path]), ctx)
    m = [v for k, v in ctx.metrics.items()
         if k.startswith("FileScanExec")][0]
    assert m["deviceChunks"].value == jm["deviceChunks"].value
    assert jm["fallbackChunks"].value == 0
    assert m["fallbackChunks"].value == 9


def test_map_keys_are_refused_as_sort_keys():
    """Spark orders no map: the key check refuses it as the sort is
    built (a struct or array key is placed on the CPU instead)."""
    from spark_rapids_tpu_torch.exec.sort import GpuSortExec, SortOrder
    from spark_rapids_tpu_torch.expr import UnresolvedColumn as tcol
    rb = gen_table([MapGen(StringGen(max_len=4, nullable=False),
                           LongGen())], 10, seed=1)
    with pytest.raises(NotImplementedError, match="map"):
        GpuSortExec([SortOrder(tcol("c0"))], HostBatchSourceExec([rb]))
    assert tdt.is_nested(HostBatchSourceExec([rb]).output_schema[0].dtype)
