"""Device page decode, the port against the JAX package on the CPU.

The same Parquet files, written from a seed, go through the JAX host
planner and decode program (``spark_rapids_tpu/io/parquet_device.py``:
``plan_chunk``, ``merge_chunk_plans``, ``_expand``, ``_decode_device``) and
through the port's (``io/parquet_plan.py``, ``ops/parquet_decode.py``),
with files shaped like the JAX package's own device-decode tests
(``tests/test_io.py:108`` matrix, ``:200`` coalesced, ``:289``
BYTE_STREAM_SPLIT, ``:311`` v2 pages, ``:369`` DELTA). Plans must be
equal field by field, decodes bit for bit, the port's device-decode scan
equal to its host-decode scan, and the chunk counters equal to the JAX
scan's. Everything here is exact: no tolerance.
"""
import os

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import datatypes as jdt
from spark_rapids_tpu.config import RapidsConf as JConf
from spark_rapids_tpu.exec.base import ExecCtx as JCtx
from spark_rapids_tpu.io import TpuFileScanExec
from spark_rapids_tpu.io import parquet_device as jpd
from spark_rapids_tpu_torch import datatypes as tdt
from spark_rapids_tpu_torch.columnar.arrow_bridge import engine_schema
from spark_rapids_tpu_torch.config import RapidsConf as TConf
from spark_rapids_tpu_torch.exec.base import ExecCtx as TCtx
from spark_rapids_tpu_torch.exec.base import collect_arrow
from spark_rapids_tpu_torch.io import parquet_plan as tpp
from spark_rapids_tpu_torch.io.scan import GpuFileScanExec
from spark_rapids_tpu_torch.ops import parquet_decode as tpd


def _matrix(rng, n):
    return {
        "dict_i32": pa.array(rng.integers(0, 9, n).astype(np.int32)),
        "dict_f32": pa.array((rng.integers(0, 7, n) / 8)
                             .astype(np.float32)),
        "plain_f64": pa.array(rng.uniform(0, 1, n)),
        "i64": pa.array(rng.integers(-(1 << 40), 1 << 40, n)),
        "b": pa.array(rng.integers(0, 2, n).astype(bool)),
        "date": pa.array(rng.integers(8000, 9000, n).astype(np.int32))
        .cast(pa.date32()),
        "rle_sorted": pa.array(np.sort(rng.integers(0, 4, n))
                               .astype(np.int64)),
        "null_i32": pa.array(rng.integers(0, 50, n).astype(np.int32),
                             mask=rng.uniform(0, 1, n) < 0.25),
        "all_null": pa.array([None] * n, type=pa.int64()),
        "s": pa.array(["x" + str(i % 13) for i in range(n)]),
    }


def _write(d, name, arrays, **kw):
    path = os.path.join(str(d), name)
    pq.write_table(pa.table(arrays), path, **kw)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """``{case: (path, coalesce)}``; ``coalesce`` merges each file's row
    groups into one plan, as the coalesced scan does."""
    d = tmp_path_factory.mktemp("pdec")
    rng = np.random.default_rng(7)
    out = {}
    for codec in ("snappy", "zstd"):
        out[f"matrix_{codec}"] = (_write(
            d, f"m_{codec}.parquet", _matrix(rng, 30_000),
            row_group_size=8000, compression=codec,
            dictionary_pagesize_limit=32 << 10,
            data_page_size=8 << 10), False)
    n = 16_000
    grp = np.arange(n) // 3000
    out["coalesced"] = (_write(d, "c.parquet", {
        "ni": pa.array(rng.integers(-1000, 1000, n).astype(np.int32),
                       mask=rng.random(n) < 0.3),
        "l": pa.array(rng.integers(-(1 << 50), 1 << 50, n)),
        "d": pa.array(rng.standard_normal(n), mask=rng.random(n) < 0.1),
        "b": pa.array(rng.random(n) < 0.5),
        # heterogeneous dictionaries: each row group's value set differs
        "dict_i32": pa.array((rng.integers(0, 7, n) + grp * 1000)
                             .astype(np.int32)),
        "rle": pa.array(np.sort(rng.integers(0, 5, n)).astype(np.int64)),
        "plain_f32": pa.array(rng.uniform(0, 1, n).astype(np.float32)),
    }, row_group_size=3000, compression="snappy"), True)
    out["bss"] = (_write(d, "enc.parquet", {
        "delta": pa.array(rng.integers(0, 1 << 30, 5000).astype(np.int64)),
        "bss": pa.array(rng.uniform(0, 1, 5000).astype(np.float32)),
        "ok": pa.array(rng.integers(0, 5, 5000).astype(np.int32)),
    }, use_dictionary=False, column_encoding={
        "delta": "DELTA_BINARY_PACKED", "bss": "BYTE_STREAM_SPLIT",
        "ok": "PLAIN"}), False)
    n = 12_000
    out["v2"] = (_write(d, "v2.parquet", {
        "i32": pa.array(rng.integers(0, 9, n).astype(np.int32)),
        "ni64": pa.array(rng.integers(0, 60, n).astype(np.int64),
                         mask=rng.uniform(0, 1, n) < 0.3),
        "s": pa.array([None if i % 9 == 0 else f"v{i % 13}"
                       for i in range(n)]),
        "b": pa.array(rng.integers(0, 2, n).astype(bool)),
        "all_null": pa.array([None] * n, type=pa.int32()),
    }, data_page_version="2.0", row_group_size=4000, compression="zstd",
        data_page_size=4 << 10), False)
    n = 16_000
    out["delta"] = (_write(d, "delta.parquet", {
        "d32": pa.array((rng.integers(-100, 100, n).cumsum()
                         % 1_000_000).astype(np.int32)),
        "d64": pa.array(rng.integers(-1000, 1000, n).cumsum()
                        .astype(np.int64), mask=rng.uniform(0, 1, n) < 0.2),
        "dls": pa.array([None if i % 11 == 0 else
                         ["", f"dl-{i % 53}", "長い" * (i % 4)][i % 3]
                         for i in range(n)]),
    }, use_dictionary=False, compression="snappy", row_group_size=4000,
        data_page_size=4 << 10, column_encoding={
            "d32": "DELTA_BINARY_PACKED", "d64": "DELTA_BINARY_PACKED",
            "dls": "DELTA_LENGTH_BYTE_ARRAY"}), True)
    return out


def _plans(path, module, dtypes, merge):
    """``{column: plan or fallback reason}``, per row group or merged."""
    pf = pq.ParquetFile(path)
    md = pf.metadata
    per_rg = []
    with open(path, "rb") as f:
        for g in range(md.num_row_groups):
            rg = md.row_group(g)
            plans = {}
            for ci in range(md.num_columns):
                name = md.schema.column(ci).name
                try:
                    plans[name] = module.plan_chunk(
                        f, rg.column(ci), pf.schema.column(ci),
                        dtypes.from_arrow(pf.schema_arrow.field(name).type),
                        pf.schema_arrow.field(name).type)
                except module.HostFallback as e:
                    plans[name] = e.reason
            per_rg.append(plans)
    if not merge:
        return per_rg
    return [{k: v if isinstance(v, str) else module.merge_chunk_plans(
        [p[k] for p in per_rg]) for k, v in per_rg[0].items()}]


_FIELDS = ("n_rows", "lane", "dictionary", "packed", "runs", "def_packed",
           "def_runs", "n_valid", "has_nulls", "encoded_bytes", "str_dict",
           "str_char_cap", "str_max_len", "is_delta", "str_bound")


def _same(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


CASES = ["matrix_snappy", "matrix_zstd", "coalesced", "bss", "v2", "delta"]


@pytest.mark.parametrize("case", CASES)
def test_plan_chunk_matches_reference(files, case):
    path, merge = files[case]
    want = _plans(path, jpd, jdt, merge)
    got = _plans(path, tpp, tdt, merge)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for name in w:
            if isinstance(w[name], str):
                assert g[name] == w[name], (case, name)
                continue
            for field in _FIELDS:
                assert _same(getattr(g[name], field),
                             getattr(w[name], field)), (case, name, field)
    if case == "bss":
        assert want[0]["bss"] == "encoding"
        assert not isinstance(want[0]["delta"], str)


def _torch_words(a):
    return torch.from_numpy(a.astype(np.int64))


def _decode_both(plan, cap):
    """(JAX values, JAX validity, port values, port validity) as numpy."""
    dictionary = plan.dictionary if plan.dictionary.shape[0] \
        else np.zeros(1, plan.lane)
    if plan.lane == np.bool_:
        jdict, tdict = jnp.zeros(1, jnp.bool_), torch.zeros(1,
                                                            dtype=torch.bool)
    else:
        jdict, tdict = jnp.asarray(dictionary), torch.from_numpy(
            dictionary.copy())
    jv, jvalid = jpd._decode_device(
        jnp.asarray(plan.packed), jnp.asarray(plan.runs), jdict,
        jnp.asarray(plan.def_packed), jnp.asarray(plan.def_runs),
        plan.n_rows, cap, delta=plan.is_delta)
    tv, tvalid = tpd.decode_chunk_torch(
        _torch_words(plan.packed), torch.from_numpy(plan.runs), tdict,
        _torch_words(plan.def_packed), torch.from_numpy(plan.def_runs),
        plan.n_rows, cap, delta=plan.is_delta)
    return (np.asarray(jv), np.asarray(jvalid), tv.numpy(), tvalid.numpy())


@pytest.mark.parametrize("case", CASES)
def test_decode_chunk_bit_exact_against_reference(files, case):
    path, merge = files[case]
    decoded = 0
    for plans in _plans(path, tpp, tdt, merge):
        for name, plan in plans.items():
            if isinstance(plan, str) or plan.str_dict is not None:
                continue
            cap = 1 << max(7, (plan.n_rows - 1).bit_length())
            jv, jvalid, tv, tvalid = _decode_both(plan, cap)
            assert np.array_equal(jvalid, tvalid), (case, name)
            assert jv.dtype == tv.dtype, (case, name)
            assert np.array_equal(jv.view(np.uint8), tv.view(np.uint8)), \
                (case, name)
            decoded += 1
    assert decoded >= 2


def _runs(rows):
    return np.asarray(rows, np.int64).reshape(-1, 4)


def test_expand_at_the_funnel_shift_boundaries():
    """Hand-made run tables over words with the top bit set: bit-packed
    widths up to 32 at every shift up to 31 (shift + width up to 63, the
    int64 window negative), 32- and 64-bit PLAIN regions (the latter
    starting on an odd word), RLE, identity and dictionary runs with a
    merged group's base in meta bits 16+, and DELTA runs restarted at
    each RLE run. The port's int64 emulation must give JAX's uint64 bits."""
    rng = np.random.default_rng(3)
    words = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    words[::3] |= np.uint32(1 << 31)
    rows, start, bit = [], 0, 0
    for width in (1, 3, 7, 17, 24, 31, 32):
        for sh in (0, 1, 17, 31):
            rows.append((start, width | (1 << 9) * (width <= 24)
                         | ((5 << 16) if width == 7 else 0), 0, bit + sh))
            start += 40
            bit += 40 * 32 + 64
    rows.append((start, 32, 0, bit))  # PLAIN 32
    start += 16
    rows.append((start, 64, 0, 32 * 101))  # PLAIN 64 from an odd word
    start += 16
    rows.append((start, 1 << 8, 123456789, 0))  # RLE
    start += 5
    rows.append((start, 1 << 10, 77, 0))  # identity
    start += 9
    tab = _runs(rows)
    idx = np.arange(start + 3, dtype=np.int64)
    jbits, jdict = jpd._expand(jnp.asarray(words), jnp.asarray(tab),
                               jnp.asarray(idx))
    tbits, tdict = tpd.expand_runs_torch(_torch_words(words),
                                         torch.from_numpy(tab),
                                         torch.from_numpy(idx))
    assert np.array_equal(np.asarray(jbits).view(np.int64), tbits.numpy())
    assert np.array_equal(np.asarray(jdict), tdict.numpy())
    # DELTA: two pages, each a first-value RLE run then bit-packed deltas
    # whose min delta is negative, so the sums wrap below zero
    dtab = _runs([(0, 1 << 8, -5, 0), (1, 9 | (1 << 11), -300, 0),
                  (50, 1 << 8, 1 << 40, 0), (51, 13 | (1 << 11), -4096,
                                             64 * 32)])
    didx = np.arange(120, dtype=np.int64)
    jd, _ = jpd._expand(jnp.asarray(words), jnp.asarray(dtab),
                        jnp.asarray(didx), delta=True)
    td, _ = tpd.expand_runs_torch(_torch_words(words),
                                  torch.from_numpy(dtab),
                                  torch.from_numpy(didx), delta=True)
    assert np.array_equal(np.asarray(jd).view(np.int64), td.numpy())


def _schema_without_strings(path):
    s = engine_schema(pq.ParquetFile(path).schema_arrow)
    return tdt.Schema([f for f in s.fields
                       if not isinstance(f.dtype, tdt.StringType)])


def _canon(table):
    import math
    return {k: ["NaN" if isinstance(v, float) and math.isnan(v) else v
                for v in vals] for k, vals in table.to_pydict().items()}


@pytest.mark.parametrize("target", ["0", "1g"], ids=["per_group",
                                                      "coalesced"])
@pytest.mark.parametrize("case", CASES)
def test_device_decode_scan_matches_host_decode_and_reference(files, case,
                                                              target):
    """The port's device-decode scan against its own host-decode scan
    (bit for bit, via Arrow), and its chunk counters against the JAX
    scan's over the same columns."""
    path, _ = files[case]
    schema = _schema_without_strings(path)
    settings = {"spark.rapids.sql.scan.coalesceTargetBytes": target}
    ctx = TCtx(TConf(settings), device="cpu")
    scan = GpuFileScanExec([path], schema=schema)
    got = collect_arrow(scan, ctx)
    host = collect_arrow(GpuFileScanExec([path], schema=schema), TCtx(TConf(
        {**settings,
         "spark.rapids.sql.format.parquet.deviceDecode.enabled": "false"}),
        device="cpu"))
    assert _canon(got) == _canon(host)
    m = ctx.metrics[scan.node_label()]
    jctx = JCtx(JConf(settings))
    jscan = TpuFileScanExec([path], columns=schema.names,
                            conf=JConf(settings))
    for _ in jscan.execute(jctx):
        pass
    jm = jctx.metrics[jscan.node_label()]
    for name in ("deviceChunks", "fallbackChunks", "scanPrograms"):
        assert m[name].value == jm[name].value, (name, m[name].value,
                                                 jm[name].value)
    assert m["numOutputRows"].value == got.num_rows
    if case == "bss":
        assert m["fallbackChunks"].value == 1
        assert m["fallbackChunks.encoding"].value == 1
    else:
        assert m["fallbackChunks"].value == 0


def test_layout_places_every_part_in_the_blob(files):
    """The blob's prefix holds every encoded part and the host columns;
    the suffix the decoded columns and the scans' scratch; all 16-byte
    aligned and disjoint."""
    path, _ = files["v2"]
    scan = GpuFileScanExec([path], schema=_schema_without_strings(path))
    layout = scan.batch_layouts(TConf())[0]
    spans = [(start, start + arr.nbytes) for start, arr in layout._parts]
    for d in layout.desc:
        w = int(d["out_bytes"])
        spans.append((int(d["out"]), int(d["out"]) + layout.capacity * w))
        if d["valid"] >= 0:
            spans.append((int(d["valid"]), int(d["valid"])
                          + layout.capacity))
    for j in layout.jobs:
        spans += [(int(j["vals"]), int(j["vals"]) + 8 * int(j["n"])),
                  (int(j["flags"]), int(j["flags"]) + int(j["n"]))]
    spans.sort()
    assert all(a % 16 == 0 for a, _ in spans)
    assert all(b0 <= a1 for (_, b0), (a1, _) in zip(spans, spans[1:]))
    assert spans[-1][1] <= layout.total_bytes
    assert all(b <= layout.prefix_bytes for start, arr in layout._parts
               for b in [start + arr.nbytes])
    # a nullable column has a scan job for its dense index
    assert len(layout.jobs) == sum(p.has_nulls for p in layout.plans.values())


def test_decode_batch_checks_its_blob():
    from spark_rapids_tpu_torch.columnar.batch import bucket_rows
    schema = tdt.Schema([tdt.StructField("x", tdt.INT32, True)])
    layout = tpd.BatchLayout(schema, bucket_rows(3), 3, {},
                             {"x": (np.arange(3, dtype=np.int32), None)})
    short = torch.zeros(layout.total_bytes - 1, dtype=torch.uint8)
    with pytest.raises(ValueError, match="at least"):
        tpd.decode_batch(short, layout)
    blob = torch.zeros(layout.total_bytes, dtype=torch.uint8)
    layout.fill(blob.numpy()[:layout.prefix_bytes])
    before = tpd.decode_batch.launches
    (col,) = tpd.decode_batch(blob, layout)
    assert col.data[:3].tolist() == [0, 1, 2] and col.validity is None
    assert tpd.decode_batch.launches == before  # nothing to launch
