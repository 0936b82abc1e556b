"""K3 (the radix sort) and K4 (gather): their plain PyTorch versions
against the JAX package on the CPU, the wrappers' routing and input
checks, and the port's ``ops/sort_keys.py``, ``ops/segments.py`` and
``ops/gather.py`` against their JAX counterparts.

The CUDA editions run only on the card (``test_torch_gpu.py``); here the
wrappers must take the plain version for CPU tensors, never bump their
launch counts, and refuse tensors on any other device."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import spark_rapids_tpu.datatypes as jdt
from spark_rapids_tpu.columnar.column import TpuColumnVector
from spark_rapids_tpu.ops import gather as jgather
from spark_rapids_tpu.ops import segments as jseg
from spark_rapids_tpu.ops import sort_keys as jsk
from spark_rapids_tpu.ops.pallas_kernels import (gather_xla, sort_pallas,
                                                 sort_xla)
from spark_rapids_tpu_torch import datatypes as tdt
from spark_rapids_tpu_torch.columnar.column import GpuColumnVector
from spark_rapids_tpu_torch.ops import cuda_kernels as ck
from spark_rapids_tpu_torch.ops import gather as tgather
from spark_rapids_tpu_torch.ops import segments as tseg
from spark_rapids_tpu_torch.ops import sort_keys as tsk

I64_MIN = -(1 << 63)
TYPES = ["INT8", "INT16", "INT32", "INT64", "FLOAT32", "FLOAT64"]


def _values(name, n, rng):
    t = getattr(jdt, name)
    if name.startswith("FLOAT"):
        v = rng.choice([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1.5,
                        -2.25, 7.0], n).astype(t.np_dtype)
        v[: n // 2] = rng.standard_normal(n // 2) * 1e3
        return v
    info = np.iinfo(t.np_dtype)
    v = rng.integers(info.min, info.max, n, endpoint=True,
                     dtype=np.int64).astype(t.np_dtype)
    v[: n // 3] = rng.integers(-3, 3, n // 3)  # duplicates
    return v


def _cols(name, values, valid):
    """The same column in both packages."""
    jcol = TpuColumnVector(getattr(jdt, name), data=jnp.asarray(values),
                           validity=jnp.asarray(valid))
    tcol = GpuColumnVector(getattr(tdt, name), torch.from_numpy(values),
                           torch.from_numpy(valid))
    return jcol, tcol


# --- K3 ---------------------------------------------------------------------

@pytest.mark.parametrize("n,dtype", [(256, np.float32), (4096, np.float32),
                                     (1024, np.int32)])
def test_sort_keys_plain_matches_sort_xla_and_pallas(n, dtype):
    # the shapes and data of tests/test_exec.py's sort_pallas test
    rng = np.random.default_rng(5)
    for shape, dt_ in ((256, np.float32), (4096, np.float32),
                       (1024, np.int32)):
        if dt_ == np.float32:
            k = rng.uniform(-1e6, 1e6, shape).astype(dt_)
        else:
            k = rng.integers(-10**6, 10**6, shape).astype(dt_)
        if (shape, dt_) == (n, dtype):
            break
    want_xla = np.asarray(sort_xla(jnp.asarray(k)))
    want_pallas = np.asarray(sort_pallas(jnp.asarray(k), True))
    before = ck.sort_keys.launches
    got = ck.sort_keys(torch.from_numpy(k)).numpy()
    assert ck.sort_keys.launches == before
    assert (got == want_xla).all() and (got == want_pallas).all()


def test_sort_keys_plain_matches_sort_xla_at_ragged_length_with_nan():
    rng = np.random.default_rng(6)
    k = rng.uniform(-5, 5, 1001).astype(np.float32)
    k[::7] = np.nan
    k[::11] = -0.0
    k[::13] = -np.inf
    got = ck.sort_keys(torch.from_numpy(k)).numpy()
    want = np.asarray(sort_xla(jnp.asarray(k)))
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("n", [1, 2, 3, 300, 4097])
@pytest.mark.parametrize("kind", ["full64", "heavy_dup", "packed_lanes"])
def test_sort_pairs_plain_matches_stable_torch_sort(n, kind):
    rng = np.random.default_rng(n)
    if kind == "full64":
        keys = torch.from_numpy(rng.integers(I64_MIN, (1 << 63) - 1, n,
                                             dtype=np.int64))
    elif kind == "heavy_dup":
        keys = torch.from_numpy(rng.integers(0, 4, n))
    else:
        # the group-by's words: live bit, null bit, an int32 lane
        _, col = _cols("INT32", _values("INT32", n, rng),
                       rng.random(n) < 0.8)
        live = torch.from_numpy(rng.random(n) < 0.9)
        (keys,) = tsk.pack_words(tsk._key_lanes([col], [tsk.SortSpec()],
                                                live))
    before = ck.sort_pairs.launches
    got_k, got_p = ck.sort_pairs(keys)
    assert ck.sort_pairs.launches == before
    want_k, want_p = torch.sort(keys ^ I64_MIN, stable=True)
    assert torch.equal(got_k, want_k ^ I64_MIN)
    assert torch.equal(got_p.long(), want_p)


def test_sort_pairs_plain_orders_on_key_then_payload():
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 5, 777)
    pay = rng.integers(-50, 50, 777).astype(np.int32)
    got_k, got_p = ck.sort_pairs(torch.from_numpy(keys),
                                 torch.from_numpy(pay))
    order = np.lexsort((pay, keys))
    assert np.array_equal(got_k.numpy(), keys[order])
    assert np.array_equal(got_p.numpy(), pay[order])


# --- K4 ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_gather_plain_matches_gather_xla(dtype):
    rng = np.random.default_rng(8)
    table = rng.standard_normal(1 << 12).astype(dtype) if dtype == \
        np.float32 else rng.integers(-99, 99, 1 << 12).astype(dtype)
    idx = rng.integers(0, 1 << 12, 1 << 17).astype(np.int32)
    want = np.asarray(gather_xla(jnp.asarray(table), jnp.asarray(idx)))
    before = ck.gather.launches
    got = ck.gather(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    assert ck.gather.launches == before
    assert got.tobytes() == want.tobytes()


def test_gather_rows_plain_zeroes_dead_rows_and_masks_validity():
    rng = np.random.default_rng(9)
    col = torch.from_numpy(rng.standard_normal(64))
    valid = torch.from_numpy(rng.random(64) < 0.7)
    idx = torch.from_numpy(rng.integers(-10, 80, 500).astype(np.int32))
    live = torch.from_numpy(rng.random(500) < 0.6)
    before = ck.gather_rows.launches
    (out,), (ov,) = ck.gather_rows([col], [valid], idx, live)
    assert ck.gather_rows.launches == before
    j = idx.long().clamp(0, 63)
    assert torch.equal(out, torch.where(live, col[j], torch.zeros(())
                                        .double()))
    assert torch.equal(ov, valid[j] & live)
    (_,), (none_v,) = ck.gather_rows([col], [None], idx)
    assert none_v is None


def test_wrappers_refuse_mixed_devices():
    keys = torch.zeros(8, dtype=torch.int64)
    meta_pay = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="mixed"):
        ck.sort_pairs(keys, meta_pay)
    with pytest.raises(ValueError, match="mixed"):
        ck.gather_rows([torch.zeros(4)], [None],
                       torch.zeros(8, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="mixed"):
        ck.gather(torch.zeros(4), torch.zeros(8, dtype=torch.int32,
                                              device="meta"))
    with pytest.raises(ValueError, match="mixed"):
        ck.sort_keys(torch.zeros(8, device="meta"))


def test_wrapper_input_checks():
    with pytest.raises(ValueError, match="int64"):
        ck._check_sort_inputs(torch.zeros(8, dtype=torch.int32), None)
    with pytest.raises(ValueError, match="payload"):
        ck._check_sort_inputs(torch.zeros(8, dtype=torch.int64),
                              torch.zeros(7, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        ck._check_sort_inputs(torch.zeros(16, dtype=torch.int64)[::2], None)
    idx = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        ck._check_gather_inputs([torch.zeros(4)], [None], idx.long(), None)
    with pytest.raises(ValueError, match="validit"):
        ck._check_gather_inputs([torch.zeros(4)], [torch.ones(4)], idx,
                                None)
    with pytest.raises(ValueError, match="live"):
        ck._check_gather_inputs([torch.zeros(4)], [None], idx,
                                torch.ones(7, dtype=torch.bool))
    with pytest.raises(ValueError, match="columns must be"):
        ck._check_gather_inputs([torch.zeros(4), torch.zeros(5)],
                                [None, None], idx, None)
    with pytest.raises(ValueError, match="sort_keys"):
        ck.sort_keys(torch.zeros(8, dtype=torch.float64))


# --- sort keys, segments and gathers against the JAX package ----------------

@pytest.mark.parametrize("name", TYPES)
def test_orderable_int_matches_reference(name):
    rng = np.random.default_rng(10)
    v = _values(name, 300, rng)
    jcol, tcol = _cols(name, v, np.ones(300, bool))
    want = np.asarray(jsk.orderable_int(jcol))
    got = tsk.orderable_int(tcol).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # the unsigned lane keeps the order
    lane, width = tsk.key_lane_bits(tcol)
    u = lane.numpy().astype(np.uint64)
    assert width == v.dtype.itemsize * 8
    assert np.array_equal(np.argsort(u, kind="stable"),
                          np.argsort(want, kind="stable"))


@pytest.mark.parametrize("name", TYPES)
@pytest.mark.parametrize("spec", [(True, True), (False, False),
                                  (True, False)])
def test_sort_permutation_matches_reference(name, spec):
    rng = np.random.default_rng(11)
    n = 517
    v = _values(name, n, rng)
    valid = rng.random(n) < 0.85
    jcol, tcol = _cols(name, v, valid)
    live = rng.random(n) < 0.9
    jspec = jsk.SortSpec(*spec)
    tspec = tsk.SortSpec(*spec)
    want = np.asarray(jsk.sort_permutation([jcol], [jspec],
                                           jnp.asarray(live)))
    got = tsk.sort_permutation([tcol], [tspec], torch.from_numpy(live))
    assert np.array_equal(got.numpy(), want)


def test_sort_permutation_multi_word_keys_match_reference():
    # int64 + float64 + int8 keys: 1 + 65 + 65 + 9 bits, three words
    rng = np.random.default_rng(12)
    n = 700
    names = ["INT64", "FLOAT64", "INT8"]
    pairs = [_cols(nm, _values(nm, n, rng), rng.random(n) < 0.9)
             for nm in names]
    for p in pairs[:2]:  # many ties on the leading keys
        p[0].data = p[0].data.at[::2].set(p[0].data[1])
        p[1].data[::2] = p[1].data[1]
    specs = [(True, True), (False, True), (True, False)]
    live = rng.random(n) < 0.95
    lanes = tsk._key_lanes([p[1] for p in pairs],
                           [tsk.SortSpec(*s) for s in specs],
                           torch.from_numpy(live))
    assert len(tsk.pack_words(lanes)) == 3
    want = np.asarray(jsk.sort_permutation(
        [p[0] for p in pairs], [jsk.SortSpec(*s) for s in specs],
        jnp.asarray(live)))
    got = tsk.sort_permutation([p[1] for p in pairs],
                               [tsk.SortSpec(*s) for s in specs],
                               torch.from_numpy(live))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("names", [["INT32"], ["FLOAT32"], ["FLOAT64"],
                                   ["INT16", "FLOAT32"]])
def test_segment_ids_for_keys_match_reference(names):
    rng = np.random.default_rng(13)
    n = 600
    pairs = []
    for nm in names:
        v = _values(nm, n, rng)
        v[n // 2:] = v[: n - n // 2]  # repeated groups
        pairs.append(_cols(nm, v, rng.random(n) < 0.8))
    live = rng.random(n) < 0.9
    jkeys = [jsk.normalize_float_key_col(p[0]) for p in pairs]
    tkeys = [tsk.normalize_float_key_col(p[1]) for p in pairs]
    wp, ws, wg = jsk.segment_ids_for_keys(jkeys, jnp.asarray(live))
    gp, gs, gg = tsk.segment_ids_for_keys(tkeys, torch.from_numpy(live))
    assert np.array_equal(gp.numpy(), np.asarray(wp))
    assert int(gg) == int(wg)
    # segment ids agree over the live groups (the reference's dead rows
    # may split differently; nothing reads them)
    ng = int(wg)
    live_sorted = live[np.asarray(wp)]
    assert np.array_equal(gs.numpy()[live_sorted], np.asarray(ws)
                          [live_sorted])
    assert (gs.numpy()[live_sorted] < ng).all()


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.float64, np.int64, np.float32,
                                   np.int32])
def test_seg_reduce_sorted_matches_reference(kind, dtype):
    rng = np.random.default_rng(14)
    n = 3000
    seg = np.sort(rng.integers(0, 40, n)).astype(np.int32)
    seg[-300:] = 45  # a gap: segments 40..44 are empty
    if np.issubdtype(dtype, np.floating):
        vals = (rng.standard_normal(n) * 1e4).astype(dtype)
        vals[rng.integers(0, n, 5)] = np.nan
        vals[rng.integers(0, n, 5)] = np.inf
        vals[rng.integers(0, n, 3)] = -np.inf
        vals[rng.integers(0, n, 9)] = -0.0
    else:
        vals = rng.integers(-10**6, 10**6, n).astype(dtype)
    cap = 64
    want = np.asarray(jseg.seg_reduce_sorted(jnp.asarray(vals),
                                             jnp.asarray(seg), cap, kind))
    got = tseg.seg_reduce_sorted(torch.from_numpy(vals),
                                 torch.from_numpy(seg), cap, kind).numpy()
    assert got.dtype == want.dtype
    if kind == "sum" and dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    elif kind == "sum" and dtype == np.float32:
        # both sum float32 block prefixes of up to 1024 rows, in other
        # orders: each may round by up to 1024 ulps of the largest value
        big = np.abs(vals[np.isfinite(vals)]).max()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1024 * big * 2.0 ** -24)
    else:
        assert np.array_equal(got, want, equal_nan=True)


def test_segment_starts_sorted_matches_reference():
    seg = np.sort(np.random.default_rng(15).integers(0, 50, 999)) \
        .astype(np.int32)
    want = np.asarray(jseg.segment_starts_sorted(jnp.asarray(seg), 999))
    got = tseg.segment_starts_sorted(torch.from_numpy(seg), 999).numpy()
    assert np.array_equal(got, want)


def test_gather_columns_and_compaction_match_reference():
    rng = np.random.default_rng(16)
    n = 1000
    pairs = [_cols(nm, _values(nm, n, rng), rng.random(n) < 0.8)
             for nm in TYPES]
    idx = rng.permutation(n).astype(np.int32)
    out_live = rng.random(n) < 0.7
    want = jgather.gather_columns([p[0] for p in pairs], jnp.asarray(idx),
                                  jnp.asarray(out_live))
    got = tgather.gather_columns([p[1] for p in pairs],
                                 torch.from_numpy(idx),
                                 torch.from_numpy(out_live))
    for w, g in zip(want, got):
        v = np.asarray(w.validity)
        assert np.array_equal(g.validity.numpy(), v)
        assert np.asarray(w.data)[v].tobytes() == g.data.numpy()[v] \
            .tobytes()
    keep = rng.random(n) < 0.3
    wi, wc = jgather.compaction_indices(jnp.asarray(keep))
    gi, gc = tgather.compaction_indices(torch.from_numpy(keep))
    assert int(gc) == int(wc)
    assert np.array_equal(gi.numpy(), np.asarray(wi))


def test_string_keys_raise_not_fall_back():
    """A string key orders by its rank lane now (the permutation matches
    the reference's), and a decimal key by its int64 lane (as the
    reference's); a struct key orders on the CPU by its rank among the
    rows, as the reference's CPU sort orders it (``cpu_sort_table``)."""
    from spark_rapids_tpu.columnar import arrow_to_device
    from spark_rapids_tpu_torch.columnar.arrow_bridge import \
        arrow_to_device as t_arrow_to_device
    import pyarrow as pa
    words = ["b", "", "abcdefgh", "abcdefg", None, "a", "b", "\xff"]
    rb = pa.record_batch({"s": pa.array(words)})
    jcol, tcol = arrow_to_device(rb).columns[0], \
        t_arrow_to_device(rb, None, torch.device("cpu")).columns[0]
    live = np.arange(jcol.capacity) < len(words)
    want = jsk.sort_permutation([jcol], [jsk.SortSpec()], jnp.asarray(live))
    got = tsk.sort_permutation([tcol], [tsk.SortSpec()],
                               torch.from_numpy(live))
    assert np.array_equal(got.numpy()[:len(words)],
                          np.asarray(want)[:len(words)])
    import decimal
    dec = pa.record_batch({"d": pa.array(
        [decimal.Decimal(v) for v in ("1.5", "-2.25", "0", "-0.01")]
        + [None], pa.decimal128(9, 2))})
    jd = arrow_to_device(dec).columns[0]
    td = t_arrow_to_device(dec, None, torch.device("cpu")).columns[0]
    live = np.arange(jd.capacity) < 5
    want = jsk.sort_permutation([jd], [jsk.SortSpec()], jnp.asarray(live))
    got = tsk.sort_permutation([td], [tsk.SortSpec()],
                               torch.from_numpy(live))
    assert np.array_equal(got.numpy()[:5], np.asarray(want)[:5])
    from spark_rapids_tpu.exec.sort import SortOrder as JOrder
    from spark_rapids_tpu.exec.sort import cpu_sort_table
    from spark_rapids_tpu.expr.base import BoundReference
    st = pa.record_batch({"s": pa.array(
        [{"a": 2, "b": "x"}, None, {"a": None, "b": "y"}, {"a": 2, "b": ""},
         {"a": -1, "b": None}, {"a": 2, "b": "x"}],
        pa.struct([("a", pa.int32()), ("b", pa.string())]))})
    tcol = t_arrow_to_device(st, None, torch.device("cpu")).columns[0]
    live = np.arange(tcol.capacity) < st.num_rows
    got = tsk.sort_permutation([tcol], [tsk.SortSpec()],
                               torch.from_numpy(live))
    jtype = jdt.from_arrow(st.schema.field("s").type)
    want = cpu_sort_table(
        pa.table({"i": pa.array(range(st.num_rows))}), [st.column(0)],
        [JOrder(BoundReference(0, jtype, True, "s"))])
    assert got.numpy()[:st.num_rows].tolist() == \
        want.column("i").to_pylist()


def test_compact_batch_matches_reference():
    from spark_rapids_tpu.columnar.batch import TpuBatch
    from spark_rapids_tpu_torch.columnar.batch import GpuBatch
    rng = np.random.default_rng(17)
    n, cap = 900, 1024
    pairs = [_cols(nm, np.resize(_values(nm, n, rng), cap),
                   rng.random(cap) < 0.8) for nm in ("INT64", "FLOAT32")]
    sel = rng.random(cap) < 0.4
    jschema = jdt.Schema([jdt.StructField("a", jdt.INT64),
                          jdt.StructField("b", jdt.FLOAT32)])
    tschema = tdt.Schema([tdt.StructField("a", tdt.INT64),
                          tdt.StructField("b", tdt.FLOAT32)])
    jb = TpuBatch([p[0] for p in pairs], jschema, n,
                  selection=jnp.asarray(sel))
    tb = GpuBatch([p[1] for p in pairs], tschema, n,
                  selection=torch.from_numpy(sel))
    want = jgather.ensure_compacted(jb)
    got = tgather.ensure_compacted(tb)
    assert got.selection is None and got.row_count == int(want.row_count)
    for w, g in zip(want.columns, got.columns):
        k = got.row_count
        assert np.array_equal(g.validity.numpy()[:k],
                              np.asarray(w.validity)[:k])
        assert g.data.numpy()[:k].tobytes() == \
            np.asarray(w.data)[:k].tobytes()
    shrunk = tgather.shrink_batch(got, 512)
    assert shrunk.capacity == 512 and shrunk.row_count == got.row_count


@pytest.mark.parametrize("dup", [False, True])
def test_build_dup_flag_matches_reference(dup):
    from spark_rapids_tpu.ops import join as jjoin
    from spark_rapids_tpu_torch.ops import join as tjoin
    rng = np.random.default_rng(18)
    keys = rng.permutation(300).astype(np.int32)
    valid = rng.random(300) < 0.9
    if dup:
        keys[5], valid[5], valid[6] = keys[6], True, True
    jcol, tcol = _cols("INT32", keys, valid)
    live = np.arange(300) < 280
    want = bool(jjoin.build_dup_flag([jcol], jnp.asarray(live)))
    got = tjoin.build_dup_flag([tcol], torch.from_numpy(live))
    assert bool(got) == want == dup
