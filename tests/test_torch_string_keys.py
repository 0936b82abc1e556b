"""String keys, the port against the JAX package on the CPU: the dense
order ranks (``string_order_ranks``, ``string_order_ranks_multi``), the
byte-wise compare, and string group and sort keys through the grouped
aggregate and the sort.

The strings are drawn with numpy from a seed among empty strings, nulls,
strings that share 7-, 8- and 14-byte prefixes (the refinement passes'
windows are 7 bytes), bytes of 0x80 and above, and strings past three
windows; the cases also take one live row and no live row. Tolerance:
exact (ranks, permutations, strings and integer sums bit for bit; float
sums rel 1e-12, another order of additions). The refinement's trip count
is held to its rule: ``ceil(L / 7)`` passes for L the longest string, one
K3 sort for pass 0 and two (with two K4 carries) for each later pass,
counted by the wrappers' calls."""
import math

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar import arrow_to_device as j_upload
from spark_rapids_tpu.exec.aggregate import TpuHashAggregateExec
from spark_rapids_tpu.exec.base import ExecCtx as JCtx
from spark_rapids_tpu.exec.base import HostBatchSourceExec as JSource
from spark_rapids_tpu.exec.base import collect_arrow as jcollect
from spark_rapids_tpu.exec.sort import SortOrder as JOrder
from spark_rapids_tpu.exec.sort import TpuSortExec
from spark_rapids_tpu.expr import Alias as JAlias
from spark_rapids_tpu.expr import UnresolvedColumn as JCol
from spark_rapids_tpu.expr.aggregates import Count as JCount
from spark_rapids_tpu.expr.aggregates import Max as JMax
from spark_rapids_tpu.expr.aggregates import Sum as JSum
from spark_rapids_tpu.ops import sort_keys as jsk
from spark_rapids_tpu.ops.strings import string_compare_tpu
from spark_rapids_tpu_torch.columnar import arrow_to_device as t_upload
from spark_rapids_tpu_torch.exec.aggregate import GpuHashAggregateExec
from spark_rapids_tpu_torch.exec.base import ExecCtx as TCtx
from spark_rapids_tpu_torch.exec.base import HostBatchSourceExec as TSource
from spark_rapids_tpu_torch.exec.base import collect_arrow as tcollect
from spark_rapids_tpu_torch.exec.sort import GpuSortExec, SortOrder
from spark_rapids_tpu_torch.expr import Alias as TAlias
from spark_rapids_tpu_torch.expr import UnresolvedColumn as TCol
from spark_rapids_tpu_torch.expr.aggregates import Count as TCount
from spark_rapids_tpu_torch.expr.aggregates import Max as TMax
from spark_rapids_tpu_torch.expr.aggregates import Sum as TSum
from spark_rapids_tpu_torch.ops import cuda_kernels as ck
from spark_rapids_tpu_torch.ops import sort_keys as tsk
from spark_rapids_tpu_torch.ops.strings import string_compare

SUM_RTOL = 1e-12
CPU = torch.device("cpu")
WORDS = ["", "a", "ab", "abcdefg", "abcdefgA", "abcdefgB", "abcdefgh",
         "abcdefghijklmn", "abcdefghijklmnA", "abcdefghijklmnB",
         "abcdefghijklmo", "abcdefghijklmnopqrstuvwxyz0123", "\x80",
         "é", "éa", "ÿÿÿÿÿÿÿ", "ÿÿÿÿÿÿÿÿ", "Books", "Music", "Sports",
         "Electronics", "z"]


def _strings(seed, n, null_share=0.15, words=WORDS):
    rng = np.random.default_rng(seed)
    vals = rng.choice(np.array(words, dtype=object), n)
    return pa.array(list(vals), pa.string(),
                    mask=rng.random(n) < null_share)


def _live(cap, n, seed, dead_share):
    rng = np.random.default_rng(seed)
    live = np.zeros(cap, bool)
    live[:n] = rng.random(n) >= dead_share
    return live


CASES = {"mixed": (700, 0.2, 0.1), "no_nulls": (513, 0.0, 0.0),
         "one_live": (64, 0.1, None), "none_live": (64, 0.1, 1.0),
         "all_null": (40, 1.0, 0.0)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_string_order_ranks_match_reference(case):
    n, nulls, dead = CASES[case]
    rb = pa.record_batch([_strings(5, n, nulls)], names=["s"])
    jc = j_upload(rb).columns[0]
    tc = t_upload(rb, None, CPU).columns[0]
    cap = tc.capacity
    if dead is None:
        live = np.zeros(cap, bool)
        live[3] = True
    else:
        live = _live(cap, n, 6, dead)
    jvalid = np.asarray(jc.validity)
    want = np.asarray(jsk.string_order_ranks(jc,
                                             jnp.asarray(live & jvalid)))
    got = tsk.string_order_ranks(tc, torch.from_numpy(live)
                                 & tc.valid_mask())
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_string_order_ranks_multi_share_ranks_across_columns():
    a = pa.record_batch([_strings(7, 300)], names=["s"])
    b = pa.record_batch([_strings(8, 200)], names=["s"])
    ja, jb = j_upload(a).columns[0], j_upload(b).columns[0]
    ta, tb = t_upload(a, None, CPU).columns[0], \
        t_upload(b, None, CPU).columns[0]
    la = np.arange(ta.capacity) < 300
    lb = np.arange(tb.capacity) < 200
    want = jsk.string_order_ranks_multi(
        [ja, jb], [jnp.asarray(la) & ja.validity, jnp.asarray(lb)
                   & jb.validity])
    got = tsk.string_order_ranks_multi(
        [ta, tb], [torch.from_numpy(la) & ta.valid_mask(),
                   torch.from_numpy(lb) & tb.valid_mask()])
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_string_compare_matches_reference():
    """Unsigned byte order, a shorter prefix first, the window read
    back."""
    rb = pa.record_batch([_strings(9, 500, 0.0), _strings(10, 500, 0.0)],
                         names=["a", "b"])
    ja, jb = j_upload(rb).columns
    ta, tb = t_upload(rb, None, CPU).columns
    want = np.asarray(string_compare_tpu(ja, jb))
    got = string_compare(ta, tb)
    assert np.array_equal(got.numpy(), want)


def test_compare_with_literals_matches_string_compare():
    """One window against several literals of differing lengths (an
    ``IN`` list) equals each literal compared as a column, and the
    reference's compare."""
    from spark_rapids_tpu_torch.expr.base import Literal
    from spark_rapids_tpu_torch.ops.strings import compare_with_literals
    rb = pa.record_batch([_strings(11, 400)], names=["s"])
    tc = t_upload(rb, None, CPU).columns[0]
    jc = j_upload(rb).columns[0]
    lits = ["", "abcdefg", "abcdefgh", "Books", "\xff", "é",
            "abcdefghijklmn"]
    got = compare_with_literals(tc, [v.encode() for v in lits])
    for v, cmp in zip(lits, got):
        lit = Literal(v).eval_gpu(t_upload(rb, None, CPU), None)
        assert np.array_equal(cmp.numpy(), string_compare(tc, lit).numpy())
        jl = j_upload(pa.record_batch([pa.array([v] * 400)],
                                      names=["s"])).columns[0]
        want = np.asarray(string_compare_tpu(jc, jl))[:400]
        assert np.array_equal(cmp.numpy()[:400], want), v


@pytest.mark.parametrize("longest", [0, 1, 7, 8, 14, 15, 29])
def test_rank_passes_follow_the_rule(longest, monkeypatch):
    """The refinement sorts ``ceil(L / 7)`` times, L the longest string
    among the column's rows: pass 0 one K3 word, each later pass two K3
    words and two K4 carries; no value is read back once a pass."""
    words = ["x" * k for k in range(longest + 1)]
    rb = pa.record_batch([pa.array(words * 3)], names=["s"])
    col = t_upload(rb, None, CPU).columns[0]
    calls = {"sort": 0, "gather": 0}
    sort, gather = ck.sort_pairs, ck.gather_rows

    def counted_sort(*a, **k):
        calls["sort"] += 1
        return sort(*a, **k)

    def counted_gather(*a, **k):
        calls["gather"] += 1
        return gather(*a, **k)

    monkeypatch.setattr(ck, "sort_pairs", counted_sort)
    monkeypatch.setattr(ck, "gather_rows", counted_gather)
    live = torch.arange(col.capacity) < len(words) * 3
    ranks = tsk.string_order_ranks(col, live)
    passes = tsk.rank_pass_count(longest)
    assert passes == math.ceil(longest / 7)
    words_sorted = sum(tsk.rank_pass_words(p, col.capacity)
                       for p in range(passes))
    assert calls == {"sort": words_sorted,
                     "gather": words_sorted - min(passes, 1)}
    # each length is one string here: its dense rank is its length
    assert ranks[:len(words) * 3].tolist() == [len(w) for w in words * 3]


def test_rank_passes_lie_in_a_profiler_range():
    """The passes run inside ``record_function("string_ranks")``, and
    ``tools/nds_trace._rank_share`` gives that range the K3 and K4
    kernels that run within its device-side span (device events stand in
    for a card's: the CPU profiler records none)."""
    from torch.profiler import ProfilerActivity, profile

    from spark_rapids_tpu_torch.tools.nds_trace import _rank_share
    col = t_upload(pa.record_batch([_strings(7, 64)], names=["s"]), None,
                   CPU).columns[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tsk.string_order_ranks(col, torch.ones(col.capacity, dtype=bool))
    assert [e.name for e in prof.events()].count("string_ranks") == 1
    events = [(10, 50, "string_ranks"), (12, 16, "radix_histogram"),
              (16, 22, "radix_pass"), (22, 25, "gather_rows_fast"),
              (25, 32, "k5_decode"), (48, 52, "radix_pass"),
              (60, 65, "radix_pass"), (70, 90, "string_ranks"),
              (71, 73, "gather_rows_any")]
    assert _rank_share(events) == {
        "spans": 2, "K3_device_us": 10, "K3_kernel_launches": 2,
        "K4_device_us": 5, "K4_kernel_launches": 2}
    assert _rank_share(events[1:7])["spans"] == 0


def _table(seed, n=1500):
    rng = np.random.default_rng(seed)
    return pa.table({
        "s": _strings(seed, n),
        "t": _strings(seed + 1, n, 0.3,
                      words=["", "Books", "Music", "ÿ", "abcdefgh"]),
        "k": pa.array(rng.integers(0, 3, n).astype(np.int32)),
        "v": pa.array(rng.normal(0, 100, n)),
        "i": pa.array(rng.integers(-50, 50, n).astype(np.int64)),
    })


@pytest.mark.parametrize("keys", [["s"], ["s", "k"], ["t", "s"],
                                  ["k", "t"]])
def test_string_group_keys_match_reference(keys):
    """Grouped sum, count and max by one or two string keys (null keys
    grouped together), over several batches."""
    batches = _table(20).to_batches(max_chunksize=400)

    def plan(pkg):
        Col, Alias, Sum, Count, Max, Agg, Src = pkg
        return Agg([Col(k) for k in keys],
                   [Alias(Sum(Col("v")), "sv"), Alias(Count(), "n"),
                    Alias(Sum(Col("i")), "si"), Alias(Max(Col("i")), "mi")],
                   Src(batches))

    want = jcollect(plan((JCol, JAlias, JSum, JCount, JMax,
                          TpuHashAggregateExec, JSource)), JCtx())
    got = tcollect(plan((TCol, TAlias, TSum, TCount, TMax,
                         GpuHashAggregateExec, TSource)),
                   TCtx(device="cpu"))
    order = [(k, "ascending") for k in keys]
    want, got = want.sort_by(order), got.sort_by(order)
    assert got.schema == want.schema
    for c in got.column_names:
        g, w = got.column(c).to_pylist(), want.column(c).to_pylist()
        if c == "sv":
            assert all(math.isclose(a, b, rel_tol=SUM_RTOL)
                       for a, b in zip(g, w)), c
        else:
            assert g == w, c


@pytest.mark.parametrize("order", [
    [("s", True, None)], [("s", False, None)], [("t", True, False),
                                                ("s", False, True)],
    [("k", False, None), ("s", True, None)]])
def test_string_sort_keys_match_reference(order):
    """A global sort by string keys: ascending and descending, nulls first
    and last, ties broken by a row number."""
    table = _table(30)
    table = table.append_column("row", pa.array(np.arange(table.num_rows)))
    batches = table.to_batches(max_chunksize=500)
    order = order + [("row", True, None)]
    want = jcollect(TpuSortExec([JOrder(JCol(c), a, nf)
                                 for c, a, nf in order],
                                JSource(batches)), JCtx())
    got = tcollect(GpuSortExec([SortOrder(TCol(c), a, nf)
                                for c, a, nf in order],
                               TSource(batches)), TCtx(device="cpu"))
    assert got.column("row").to_pylist() == want.column("row").to_pylist()
    assert got.column("s").to_pylist() == want.column("s").to_pylist()
