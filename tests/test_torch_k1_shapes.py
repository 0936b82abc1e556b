"""K1's plain PyTorch versions at the lengths and offsets where the CUDA
kernel changes path, against the JAX package and numpy, on the CPU.

The kernel (``csrc/masked_product_sum.cu``) takes 4-row groups of 16-byte
loads, with a scalar loop for the rows past the last group and for inputs
off alignment, and folds each column's leaves into one float32 or int32
interval; ``kernel_checks.check_k1`` holds it to these plain versions on
the card at the same edges and ``check_k1_bounds`` at every bound's
neighbours. Here the plain versions meet ``masked_product_sum_xla``,
``masked_product_sum_pallas`` in interpret mode,
``tests/test_torch_kernels.py``'s numpy oracle and a numpy compare in
either float order at those edges and bounds, and the wrappers take the
plain version for CPU tensors without counting a launch."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu.ops.pallas_kernels import (masked_product_sum_pallas,
                                                 masked_product_sum_xla)
from spark_rapids_tpu_torch.ops import cuda_kernels as ck
from spark_rapids_tpu_torch.ops import kernel_checks as kc
from test_torch_kernels import _oracle, _q6_inputs

# a group of 4 rows, 16 rows, a block's 1024 rows and two and four
# blocks' rows, each +- 1, and the short batches
EDGE_LENGTHS = [0, 1, 3, 5, 15, 16, 17, 1023, 1024, 1025, 2047, 2048, 2049,
                4095, 4096, 4097]
OFFSETS = [1, 2, 3]  # elements past 16-byte alignment (the scalar loop)


def _q6_mask(q, p, d, s):
    return ((s >= 8766) & (s < 9131) & (d >= np.float32(0.05))
            & (d <= np.float32(0.07)) & (q < np.float32(24.0)))


def _contract_vs_xla(q, p, d, s, views):
    """The plain contract edition on ``views`` (torch tensors holding
    q, p, d, s) against ``masked_product_sum_xla`` and the numpy mask."""
    want = float(masked_product_sum_xla(*map(jnp.asarray, (q, p, d, s))))
    got, count = ck.masked_product_sum_torch(*views)
    assert got.dtype == torch.float32
    assert abs(got.item() - want) <= kc.CONTRACT_RTOL * max(1.0, abs(want))
    assert count.item() == int(_q6_mask(q, p, d, s).sum())


@pytest.mark.parametrize("n", EDGE_LENGTHS)
def test_contract_plain_matches_xla_at_edge_lengths(n):
    q, p, d, s = _q6_inputs(n, seed=100 + n)
    # rows that pass, so the sums are not all zero
    s[::3] = 9000
    d[::3] = np.float32(0.06)
    q[::3] = np.float32(10.0)
    _contract_vs_xla(q, p, d, s, [torch.from_numpy(a) for a in (q, p, d, s)])


@pytest.mark.parametrize("offset", OFFSETS)
def test_contract_plain_matches_xla_at_offset_views(offset):
    n = 4097
    q, p, d, s = _q6_inputs(n + offset, seed=offset)
    views = [torch.from_numpy(a)[offset:] for a in (q, p, d, s)]
    assert all(v.is_contiguous() and v.storage_offset() == offset
               for v in views)
    _contract_vs_xla(q[offset:], p[offset:], d[offset:], s[offset:], views)


@pytest.mark.parametrize("tiles", [1, 2])
def test_contract_plain_matches_pallas_interpret(tiles):
    n = tiles * 2048 * 128  # the Pallas edition's tile multiple
    q, p, d, s = _q6_inputs(n, seed=tiles)
    want = float(masked_product_sum_pallas(
        *map(jnp.asarray, (q, p, d, s)), True))
    got, count = ck.masked_product_sum_torch(
        *map(torch.from_numpy, (q, p, d, s)))
    assert abs(got.item() - want) <= kc.CONTRACT_RTOL * max(1.0, abs(want))
    assert count.item() == int(_q6_mask(q, p, d, s).sum())


def _nulls_nan(n, offset, seed):
    """q6 columns with NaN quantities, price and ship-date validity and a
    selection, each array ``offset`` elements into its buffer."""
    rng = np.random.default_rng(seed)
    q, p, d, s = _q6_inputs(n + offset, seed=seed)
    q[rng.random(n + offset) < 0.02] = np.nan
    price_ok = rng.random(n + offset) > 0.05
    ship_ok = rng.random(n + offset) > 0.03
    sel = rng.random(n + offset) > 0.1
    return [a[offset:] for a in (q, p, d, s, price_ok, ship_ok, sel)]


@pytest.mark.parametrize("offset", [0] + OFFSETS)
@pytest.mark.parametrize("n,row_count", [(5, 5), (1025, 1024),
                                         (2049, 2047), (4097, 4097)])
def test_engine_plain_matches_numpy_oracle_at_edges(n, row_count, offset):
    q, p, d, s, price_ok, ship_ok, sel = _nulls_nan(n, offset, seed=n)
    t = torch.from_numpy
    spec = ck.FilterProductSum(
        leaves=ck.Q6_SPEC.leaves[:4] + (ck.Leaf(0, ">=", 2.0),),
        a_slot=1, b_slot=2)
    before = ck.filter_product_sum.launches
    got, count = ck.filter_product_sum(
        [t(q), t(p), t(d), t(s)], [None, t(price_ok), None, t(ship_ok)],
        t(sel), row_count, spec)
    assert ck.filter_product_sum.launches == before
    want, want_count = _oracle([q, p, d, s], [None, price_ok, None,
                                              ship_ok], sel, row_count, 0)
    assert got.dtype == torch.float64
    assert count.item() == want_count
    assert abs(got.item() - want) <= kc.ENGINE_RTOL * max(1.0, abs(want))


@pytest.mark.parametrize("row_count", [0, 1, 3, 5, 4096])
def test_int32_columns_in_other_slots(row_count):
    """Ship date in slot 0 and an int32 quantity in slot 3, as the card's
    ``int32_slots_0_3`` case lays them out."""
    n = 4096
    rng = np.random.default_rng(row_count)
    q, p, d, s = _q6_inputs(n, seed=row_count)
    qi = q.astype(np.int32)
    disc_ok = rng.random(n) > 0.05
    t = torch.from_numpy
    got, count = ck.filter_product_sum_torch(
        [t(s), t(p), t(d), t(qi)], [None, None, t(disc_ok), None], None,
        row_count, kc._INT_SLOTS_SPEC)
    keep = (np.arange(n) < row_count) & disc_ok \
        & (s >= 8766) & (s < 9131) & (qi < 24) \
        & (d >= np.float32(0.05)) & (d <= np.float32(0.07))
    want = float((p * d).astype(np.float64)[keep].sum())
    assert count.item() == int(keep.sum())
    assert abs(got.item() - want) <= kc.ENGINE_RTOL * max(1.0, abs(want))


def test_wrappers_take_the_plain_version_on_the_cpu():
    q, p, d, s = map(torch.from_numpy, _q6_inputs(1027, seed=7))
    before = (ck.masked_product_sum.launches, ck.filter_product_sum.launches)
    got = ck.masked_product_sum(q, p, d, s)
    want = ck.masked_product_sum_torch(q, p, d, s)
    assert [x.item() for x in got] == [x.item() for x in want]
    got = ck.filter_product_sum([q, p, d, s], [None] * 4, None, 1000,
                                ck.Q6_SPEC)
    want = ck.filter_product_sum_torch([q, p, d, s], [None] * 4, None, 1000,
                                       ck.Q6_SPEC)
    assert [x.item() for x in got] == [x.item() for x in want]
    assert (ck.masked_product_sum.launches,
            ck.filter_product_sum.launches) == before


def test_check_cases_cover_the_kernel_edges():
    """The card's cases: the off-alignment copies really start off 16
    bytes (columns) and 4 bytes (masks), and the contract edition runs
    wherever its fixed slots and types fit."""
    cases = {c.name: c for c in kc.k1_cases("cpu", edge_rows=[1023, 1025])}
    for k in (1, 2, 3):
        c = cases[f"columns_at_{4 * k}B"]
        assert all(x.data_ptr() % 16 == 4 * k for x in c.cols)
    for b in (1, 2, 3):
        c = cases[f"masks_at_{b}B"]
        assert c.selection.data_ptr() % 4 == b
    assert cases["masks_at_4B"].selection.data_ptr() % 16 == 4
    assert [cases[f"rows_{r}"].row_count for r in (0, 1, 3, 5)] == [0, 1, 3,
                                                                     5]
    assert cases["length_1025"].row_count == 1025
    assert cases["rows_2^23"].row_count == 1 << 23
    engine_only = {"int32_slots_0_3", "bounds_off_grid",
                   "equal_inf_nan_bounds"}
    assert all(c.contract == (name not in engine_only)
               for name, c in cases.items())


def _numpy_keep(cols, leaves, nan_greatest):
    """The rows that pass every leaf, compared in float64 in Spark's
    order (NaN greatest, and equal to itself) or in IEEE order."""
    keep = np.ones(len(cols[0]), bool)
    with np.errstate(invalid="ignore"):
        for leaf in leaves:
            x, b = cols[leaf.slot].astype(np.float64), leaf.bound
            xn = np.isnan(x)
            if not nan_greatest:
                lt, eq, gt = x < b, x == b, x > b
            elif np.isnan(b):
                lt, eq, gt = ~xn, xn, np.zeros_like(xn)
            else:
                lt, eq, gt = ~xn & (x < b), x == b, xn | (x > b)
            keep &= {"<": lt, "<=": lt | eq, ">": gt, ">=": gt | eq,
                     "=": eq}[leaf.op]
    return keep


@pytest.mark.parametrize("name", ["bounds_off_grid", "equal_inf_nan_bounds"])
def test_off_grid_bounds_plain_matches_numpy(name):
    """The card's cases whose bounds are no float32 or int32 value, or an
    `=`, an infinity or NaN: the plain engine edition, which the kernel's
    intervals are held to, against numpy in Spark's order (NaN greatest,
    and equal to itself)."""
    case = next(c for c in kc.k1_cases("cpu") if c.name == name)
    q, p, d, s = (c.numpy() for c in case.cols)
    keep = np.arange(len(q)) < case.row_count
    keep &= case.selection.numpy()
    for v in case.valids:
        if v is not None:
            keep &= v.numpy()
    keep &= _numpy_keep([q, p, d, s], case.spec.leaves, True)
    want = float((p * d).astype(np.float64)[keep].sum())
    got, count = ck.filter_product_sum_torch(
        case.cols, case.valids, case.selection, case.row_count, case.spec)
    assert count.item() == int(keep.sum()) > 0
    assert abs(got.item() - want) <= kc.ENGINE_RTOL * max(1.0, abs(want))


def test_bound_columns_hold_every_neighbour():
    """The sweep's columns hold each bound's float32 or integer
    neighbours and the special values, so that a fold that is one step
    off at any bound changes a count."""
    f, _, _, i = kc.k1_bound_columns()
    bits = set(f.view(np.uint32).tolist())
    for b in kc.K1_F32_BOUNDS:
        if not np.isnan(b):
            assert {np.float32(v).view(np.uint32).item()
                    for v in kc._f32_steps(b)} <= bits
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.finfo(np.float32).max,
                         np.finfo(np.float32).smallest_subnormal], np.float32)
    assert set(specials.view(np.uint32).tolist()) <= bits
    assert np.isnan(f).any()
    ints = set(i.tolist())
    assert {-(1 << 31), (1 << 31) - 1, 8765, 8766, 8767, 9130, 9131} <= ints
    assert len(f) % 4 == 3 and len(i) == len(f)


@pytest.mark.parametrize("op", sorted(ck.OPS))
@pytest.mark.parametrize("nan_greatest", [True, False])
@pytest.mark.parametrize("kind", ["f32", "i32"])
def test_bound_sweep_plain_matches_numpy(kind, nan_greatest, op):
    """The plain version that ``check_k1_bounds`` holds the kernel's
    intervals to, on the sweep's columns: every spec whose first leaf is
    ``op`` on the ``kind`` column, against numpy in the edition's order,
    counts equal and sums exact (the products are small integers and
    halves)."""
    cols = kc.k1_bound_columns()
    t = [torch.from_numpy(c) for c in cols]
    acc = torch.float64 if nan_greatest else torch.float32
    specs = [sp for sp in kc.k1_bound_specs()
             if sp.leaves[0].slot == kc._BOUND_SLOT[kind]
             and sp.leaves[0].op == op]
    assert len(specs) >= len(kc.K1_F32_BOUNDS if kind == "f32"
                             else kc.K1_I32_BOUNDS)
    for spec in specs:
        keep = _numpy_keep(cols, spec.leaves, nan_greatest)
        got, count = ck.filter_product_sum_torch(
            t, [None] * 4, None, len(cols[0]), spec, nan_greatest, acc)
        assert got.dtype == acc
        assert count.item() == int(keep.sum()), spec.leaves
        assert got.item() == float((cols[1] * cols[2])[keep].sum()), \
            spec.leaves
