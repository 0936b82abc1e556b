"""Each kernel against its plain PyTorch version, on the card.

K1's two editions run on inputs made with numpy from a seed: at
the q6 main path's batch shape (capacity ``1 << 20``, 750,152 live rows:
SF1's 6,001,215 rows over 8 files), at a ragged length, with nulls, a
selection and NaNs, with columns 1, 2 and 3 elements off 16-byte
alignment and masks and a selection 1, 2, 3 and 4 bytes off it (the
scalar loop), at 0, 1, 3 and 5 live rows, at a block's rows and a full
round of the card's grid, each +- 1, at 2^23 rows (more groups than
the grid's threads x groups a thread), with int32 columns in other slots
than the ship date's, with bounds off the float32 and int32 grids, an
`=` leaf and infinite and NaN bounds; and twice on one input and on two
streams at once, which must give the same bits. ``check_k1_bounds``
sweeps the kernel's folding of a column's leaves into one interval
(``filter_leaves.cuh``): every op against bounds on and off the float32
and int32 grids, past FLT_MAX and the int32 range, +-0, +-inf and NaN,
alone and in pairs on one column, in both editions and both alignments,
over columns holding each bound's float32 or integer neighbours (+-1
and +-2 steps), +-0, +-inf, NaN, FLT_MAX, the denormals and the int32
ends, each count equal to the plain version's. ``check_k1`` holds each
result to the stated tolerance and raises on the first disagreement;
``chip_smoke.py`` and the ``gpu``-marked test call it, ``time_k1`` times
both editions with CUDA events, ``time_k1_sweep`` times
the engine edition from 0 to 2^23 rows beside an empty launch (the fixed
cost and the stream rate), and ``k1_kernels_per_call`` counts the
kernels one call launches in a profiler trace.

K3 (``check_k3``/``time_k3``) runs on random 64-bit keys at the join +
group-by path's sort shapes (2^17 pairs for the build presort, 2^21 for
each partial, 2^23 for the final), on the path's own key words at those
shapes (``path_words``), at a ragged 1,000,003, on all-equal, sorted,
reverse-sorted and heavily duplicated keys, on keys whose only varying
bit is the sign bit or whose only varying digit is the top one, on 1-bit
compaction keys, on month words with 90% dead rows, and with negative and
duplicate payloads, and on a Decimal64 key's two words (live bit,
null bit, the 64-bit unscaled lane) over 2^20 ``ss_net_profit`` cents
with negatives and nulls (``decimal_words``). K4 (``check_k4``/``time_k4``) runs at the path's
gather shapes (the probe's 2^21 rows from a 2^17-row build, the
group-by's 2^21-row permutation), at a ragged length, and with nulls,
dead rows, out-of-range indices, 1-, 2-, 4- and 8-byte columns mixed,
three columns of one width (1, 2 and 8 bytes) with indices and live
flags off alignment, a Decimal64 column with nulls gathered into a
2^20-row batch (``decimal_gather_case``), and the NDS join's shape: the ``item`` build's
six columns, its string as starts and lengths (32,768 rows), gathered
into a 2^20-row ``store_sales`` batch. ``check_string_gather`` holds
``gather_strings`` at that shape to pyarrow's ``take``. Each timing runs back to back on the device over
inputs that cycle through copies larger than L2, in turns (plain,
kernel, kernel, plain), beside the library call that computes the same
function.

K5 (``check_k5``/``time_k5``) decodes Parquet files written from a seed:
a q6 row group (750,152 rows, the four q6 columns and l_linenumber), a
row group with nulls, DELTA pages, v2 pages, booleans and an all-null
column, a coalesced batch of row groups whose dictionaries differ, and
alternating values, a dictionary of 100,000 entries and 64-bit PLAIN
columns (``k5_shapes_file``), and the NDS path's own batches
(``nds_layouts``: a 2^20-row ``store_sales`` batch coalesced from two
row groups of int64, int32 and float64 columns, the 32,768-row
``item`` and 25-row ``store`` batches with their dictionary string
columns decoded to store indices, and the 65,536-row ``customer``
batch, and ``item`` with an all-null string column written PLAIN), a
coalesced batch of ``DECIMAL(7,2)`` (INT32) and ``DECIMAL(12,2)``
(INT64) columns with nulls and their extremes (``decimal_layouts``);
and the hand-made run tables of ``k5_tile_layouts``, which
walk its tiles at their edges (the CPU tests hold ``decode_tiles_torch``
to the reference on the same tables). Every column is compared whole,
a string column's offsets and chars too, and every batch read from a
file is also held to pyarrow's reading of the same rows.
``time_k5`` counts the bytes K5 moves: the encoded parts in, and every
column out up to the capacity. K2 (``check_k2``/``time_k2``) runs both
editions at a q6 batch with a line-number key, at a ragged length, with
nulls, NaN, a selection, null and out-of-range keys, with every row in
one group and with every group, with columns, key and masks off
16-byte alignment (the scalar loop), with int64 keys, at 1, 3 and 5
rows, and checks that two launches on one input, and launches on two
streams at once, give the same bits.

Tolerances: the engine edition sums float64 in another order than the
plain version, so its sum must agree to rel 1e-9; the K1-contract
edition sums float32, held to rel 1e-3 as ``tests/test_exec.py:198``
holds the Pallas edition; counts must be equal. K3 and K4 must match
their plain versions exactly: K3's plain version runs the same digit
passes on the same pairs (and K3 must also equal ``torch.sort``), and
K4 copies bits. K5 must match bit for bit (it copies and
shifts bits). K2's engine edition sums float64 per group in another
order: rel 1e-9, counts equal; its contract edition sums float32: rel
1e-3 of the group's sum (or of 1 where that is smaller), as
``bench.py:767`` holds the Pallas edition.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..io.parquet_plan import _META_DELTA, _META_DICT, _META_IDENT, \
    _META_RLE
from . import cuda_kernels as ck

__all__ = ["K1Case", "k1_base_cases", "k1_cases", "check_k1",
           "k1_bound_specs", "k1_bound_columns", "check_k1_bounds",
           "time_k1",
           "time_k1_sweep", "K1_SWEEP_ROWS", "k1_geometry",
           "k1_kernels_per_call", "k1_trace", "ENGINE_RTOL",
           "CONTRACT_RTOL", "MAIN_CAPACITY", "MAIN_ROWS", "K3_SHAPES",
           "k3_cases", "check_k3", "time_k3", "k4_cases", "check_k4",
           "check_string_gather", "path_words", "string_rank_words",
           "window_words", "library_sort_pairs", "SORT_BYTES_PER_PAIR",
           "time_k4", "k5_layouts", "k5_shapes_file", "nds_layouts",
           "k5_tile_layouts",
           "check_k5", "time_k5", "k2_cases", "check_k2", "time_k2",
           "k6_cases", "k6_literal_cases", "check_k6", "time_k6",
           "K6_LIKE", "K6_RLIKE",
           "K6_BLOWUP", "K6_TEXT_ROWS"]

ENGINE_RTOL = 1e-9
CONTRACT_RTOL = 1e-3
MAIN_CAPACITY = 1 << 20
MAIN_ROWS = 750_152  # ceil(6,001,215 / 8): one SF1 file's batch
_SLEEP_CYCLES = 200_000_000  # about 0.1 s at the H100's clock

# q6's leaves with the quantity leaf one-sided upward: under Spark's
# order a NaN quantity passes it, under IEEE it fails
_NAN_SPEC = ck.FilterProductSum(
    leaves=ck.Q6_SPEC.leaves[:4] + (ck.Leaf(0, ">=", 2.0),),
    a_slot=1, b_slot=2)


@dataclasses.dataclass
class K1Case:
    """Inputs for both editions: columns (quantity, price, discount,
    shipdate, or another order with its spec), masks, live rows, the
    engine edition's spec, and whether the contract edition (fixed q6
    slots and types) runs on the live prefix."""
    name: str
    cols: List[torch.Tensor]
    valids: List[Optional[torch.Tensor]]
    selection: Optional[torch.Tensor]
    row_count: int
    spec: ck.FilterProductSum
    contract: bool = True

    def bytes_read(self) -> int:
        """Bytes the engine edition must read: each used column, mask
        and selection byte once, over the live rows."""
        per_row = sum(c.element_size() for c in self.cols)
        per_row += sum(1 for v in self.valids if v is not None)
        per_row += 0 if self.selection is None else 1
        return self.row_count * per_row


def _columns(rng, n: int) -> List[np.ndarray]:
    qty = rng.integers(1, 51, n).astype(np.float32)
    price = (qty * rng.integers(900, 1100, n)).astype(np.float32)
    disc = (rng.integers(0, 11, n) / 100.0).astype(np.float32)
    ship = rng.integers(8000, 10600, n).astype(np.int32)
    return [qty, price, disc, ship]


# q6's leaves over (ship date, price, discount, quantity): int32 columns in
# slots 0 and 3, the quantity's leaf on an int32 column
_INT_SLOTS_SPEC = ck.FilterProductSum(
    leaves=(ck.Leaf(0, ">=", 8766), ck.Leaf(0, "<", 9131),
            ck.Leaf(2, ">=", float(np.float32(0.05))),
            ck.Leaf(2, "<=", float(np.float32(0.07))),
            ck.Leaf(3, "<", 24)),
    a_slot=1, b_slot=2)


_OFF_GRID_SPEC = ck.FilterProductSum(
    leaves=(ck.Leaf(3, ">", 8765.5), ck.Leaf(3, "<=", 9130.7),
            ck.Leaf(2, ">=", 0.05), ck.Leaf(2, "<", 0.0700000001),
            ck.Leaf(0, "<=", 23.5)),
    a_slot=1, b_slot=2)
_EQUAL_SPEC = ck.FilterProductSum(
    leaves=(ck.Leaf(0, "=", 10.0), ck.Leaf(3, ">=", float("-inf")),
            ck.Leaf(2, "<=", float("inf")), ck.Leaf(1, "<", float("nan"))),
    a_slot=1, b_slot=2)


def k1_geometry(device) -> Dict[str, int]:
    """A block's rows in the grid's size, the blocks of a launch at the
    main batch on ``device``, and the rows the whole grid asks for at
    once (blocks x block rows x groups a thread)."""
    lib = ck._library()
    with torch.cuda.device(device):
        block = lib.spark_fps_block_rows()
        blocks = lib.spark_fps_grid(0, MAIN_ROWS)
        if blocks < 0:
            raise RuntimeError(f"K1 grid query failed: cudaError "
                               f"{-blocks}")
        return {"block_rows": block, "blocks": blocks,
                "round_rows": blocks * block * lib.spark_fps_ahead()}


def _k1_base(rng, t) -> List[K1Case]:
    main = _columns(rng, MAIN_CAPACITY)
    ragged_n = 1_000_003
    ragged = _columns(rng, ragged_n)
    nulls = _columns(rng, MAIN_CAPACITY)
    nulls[0][rng.random(MAIN_CAPACITY) < 0.01] = np.nan
    price_ok = rng.random(MAIN_CAPACITY) > 0.05
    ship_ok = rng.random(MAIN_CAPACITY) > 0.02
    keep = rng.random(MAIN_CAPACITY) > 0.1
    return [
        K1Case("main", [t(c) for c in main], [None] * 4, None, MAIN_ROWS,
               ck.Q6_SPEC),
        K1Case("ragged", [t(c) for c in ragged], [None] * 4, None,
               ragged_n, ck.Q6_SPEC),
        K1Case("nulls_nan", [t(c) for c in nulls],
               [None, t(price_ok), None, t(ship_ok)], t(keep),
               MAIN_ROWS - 1, _NAN_SPEC),
    ]


def _to(device):
    dev = torch.device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return t


def k1_base_cases(device, seed: int = 0) -> List[K1Case]:
    """The main batch, a ragged length, and nulls, a selection and NaN
    (K2's cases build on these three)."""
    return _k1_base(np.random.default_rng(seed), _to(device))


def k1_cases(device, seed: int = 0,
             edge_rows: Sequence[int] = ()) -> List[K1Case]:
    """``k1_base_cases``, then the alignments, short batches, the
    ``edge_rows`` lengths (with masks), bounds off the grids, 2^23 rows
    and int32 columns in other slots."""
    rng = np.random.default_rng(seed)
    t = _to(device)
    cases = _k1_base(rng, t)
    main_case, nulls_case = cases[0], cases[2]
    # off alignment: the columns by 1-3 elements, the masks by 1-4 bytes
    for k in (1, 2, 3):
        cases.append(dataclasses.replace(
            main_case, name=f"columns_at_{4 * k}B",
            cols=[_offset(c, 4 * k) for c in main_case.cols]))
    for b in (1, 2, 3, 4):
        cases.append(dataclasses.replace(
            nulls_case, name=f"masks_at_{b}B",
            valids=[None if v is None else _offset(v, b)
                    for v in nulls_case.valids],
            selection=_offset(nulls_case.selection, b)))
    # eight rows, most of which pass q6's leaves (rows 2 and 6 fail)
    eight = [t(np.array(v, dt)) for v, dt in (
        ([10, 20, 5, 23, 1, 30, 2, 3], np.float32),
        ([1000, 2500.5, 333, 4096, 7, 1.25, 900, 12], np.float32),
        ([0.06, 0.05, 0.08, 0.07, 0.06, 0.05, 0.06, 0.07], np.float32),
        ([9000, 8766, 9100, 9130, 8800, 9000, 9131, 8999], np.int32))]
    cases += [dataclasses.replace(main_case, name=f"rows_{r}", cols=eight,
                                  row_count=r) for r in (0, 1, 3, 5)]
    if edge_rows:
        n = max(edge_rows)
        edge = _columns(rng, n)
        edge[0][rng.random(n) < 0.01] = np.nan
        cols = [t(c) for c in edge]
        valids = [None, t(rng.random(n) > 0.05), None,
                  t(rng.random(n) > 0.02)]
        sel = t(rng.random(n) > 0.1)
        for r in sorted(set(edge_rows)):
            cases.append(K1Case(
                f"length_{r}", [c[:r] for c in cols],
                [None if v is None else v[:r] for v in valids], sel[:r], r,
                _NAN_SPEC))
    # bounds off the float32 grid and fractional bounds on the int32 ship
    # date; an `=` leaf, infinite bounds and a NaN bound (which every
    # non-NaN value is below, in Spark's order)
    cases.append(dataclasses.replace(
        nulls_case, name="bounds_off_grid", spec=_OFF_GRID_SPEC,
        contract=False))
    cases.append(dataclasses.replace(
        nulls_case, name="equal_inf_nan_bounds", spec=_EQUAL_SPEC,
        contract=False))
    big = 1 << 23
    cases.append(K1Case("rows_2^23", [t(c) for c in _columns(rng, big)],
                        [None] * 4, None, big, ck.Q6_SPEC))
    qty, price, disc, ship = _columns(rng, MAIN_CAPACITY)
    cases.append(K1Case(
        "int32_slots_0_3",
        [t(ship), t(price), t(disc), t(qty.astype(np.int32))],
        [None, None, t(rng.random(MAIN_CAPACITY) > 0.05), None], None,
        MAIN_ROWS, _INT_SLOTS_SPEC, contract=False))
    return cases


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(1.0, abs(want))


def _contract_inputs(case: K1Case) -> List[torch.Tensor]:
    """The contract edition has no masks: its live rows are the
    prefix."""
    return [c[:case.row_count].contiguous() for c in case.cols]


def _k1_engine(case: K1Case):
    return ck.filter_product_sum(case.cols, case.valids, case.selection,
                                 case.row_count, case.spec)


def check_k1(device) -> List[Dict]:
    """Run both editions on every case; raise on a disagreement. Returns
    one record per (case, edition), then the repeat checks' and the
    bound sweep's. Kernel launches made here do not touch the main
    path's counts: the callers reset those after."""
    geometry = k1_geometry(device)
    edge_rows = [n + d for n in (geometry["block_rows"],
                                 geometry["round_rows"])
                 for d in (-1, 0, 1)]
    out = []
    for case in k1_cases(device, edge_rows=edge_rows):
        ps, pc = ck.filter_product_sum_torch(case.cols, case.valids,
                                             case.selection,
                                             case.row_count, case.spec)
        if case.contract:
            q, p, d, sd = _contract_inputs(case)
            cps, cpc = ck.masked_product_sum_torch(q, p, d, sd)
        s, c = _k1_engine(case)
        rec = {"case": case.name, "edition": "engine",
               "rows": case.row_count,
               "sum": s.item(), "plain_sum": ps.item(),
               "count": c.item(), "plain_count": pc.item()}
        rec["rel_err"] = _rel(rec["sum"], rec["plain_sum"])
        if rec["count"] != rec["plain_count"] \
                or not rec["rel_err"] <= ENGINE_RTOL:
            raise AssertionError(f"K1 engine edition disagrees: {rec}")
        out.append(rec)
        if not case.contract:
            continue
        s, c = ck.masked_product_sum(q, p, d, sd)
        rec = {"case": case.name, "edition": "contract",
               "rows": case.row_count,
               "sum": s.item(), "plain_sum": cps.item(),
               "count": c.item(), "plain_count": cpc.item()}
        rec["rel_err"] = _rel(rec["sum"], rec["plain_sum"])
        if rec["count"] != rec["plain_count"] \
                or not rec["rel_err"] <= CONTRACT_RTOL:
            raise AssertionError(f"K1 contract edition disagrees: {rec}")
        out.append(rec)
    return out + _k1_repeats(device) + check_k1_bounds(device)


def _stream_repeats(run, a, b, device):
    """``run`` on ``a`` twice in a row, then on ``a`` and ``b`` on two
    streams at once, 16 times each. Returns the first two outputs and,
    for ``a`` and ``b``, the output one stream alone gave and the
    outputs of the two-stream runs."""
    first, second = run(a), run(a)
    want = (first, run(b))
    torch.cuda.synchronize(device)
    streams = [torch.cuda.Stream(device) for _ in range(2)]
    got = ([], [])
    for _ in range(16):
        for k, (st, c) in enumerate(zip(streams, (a, b))):
            with torch.cuda.stream(st):
                got[k].append(run(c))
    torch.cuda.synchronize(device)
    return first, second, list(zip(want, got))


def _k1_repeats(device) -> List[Dict]:
    """In each edition: two launches on one input give the same bits; and
    launches on two streams at once (each stream its own ticket counter)
    give each stream's input the bits that one stream alone gives it."""
    main, _, nulls = k1_base_cases(device)
    out = []
    for edition, run in (
            ("engine", _k1_engine),
            ("contract",
             lambda c: ck.masked_product_sum(*_contract_inputs(c)))):
        first, second, pairs = _stream_repeats(run, main, nulls, device)
        for name, same in (
                ("two_launches", _same_outputs(first, second)),
                ("two_streams", all(_same_outputs(g, w)
                                    for w, gs in pairs for g in gs))):
            rec = {"case": name, "edition": edition,
                   "rows": main.row_count, "same_bits": same,
                   "sum": first[0].item(), "plain_sum": first[0].item(),
                   "count": first[1].item(),
                   "plain_count": first[1].item(), "rel_err": 0.0}
            if not same:
                raise AssertionError(f"K1 gives other bits on another "
                                     f"run: {rec}")
            out.append(rec)
    return out


_FLT_MAX = float(np.finfo(np.float32).max)
_F32_TINY = float(np.finfo(np.float32).smallest_subnormal)
# leaf bounds on a float32 column: on the float32 grid and between two of
# its values, past FLT_MAX (below and above the float32 rounding limit),
# +-0, a denormal, +-inf and NaN
K1_F32_BOUNDS = (0.0, -0.0, 1.0, -1.0, 24.0, 23.5, float(np.float32(0.05)),
                 0.05, 0.07, 0.1, -0.1, _F32_TINY, 1e-45, 16777217.0,
                 -16777217.0, _FLT_MAX, -_FLT_MAX, 3.4028235e38,
                 -3.4028235e38, 1e39, -1e39, 1e300, math.inf, -math.inf,
                 math.nan)
# leaf bounds on an int32 column: integers and fractions, the int32 ends
# and past them, +-0, +-inf and NaN
K1_I32_BOUNDS = (8766.0, 8765.5, 9130.7, 0.0, -0.0, -0.5, 0.5, -1.0,
                 2147483647.0, 2147483646.5, 2147483647.5, 2147483648.0,
                 3e9, -2147483648.0, -2147483647.5, -2147483648.5,
                 -2147483649.0, -3e9, 1e300, math.inf, -math.inf, math.nan)
_BOUND_SLOT = {"f32": 0, "i32": 3}  # the tested column of each kind
_BOUND_PAIRS = 150  # random pairs of leaves on one column, of each kind


def _f32_steps(x: float, steps: int = 3) -> List[float]:
    """float32(x) and the float32 values up to ``steps`` ulps either
    side of it."""
    with np.errstate(over="ignore"):
        f = np.float32(x)
        out, up, down = [f], f, f
        for _ in range(steps):
            up = np.nextafter(up, np.float32(np.inf))
            down = np.nextafter(down, np.float32(-np.inf))
            out += [up, down]
    return [float(v) for v in out]


def k1_bound_columns(seed: int = 11) -> List[np.ndarray]:
    """q6-shaped columns for the bound sweep: slot 0 a float32 column
    holding each of ``K1_F32_BOUNDS``' float32 neighbours (float32 of the
    bound, +-1..3 ulps), +-0, +-inf, NaN, +-FLT_MAX, the least denormals
    and +-1; slot 3 an int32 column holding each of ``K1_I32_BOUNDS``'
    integer neighbours (floor and ceil, +-1 and +-2, inside int32), the
    int32 ends and 0 and +-1; slots 1 and 2 a price and a discount whose
    products sum exactly even in float32. Each value appears at least
    once, in shuffled order, so 4-row groups mix them."""
    rng = np.random.default_rng(seed)
    fvals = [0.0, -0.0, math.inf, -math.inf, math.nan, _FLT_MAX, -_FLT_MAX,
             _F32_TINY, -_F32_TINY, 1.0, -1.0]
    for b in K1_F32_BOUNDS:
        if not math.isnan(b):
            fvals += _f32_steps(b)
    f = np.unique(np.array(fvals, np.float32).view(np.uint32)) \
        .view(np.float32)
    ivals = {_I32_MIN, _I32_MIN + 1, (1 << 31) - 1, (1 << 31) - 2, 0, 1, -1}
    for b in K1_I32_BOUNDS:
        if math.isfinite(b) and abs(b) < 1e10:
            for base in (math.floor(b), math.ceil(b)):
                ivals |= {v for v in range(base - 2, base + 3)
                          if _I32_MIN <= v < 1 << 31}
    i = np.array(sorted(ivals), np.int64).astype(np.int32)
    n = max(len(f), len(i)) * 2 + 3  # whole groups and a scalar tail
    price = (1 + np.arange(n) % 7).astype(np.float32)
    disc = np.full(n, 0.5, np.float32)
    return [rng.permutation(np.resize(f, n)), price, disc,
            rng.permutation(np.resize(i, n))]


def k1_bound_specs(seed: int = 12) -> List[ck.FilterProductSum]:
    """Every op against every bound of its column's kind, alone; then
    ``_BOUND_PAIRS`` random pairs of such leaves on one column of each
    kind (whose intervals meet, nest or miss)."""
    rng = np.random.default_rng(seed)
    specs = []
    for kind, bounds in (("f32", K1_F32_BOUNDS), ("i32", K1_I32_BOUNDS)):
        leaves = [ck.Leaf(_BOUND_SLOT[kind], op, b)
                  for op in ck.OPS for b in bounds]
        specs += [(leaf,) for leaf in leaves]
        for _ in range(_BOUND_PAIRS):
            j, k = rng.integers(0, len(leaves), 2)
            specs.append((leaves[j], leaves[k]))
    return [ck.FilterProductSum(leaves=s, a_slot=1, b_slot=2)
            for s in specs]


def check_k1_bounds(device) -> List[Dict]:
    """The kernel's folding of a column's leaves into one float32 or
    int32 interval, swept: each of ``k1_bound_specs`` over
    ``k1_bound_columns``, in both editions (Spark's order with a float64
    sum, IEEE with a float32 sum), with the columns 16-byte aligned and
    one element past it (the scalar loop). Every count must equal the
    plain version's and every sum agree to the edition's tolerance.
    Returns one record per (edition, alignment)."""
    host = [torch.from_numpy(c) for c in k1_bound_columns()]
    cols = [c.to(device) for c in host]
    n = cols[0].shape[0]
    specs = k1_bound_specs()
    out = []
    for edition, code, nan_greatest, acc, rtol in (
            ("engine", ck._ENGINE, True, torch.float64, ENGINE_RTOL),
            ("contract", ck._CONTRACT, False, torch.float32,
             CONTRACT_RTOL)):
        want = [ck.filter_product_sum_torch(host, [None] * 4, None, n, spec,
                                            nan_greatest, acc)
                for spec in specs]
        for shift in (0, 4):
            at = [_offset(c, shift) for c in cols] if shift else cols
            got = [ck._launch(code, at, [None] * 4, None, n, spec, acc)
                   for spec in specs]
            sums = torch.stack([s for s, _ in got]).double().cpu()
            counts = torch.stack([c for _, c in got]).cpu()
            worst = 0.0
            for k, (spec, (ws, wc)) in enumerate(zip(specs, want)):
                rel = _rel(sums[k].item(), ws.item())
                worst = max(worst, rel)
                if counts[k].item() != wc.item() or not rel <= rtol:
                    raise AssertionError(
                        f"K1 {edition} edition disagrees on {spec.leaves} "
                        f"at {shift} B off alignment: sum {sums[k].item()!r}"
                        f" plain {ws.item()!r}, count {counts[k].item()} "
                        f"plain {wc.item()}")
            out.append({
                "case": f"bounds_sweep_at_{shift}B", "edition": edition,
                "rows": n, "specs": len(specs),
                "sum": sums.sum().item(),
                "plain_sum": sum(ws.item() for ws, _ in want),
                "count": int(counts.sum()),
                "plain_count": sum(int(wc) for _, wc in want),
                "rel_err": worst})
    return out


def _copies_past_l2(case: K1Case, l2_bytes: int = 50 << 20) \
        -> List[K1Case]:
    """Enough copies of the case's inputs that cycling through them
    reads from device memory, not from the 50 MB L2 cache."""
    k = max(2, -(-2 * l2_bytes // max(1, case.bytes_read())))

    def cp(x):
        return None if x is None else x.clone()

    return [dataclasses.replace(
        case, cols=[c.clone() for c in case.cols],
        valids=[cp(v) for v in case.valids],
        selection=cp(case.selection)) for _ in range(k)]


def _time_ms(fn, copies: List[K1Case], reps: int) -> float:
    """Device milliseconds per call. A sleep kernel holds the stream
    while the host enqueues every call, so the events time the calls
    back to back on the card and not the host's launch rate."""
    for c in copies:  # warm-up
        fn(c)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(_SLEEP_CYCLES)
    start.record()
    for i in range(reps):
        fn(copies[i % len(copies)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_k1(device, reps: int = 100) -> Dict[str, Dict[str, float]]:
    """Device milliseconds per call of each edition and of
    its plain version at the main path's batch shape, reading device
    memory (the inputs cycle through copies larger than L2), timed with
    CUDA events in turns (plain, kernel, kernel, plain)."""
    case = k1_base_cases(device)[0]
    copies = _copies_past_l2(case)
    contract = [dataclasses.replace(c, cols=_contract_inputs(c))
                for c in copies]

    def engine_plain(c):
        return ck.filter_product_sum_torch(c.cols, c.valids, c.selection,
                                           c.row_count, c.spec)

    def contract_plain(c):
        return ck.masked_product_sum_torch(*c.cols)

    out = {}
    for edition, items, plain in (("engine", copies, engine_plain),
                                  ("contract", contract, contract_plain)):
        kernel = _k1_engine if edition == "engine" \
            else lambda c: ck.masked_product_sum(*c.cols)
        p1 = _time_ms(plain, items, reps)
        ms = min(_time_ms(kernel, items, reps),
                 _time_ms(kernel, items, reps))
        p2 = _time_ms(plain, items, reps)
        out[edition] = {"ms": ms, "plain_ms": min(p1, p2),
                        "bytes": items[0].bytes_read()
                        + (16 if edition == "engine" else 12)}
    return out


K1_SWEEP_ROWS = (0, 1 << 16, 1 << 18, MAIN_ROWS, 1 << 21, 1 << 23)


def time_k1_sweep(device, reps: int = 100) -> Dict[str, object]:
    """What a K1 call costs beyond its bytes: device ms of the engine
    edition on q6 columns at each of ``K1_SWEEP_ROWS``
    live rows, over inputs that cycle past L2, and of a one-cycle kernel
    launched the same way (``torch.cuda._sleep(1)``), the card's launch
    cadence. The rise from 0 rows gives the stream rate; the time at 0
    rows the launch's fixed cost."""
    rng = np.random.default_rng(5)
    by_rows = {}
    for rows in K1_SWEEP_ROWS:
        cols = [torch.from_numpy(c).to(device)
                for c in _columns(rng, max(rows, 16))]
        case = K1Case("sweep", cols, [None] * 4, None, rows, ck.Q6_SPEC)
        copies = [dataclasses.replace(case, cols=[c.clone() for c in cols])
                  for _ in range(min(64, _copies_for(case.bytes_read())))]
        by_rows[rows] = min(_time_ms(_k1_engine, copies, reps)
                            for _ in range(2))
    empty = min(_time_ms(lambda _: torch.cuda._sleep(1), [None], reps)
                for _ in range(2))
    return {"ms_by_rows": by_rows, "empty_launch_ms": empty,
            "bytes_per_row": 16}


def k1_trace(device) -> Dict[str, int]:
    """Kernels one engine-edition call at the main batch launches,
    counted from a ``torch.profiler`` trace of that call: the device
    activities whose name holds ``fps_``, K1's kernel prefix. Once a
    process has traced a long run, a later trace there loses device
    records (on an H100: a lone K1 call traced to no kernel,
    add-K1-K1-K1-sum to K1-K1-K1-sum), so ``chip_smoke.py`` calls this
    in a process of its own; the call also sits between two pad kernels
    before it and one after, and the count stands only where the trace
    kept a pad on either side of K1's kernels: ``{"k1": K1's kernels,
    "pads": the pads the trace kept, of 3}``. The trace leaves the
    profiler's hooks in the process, which slows every later launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    case = k1_base_cases(device)[0]
    pad = torch.zeros(1024, device=device)
    _k1_engine(case)  # warm-up: the library and the workspace
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            pad.add_(1)
        _k1_engine(case)
        pad.add_(1)
        torch.cuda.synchronize(device)
    kernels = sorted((e.time_range.start, "fps_" in e.name)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
    k1 = [i for i, (_, is_k1) in enumerate(kernels) if is_k1]
    pads = len(kernels) - len(k1)
    if k1 and not (0 < k1[0] and k1[-1] < len(kernels) - 1) or pads < 2:
        raise AssertionError(f"the trace lost the records around K1: "
                             f"{len(kernels)} kernels, {pads} pads of 3")
    return {"k1": len(k1), "pads": pads}


def k1_kernels_per_call(device) -> int:
    """K1's kernels a call (``k1_trace``)."""
    return k1_trace(device)["k1"]


# --- K3 and K4 --------------------------------------------------------------

K3_SHAPES = (1 << 17, 1 << 21, 1 << 23)  # build presort, partial, final
K4_PROBE_ROWS = 1 << 21
K4_BUILD_ROWS = 1 << 17
NDS_ITEM_ROWS = 32_768  # nds.gen_tables' item at 2^22 store_sales rows
NDS_BATCH_ROWS = 1 << 20  # a store_sales batch: two row groups of 2^19
_RAGGED = 1_000_003
_I64_MIN = -(1 << 63)
_I32_MIN = -(1 << 31)


def _max_abs_diff(pairs) -> float:
    """The largest absolute difference over ``(got, want)`` tensor pairs,
    in float64 (uint64 keys shifted into the signed range first)."""
    worst = 0.0
    for a, b in pairs:
        if a is None or b is None:
            continue
        if a.dtype == torch.int64:
            a, b = a ^ _I64_MIN, b ^ _I64_MIN
        if a.numel():
            d = (a.double() - b.double()).abs().nan_to_num(0.0)
            worst = max(worst, d.max().item())
    return worst


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape \
        and torch.equal(a.contiguous().view(torch.uint8),
                        b.contiguous().view(torch.uint8))


def _month_words(months: np.ndarray, live: np.ndarray, device) \
        -> torch.Tensor:
    """The group-by's sort words for one int32 key, built by the engine's
    own ``_key_lanes`` and ``pack_words``: live bit, null bit, the
    sign-flipped lane. A dead row is null with a zero lane, as the join
    and the aggregate leave it."""
    from .. import datatypes as dt
    from ..columnar.column import GpuColumnVector
    from . import sort_keys as tsk
    live_t = torch.from_numpy(np.ascontiguousarray(live)).to(device)
    col = GpuColumnVector(dt.INT32, torch.from_numpy(np.where(
        live, months, 0).astype(np.int32)).to(device), live_t)
    (words,) = tsk.pack_words(tsk._key_lanes([col], [tsk.SortSpec()],
                                             live_t))
    return words.contiguous()


def path_words(device, n_ord: int = 1 << 17, batch: int = 1 << 21,
               batches: int = 4, seed: int = 9) -> Dict[str, torch.Tensor]:
    """The words the join + group-by path sorts, at its sizes: the build
    presort of the ``n_ord`` order keys (``0 .. n_ord - 1``, all
    eligible), a partial aggregate's month words (every row live), and
    the final's month words over the ``batches`` partials concatenated
    (12 live rows at the head of each partial's capacity, the rest
    dead)."""
    from .sort_keys import pack_words, unsigned_lane
    rng = np.random.default_rng(seed)
    # ops/join.unique_build_probe: an eligibility bit, then the key's lane
    keys = torch.arange(n_ord, dtype=torch.int32, device=device)
    (presort,) = pack_words([(torch.zeros_like(keys, dtype=torch.int64), 1),
                             (unsigned_lane(keys, 32), 32)])
    partial = _month_words(rng.integers(1, 13, batch).astype(np.int32),
                           np.ones(batch, bool), device)
    live = np.zeros(batch * batches, bool)
    months = np.zeros(batch * batches, np.int32)
    for b in range(batches):
        live[b * batch:b * batch + 12] = True
        months[b * batch:b * batch + 12] = rng.permutation(12) + 1
    final = _month_words(months, live, device)
    return {f"presort_2^{n_ord.bit_length() - 1}": presort.contiguous(),
            f"partial_2^{batch.bit_length() - 1}": partial,
            f"final_2^{(batch * batches).bit_length() - 1}": final}


def string_rank_words(device, n: int = NDS_BATCH_ROWS) \
        -> Dict[str, torch.Tensor]:
    """The words a string-rank refinement sorts (``ops/sort_keys.
    string_order_ranks_multi``) over ``item.i_category`` gathered into a
    ``store_sales`` batch of ``n`` rows by its ``ss_item_sk`` (the NDS
    tables at 2^22 rows, seed 42), built by the engine's own
    ``_window_key`` and ``pack_words``: pass 0's one word (the live bit,
    bytes 0-6), and pass 1's two (the dense rank after pass 0 in
    ``bit_length(n)`` bits, bytes 7-13). ``Electronics`` (11 bytes) needs
    both passes."""
    from .. import datatypes as dt
    from .. import nds
    from ..columnar.column import GpuColumnVector
    from . import sort_keys as tsk
    tables = nds.gen_tables(1 << 22)
    cats = np.asarray(tables["item"].column("i_category").to_pylist(),
                      dtype=object)
    keys = tables["store_sales"].column("ss_item_sk").to_numpy()[:n]
    raw = [c.encode() for c in cats[keys]]
    offsets = np.zeros(n + 1, np.int32)
    offsets[1:] = np.cumsum([len(r) for r in raw])
    chars = np.frombuffer(b"".join(raw), np.uint8)
    col = GpuColumnVector.from_string_parts(
        dt.STRING, offsets, chars, None, n, len(chars), torch.device(device))
    live = torch.zeros(n, dtype=torch.int64, device=device)
    (pass0,) = tsk.pack_words([(live, 1), (tsk._window_key(col, 0), 63)])
    rank = torch.unique(pass0, return_inverse=True)[1].to(torch.int64)
    hi, lo = tsk.pack_words([(rank, n.bit_length()),
                             (tsk._window_key(col, 1), 63)])
    e = n.bit_length() - 1
    return {f"string_rank_pass0_2^{e}": pass0.contiguous(),
            f"string_rank_pass1_hi_2^{e}": hi.contiguous(),
            f"string_rank_pass1_lo_2^{e}": lo.contiguous()}


NDS_STORES, NDS_DAYS = 25, 730  # nds.gen_tables' store and date_dim


@functools.lru_cache(maxsize=1)
def _net_profit_cents(n_sales: int) -> np.ndarray:
    """``ss_net_profit`` of the NDS tables at ``n_sales`` rows (seed 42)
    as ``decimal(7,2)`` cents, made once for K3's and K4's cases."""
    from .. import nds
    from ..tools import nds_decimals as nd
    return nd._cents(nd.decimal_tables(nds.gen_tables(n_sales))
                     ["store_sales"], "ss_net_profit")


def _decimal_cents(n: int, seed: int = 15, n_sales: int = 1 << 22):
    """The first ``n`` of ``_net_profit_cents`` (the path's 2^22 rows by
    default), and a validity with about 10% nulls (a seeded mask)."""
    cents = _net_profit_cents(n_sales)[:n].copy()
    valid = np.random.default_rng(seed).random(n) >= 0.1
    return cents, valid


def decimal_words(device, n: int = NDS_BATCH_ROWS,
                  n_sales: int = 1 << 22) -> Dict[str, torch.Tensor]:
    """The two words a sort by a Decimal64 key packs (``sort_keys.
    _key_lanes``: the live bit, the null bit, the unscaled int64 lane
    with its sign bit flipped), over ``_decimal_cents``: negatives,
    nulls, every row live."""
    from .. import datatypes as dt
    from ..columnar.column import GpuColumnVector
    from . import sort_keys as tsk
    cents, valid = _decimal_cents(n, n_sales=n_sales)
    dev = torch.device(device)
    col = GpuColumnVector(dt.DecimalType(7, 2),
                          torch.from_numpy(cents).to(dev),
                          torch.from_numpy(valid).to(dev))
    live = torch.ones(n, dtype=torch.bool, device=dev)
    hi, lo = tsk.pack_words(tsk._key_lanes([col], [tsk.SortSpec()], live))
    return {f"decimal_key_hi_2^{n.bit_length() - 1}": hi.contiguous(),
            f"decimal_key_lo_2^{n.bit_length() - 1}": lo.contiguous()}


def decimal_gather_case(device, seed: int = 16) -> Dict:
    """K4's case for a Decimal64 column: ``_decimal_cents`` and its
    validity gathered by random rows into a 2^20-row batch, 70% live."""
    cents, valid = _decimal_cents(NDS_BATCH_ROWS)
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    n = NDS_BATCH_ROWS
    return {"name": f"decimal_gather_2^{n.bit_length() - 1}",
            "cols": [torch.from_numpy(cents).to(dev)],
            "valids": [torch.from_numpy(valid).to(dev)],
            "idx": torch.from_numpy(rng.integers(0, n, n).astype(np.int32))
            .to(dev),
            "live": torch.from_numpy(rng.random(n) < 0.7).to(dev)}


# lines whose tickets make one scan batch of the nested texts (about
# 61,000 tickets, a row group's worth)
NESTED_SALES = 1 << 19
_TICKETS: List = []


def ticket_batch(device):
    """``tools/nds_nested``'s ticket table at ``NESTED_SALES`` lines as
    one device batch (the host table made once; each call uploads it, so
    no case holds device memory past its use)."""
    from ..columnar.arrow_bridge import arrow_to_device
    if not _TICKETS:
        from .. import nds
        from ..tools import nds_nested as nn
        t = nn.nested_tables(nds.gen_tables(NESTED_SALES))["ticket"]
        _TICKETS.append(t.combine_chunks().to_batches()[0])
    return arrow_to_device(_TICKETS[0], None, torch.device(device))


def _column_on(col, device):
    """A column with every tensor, children included, on ``device``."""
    from ..columnar.column import GpuColumnVector

    def mv(t):
        return None if t is None else t.to(device)
    return GpuColumnVector(col.dtype, mv(col.data), mv(col.validity),
                           mv(col.offsets), mv(col.chars),
                           None if col.children is None
                           else [_column_on(c, device)
                                 for c in col.children])


def nested_columns(device) -> Dict[str, object]:
    """The ticket batch's nested columns and three element shapes made
    from them on the device: ``t_customer`` (a struct), ``t_lines``
    (``array<struct>``), ``t_tags`` (a map), ``array<int64>`` (the
    lines' item keys), ``array<string>`` (the tags' keys) and
    ``array<array<int32>>`` (each basket's quantities in runs of up to
    three)."""
    import pyarrow as pa
    from .. import datatypes as dt
    from ..columnar.arrow_bridge import column_to_device
    from ..columnar.column import GpuColumnVector
    b = ticket_batch(device)
    by = {f.name: c for f, c in zip(b.schema.fields, b.columns)}
    lines, tags = by["t_lines"], by["t_tags"]
    cap = b.capacity
    offs = lines.offsets.cpu().numpy().astype(np.int64)
    qty = lines.children[0].children[1].data.cpu().numpy()
    runs, run_offs, outer = [], [0], [0]
    for i in range(b.row_count):
        q = qty[offs[i]:offs[i + 1]]
        for s in range(0, len(q), 3):
            runs.append(q[s:s + 3])
            run_offs.append(run_offs[-1] + len(q[s:s + 3]))
        outer.append(len(runs))
    inner = pa.ListArray.from_arrays(
        pa.array(np.asarray(run_offs, np.int32)),
        pa.array(np.concatenate(runs) if runs else np.zeros(0, np.int32)))
    valid = lines.valid_mask()[:b.row_count].cpu().numpy()
    nested2 = pa.Array.from_buffers(
        pa.list_(pa.list_(pa.int32())), b.row_count,
        [pa.py_buffer(np.packbits(valid, bitorder="little")),
         pa.py_buffer(np.asarray(outer, np.int32))],
        null_count=int((~valid).sum()), children=[inner])
    return {
        "t_customer": by["t_customer"], "t_lines": lines, "t_tags": tags,
        "array<int64>": GpuColumnVector(
            dt.ArrayType(dt.INT64), None, lines.validity, lines.offsets,
            children=[lines.children[0].children[0]]),
        "array<string>": GpuColumnVector(
            dt.ArrayType(dt.STRING), None, tags.validity, tags.offsets,
            children=[tags.children[0]]),
        "array<array<int32>>": column_to_device(
            nested2, dt.ArrayType(dt.ArrayType(dt.INT32)), cap,
            torch.device(device))}


def _ticket_keep(b) -> torch.Tensor:
    """The nested texts' filter on the ticket batch: a customer born in
    1970 or later, among the live rows."""
    cust = b.columns[b.schema.index_of("t_customer")]
    by = cust.children[1].data
    keep = (by >= 1970) & b.live_mask()
    return keep if cust.validity is None else keep & cust.validity


def nested_k4_cases(device, seed: int = 17) -> List[Dict]:
    """K4's cases at the tickets' shapes, the lanes ``ops/gather`` hands
    it: the ticket batch's compaction (its flat columns, the struct's
    validity and children, the arrays' and the map's starts and lengths,
    in one launch) and the lines' elements gathered by element index
    (the second launch), with nulls and dead rows."""
    from .gather import (_push_lanes, compaction_indices, element_rows,
                         list_offsets)
    b = ticket_batch(device)
    datas, valids = [], []
    for c in b.columns:
        _push_lanes(c, datas, valids)
    keep = _ticket_keep(b)
    idx, count = compaction_indices(keep)
    n = b.capacity
    live = torch.arange(n, device=keep.device) < count
    lines = b.columns[b.schema.index_of("t_lines")]
    lens = torch.where(live, (lines.offsets[1:] - lines.offsets[:-1])
                       [idx.long()], torch.zeros_like(idx))
    ecap = lines.children[0].capacity
    _, _, src, elive = element_rows(
        list_offsets(lens), lines.offsets[:-1][idx.long()], ecap, ecap)
    edatas, evalids = [], []
    _push_lanes(lines.children[0], edatas, evalids)
    rows = n.bit_length() - 1
    return [{"name": f"nested_ticket_compaction_2^{rows}", "cols": datas,
             "valids": valids, "idx": idx.to(torch.int32).contiguous(),
             "live": live},
            {"name": f"nested_lines_elements_2^{ecap.bit_length() - 1}",
             "cols": edatas, "valids": evalids, "idx": src.contiguous(),
             "live": elive}]


def check_nested_gather(device, seed: int = 18) -> List[Dict]:
    """``ops/gather.gather_columns`` on each of ``nested_columns`` (K4 on
    the card) and the ticket batch's compaction (K3, then K4) against the
    same calls on CPU tensors (the plain versions), every tensor of the
    result bit for bit, children included; random rows with 70% live for
    the columns. Raises on a disagreement."""
    from .gather import compact_batch, gather_columns
    cpu = torch.device("cpu")
    rng = np.random.default_rng(seed)
    out = []
    for name, col in nested_columns(device).items():
        n = col.capacity
        idx = rng.permutation(n).astype(np.int32)
        live = rng.random(n) < 0.7
        k4 = ck.gather_rows.launches
        got = gather_columns([col], torch.from_numpy(idx).to(device),
                             torch.from_numpy(live).to(device))[0]
        launches = ck.gather_rows.launches - k4
        want = gather_columns([_column_on(col, cpu)], torch.from_numpy(idx),
                              torch.from_numpy(live))[0]
        pairs = list(zip(got.arrays(), want.arrays()))
        same = len(got.arrays()) == len(want.arrays()) and all(
            _same_bits(a.cpu(), w) for a, w in pairs)
        rec = {"case": f"nested_gather_{name}", "n": n,
               "k4_launches": launches, "equal": same,
               "max_abs_err": _max_abs_diff([(a.cpu(), w)
                                             for a, w in pairs])}
        if not same:
            raise AssertionError(f"nested gather disagrees: {rec}")
        out.append(rec)
    b = ticket_batch(device)
    keep = _ticket_keep(b)
    k3, k4 = ck.sort_pairs.launches, ck.gather_rows.launches
    got = compact_batch(b, keep)
    launches = (ck.sort_pairs.launches - k3, ck.gather_rows.launches - k4)
    bc = type(b)([_column_on(c, cpu) for c in b.columns], b.schema,
                 b.row_count)
    want = compact_batch(bc, keep.cpu())
    ga = [a for c in got.columns for a in c.arrays()]
    wa = [a for c in want.columns for a in c.arrays()]
    same = got.row_count == want.row_count and len(ga) == len(wa) and all(
        _same_bits(a.cpu(), w) for a, w in zip(ga, wa))
    rec = {"case": "nested_ticket_compaction", "n": b.capacity,
           "rows": got.row_count, "k3_launches": launches[0],
           "k4_launches": launches[1], "equal": same,
           "max_abs_err": _max_abs_diff([(a.cpu(), w)
                                         for a, w in zip(ga, wa)])}
    if not same:
        raise AssertionError(f"nested compaction disagrees: {rec}")
    out.append(rec)
    return out


def nested_words(device) -> Dict[str, torch.Tensor]:
    """K3's words when it compacts the ticket batch: the dropped bit of
    each row (``compaction_indices``)."""
    b = ticket_batch(device)
    keep = _ticket_keep(b)
    return {f"nested_ticket_compaction_2^{b.capacity.bit_length() - 1}":
            (~keep).to(torch.int64).contiguous()}


def _window_inputs(device, seed: int = 13):
    """Columns shaped like the window inputs of phase 8 (the NDS tables
    at 2^22 rows), in their grouped aggregate's output order (sorted by
    the group keys, live rows first): q_rolling's (ss_store_sk,
    ss_sold_date_sk, rev, d32) for every store and day, 18,250 rows in a
    capacity of 2^15; and q_rownum's (i_category, i_item_sk, rev) for
    every item, 32,768 rows, the category one of six strings."""
    from .. import datatypes as dt
    from ..columnar.batch import bucket_rows
    from ..columnar.column import GpuColumnVector
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    n = NDS_STORES * NDS_DAYS
    cap = bucket_rows(n)
    store = np.zeros(cap, np.int64)
    day = np.zeros(cap, np.int64)
    store[:n] = np.repeat(np.arange(NDS_STORES), NDS_DAYS)
    day[:n] = np.tile(np.arange(NDS_DAYS), NDS_STORES)
    rev = rng.uniform(0, 2e6, cap)
    live = np.arange(cap) < n
    rolling = {"live": torch.from_numpy(live).to(dev), "cols": [
        GpuColumnVector(dt.INT64, torch.from_numpy(store).to(dev)),
        GpuColumnVector(dt.INT64, torch.from_numpy(day).to(dev)),
        GpuColumnVector(dt.FLOAT64, torch.from_numpy(rev).to(dev)),
        GpuColumnVector(dt.INT32, torch.from_numpy(day.astype(np.int32))
                        .to(dev))]}
    items = NDS_ITEM_ROWS
    names = np.array(["Books", "Electronics", "Home", "Jewelry", "Music",
                      "Sports"], dtype=object)
    cats = np.sort(rng.choice(names, items))
    raw = [c.encode() for c in cats]
    offsets = np.zeros(items + 1, np.int32)
    offsets[1:] = np.cumsum([len(r) for r in raw])
    chars = np.frombuffer(b"".join(raw), np.uint8)
    rownum = {"live": torch.ones(items, dtype=torch.bool, device=dev),
              "cols": [GpuColumnVector.from_string_parts(
                  dt.STRING, offsets, chars, None, items, len(chars), dev),
                  GpuColumnVector(dt.INT64, torch.from_numpy(
                      rng.permutation(items).astype(np.int64)).to(dev)),
                  GpuColumnVector(dt.FLOAT64, torch.from_numpy(
                      rng.uniform(0, 1e6, items)).to(dev))]}
    return rolling, rownum


def window_words(device) -> Dict[str, torch.Tensor]:
    """The words the window sorts of phase 8 hand K3, built by the
    engine's own ``_key_lanes`` and ``pack_words`` over
    ``_window_inputs``: q_rolling's (ss_store_sk, d32), two words, and
    q_rownum's (i_category's rank, rev descending, i_item_sk), three."""
    from .sort_keys import SortSpec, _key_lanes, pack_words
    rolling, rownum = _window_inputs(device)
    out = {}
    for name, inp, keys, specs in (
            ("q_rolling", rolling, [rolling["cols"][0],
                                    rolling["cols"][3]],
             [SortSpec(), SortSpec()]),
            ("q_rownum", rownum, [rownum["cols"][0], rownum["cols"][2],
                                  rownum["cols"][1]],
             [SortSpec(), SortSpec(False, False), SortSpec()])):
        words = pack_words(_key_lanes(keys, specs, inp["live"]))
        e = inp["live"].shape[0].bit_length() - 1
        for i, w in enumerate(words):
            out[f"window_{name}_word{i}_2^{e}"] = w.contiguous()
    return out


def k3_cases(device, seed: int = 1) -> List[Dict]:
    """Engine-edition inputs: ``{"name", "keys", "payload"}``; keys are
    uint64 bits in int64."""
    rng = np.random.default_rng(seed)
    dev = torch.device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def rand64(n):
        return rng.integers(_I64_MIN, (1 << 63) - 1, n, dtype=np.int64,
                            endpoint=True)

    def packed(n):
        """The group-by's words: live bit, null bit, a month lane."""
        live = rng.random(n) < 0.9
        month = rng.integers(1, 13, n).astype(np.int64) + (1 << 31)
        return (((~live).astype(np.int64) << 33)
                | (live.astype(np.int64) << 32) | month)

    def shifted(bits, shift, n):
        """Keys whose only varying bits are ``bits`` random bits at
        ``shift``, over a constant low pattern."""
        v = rng.integers(0, 1 << bits, n).astype(np.uint64) \
            << np.uint64(shift)
        return (v | np.uint64(0x5A5A)).view(np.int64)

    n, big = K3_SHAPES[1], K3_SHAPES[2]
    cases = [{"name": f"random_2^{s.bit_length() - 1}",
              "keys": t(rand64(s)), "payload": None} for s in K3_SHAPES]
    cases += [{"name": name, "keys": words, "payload": None}
              for name, words in path_words(dev).items()]
    cases += [{"name": name, "keys": words, "payload": None}
              for name, words in string_rank_words(dev).items()]
    cases += [{"name": name, "keys": words, "payload": None}
              for name, words in window_words(dev).items()]
    cases += [{"name": name, "keys": words, "payload": None}
              for name, words in decimal_words(dev).items()]
    cases += [{"name": name, "keys": words, "payload": None}
              for name, words in nested_words(dev).items()]
    cases += [
        {"name": "groupby_words_2^21", "keys": t(packed(n)),
         "payload": None},
        {"name": "ragged", "keys": t(rand64(_RAGGED)), "payload": None},
        {"name": "all_equal", "keys": t(np.full(n, 42, np.int64)),
         "payload": None},
        {"name": "sorted", "keys": t(np.arange(n, dtype=np.int64)),
         "payload": None},
        {"name": "reverse", "keys": t(np.arange(n, 0, -1, dtype=np.int64)),
         "payload": None},
        {"name": "heavy_dup", "keys": t(rng.integers(0, 16, n)),
         "payload": None},
        {"name": "payload_ragged", "keys": t(rng.integers(0, 1000, _RAGGED)),
         "payload": t(rng.integers(0, 1 << 20, _RAGGED).astype(np.int32))},
        {"name": "sign_bit_only_2^21", "keys": t(shifted(1, 63, n)),
         "payload": None},
        {"name": "top_digit_only_2^21", "keys": t(shifted(8, 56, n)),
         "payload": None},
        {"name": "compaction_1bit_2^21",
         "keys": t((rng.random(n) < 0.3).astype(np.int64)),
         "payload": None},
        {"name": "month_words_2^23_90pct_dead",
         "keys": _month_words(rng.integers(1, 13, big).astype(np.int32),
                              rng.random(big) < 0.1, dev),
         "payload": None},
        {"name": "payload_negative_dup_ragged",
         "keys": t(shifted(3, 60, _RAGGED)),
         "payload": t(rng.integers(-40, 40, _RAGGED).astype(np.int32))},
        {"name": "payload_negative_2^21", "keys": t(rand64(n)),
         "payload": t(rng.integers(_I32_MIN, 1 << 31, n)
                      .astype(np.int32))},
    ]
    return cases


def library_sort_pairs(keys: torch.Tensor,
                       payload: Optional[torch.Tensor]):
    """``(keys, payloads)`` ordered on (key unsigned, payload signed) by
    ``torch.sort(stable=True)``: by the payload first, then stably by the
    key; the payload is the position when none is given."""
    if payload is None:
        k, p = torch.sort(keys ^ _I64_MIN, stable=True)
        return k ^ _I64_MIN, p.to(torch.int32)
    p, order = torch.sort(payload, stable=True)
    k, order2 = torch.sort(keys[order] ^ _I64_MIN, stable=True)
    return k ^ _I64_MIN, p[order2]


def check_k3(device) -> List[Dict]:
    """Both editions of K3 against their plain versions, and the engine
    edition against ``torch.sort(stable=True)`` (``library_sort_pairs``),
    all exact; raises on the first disagreement."""
    out = []
    for case in k3_cases(device):
        keys, pay = case["keys"], case["payload"]
        got_k, got_p = ck.sort_pairs(keys, pay)
        want_k, want_p = ck.sort_pairs_torch(keys, pay)
        lib_k, lib_p = library_sort_pairs(keys, pay)
        rec = {"case": case["name"], "n": keys.shape[0],
               "passes": ck.sort_passes_torch(keys, pay),
               "keys_equal": torch.equal(got_k, want_k),
               "payload_equal": torch.equal(got_p, want_p),
               "library_equal": torch.equal(got_k, lib_k)
               and torch.equal(got_p, lib_p)}
        rec["max_abs_err"] = _max_abs_diff([(got_k, want_k),
                                            (got_p, want_p)])
        if not all(v for k, v in rec.items() if k.endswith("_equal")):
            raise AssertionError(f"K3 engine edition disagrees: {rec}")
        out.append(rec)
    rng = np.random.default_rng(2)
    for name, keys in (
            ("contract_f32_2^21", rng.uniform(-1e6, 1e6, 1 << 21)
             .astype(np.float32)),
            ("contract_i32_ragged", rng.integers(-10**6, 10**6, _RAGGED)
             .astype(np.int32))):
        if keys.dtype == np.float32:
            keys[rng.random(keys.shape[0]) < 0.01] = np.nan
            keys[rng.random(keys.shape[0]) < 0.01] = -0.0
        k = torch.from_numpy(keys).to(device)
        got, want = ck.sort_keys(k), ck.sort_keys_torch(k)
        rec = {"case": name, "n": k.shape[0],
               "keys_equal": _same_bits(got, want),
               "max_abs_err": _max_abs_diff([(got, want)])}
        if not rec["keys_equal"]:
            raise AssertionError(f"K3 contract edition disagrees: {rec}")
        out.append(rec)
    return out


def _cycle(make, count: int) -> List:
    return [make() for _ in range(count)]


def _copies_for(nbytes: int, l2_bytes: int = 50 << 20) -> int:
    return max(2, -(-2 * l2_bytes // max(1, nbytes)))


def _turns(plain, kernel, items, reps: int, plain_reps: int):
    """(kernel ms, plain ms), in turns plain, kernel, kernel, plain."""
    p1 = _time_ms(plain, items, plain_reps)
    k1 = _time_ms(kernel, items, reps)
    k2 = _time_ms(kernel, items, reps)
    p2 = _time_ms(plain, items, plain_reps)
    return min(k1, k2), min(p1, p2)


# Bytes a sort must move: each key read once (8 B) and each pair written
# once (12 B); the payload, where one is given, adds its 4 B read
SORT_BYTES_PER_PAIR = 8 + 12


def time_k3(device, reps: int = 20) -> Dict[str, Dict[str, float]]:
    """Device ms of the engine edition, its plain version and
    ``torch.sort(stable=True)`` on the same keys (payload the position),
    with the bytes the sort must move (``SORT_BYTES_PER_PAIR``) and the
    digit passes the keys need: on random 64-bit keys at each shape of
    the path (``random_2^k``), on the path's own words
    (``path_words``: build presort, partial, final), on a string-rank
    pass's words (``string_rank_words``) and on the window sorts' words
    (``window_words``)."""
    rng = np.random.default_rng(3)
    sets = {}
    for n in K3_SHAPES:
        sets[f"random_2^{n.bit_length() - 1}"] = _cycle(
            lambda: torch.from_numpy(rng.integers(
                _I64_MIN, (1 << 63) - 1, n, dtype=np.int64)).to(device),
            _copies_for(n * 8))
    for name, words in {**path_words(device), **string_rank_words(device),
                        **window_words(device),
                        **nested_words(device)}.items():
        sets[name] = _cycle(words.clone, _copies_for(words.numel() * 8))
    out = {}
    for name, copies in sets.items():
        n = copies[0].shape[0]
        ms, plain_ms = _turns(ck.sort_pairs_torch, ck.sort_pairs, copies,
                              reps, 2)
        lib = _time_ms(lambda k: torch.sort(k, stable=True), copies, reps)
        out[name] = {"n": n, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib, "bytes": n * SORT_BYTES_PER_PAIR,
                     "passes": len(ck.sort_passes_torch(copies[0])),
                     "ops": n * 8}
    return out


def k4_cases(device, seed: int = 4) -> List[Dict]:
    """Engine-edition inputs: ``{"name", "cols", "valids", "idx",
    "live"}``."""
    rng = np.random.default_rng(seed)
    dev = torch.device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    b, n = K4_BUILD_ROWS, K4_PROBE_ROWS
    build = [t(np.arange(b, dtype=np.int32)),
             t(rng.integers(1, 13, b).astype(np.int32))]
    perm = rng.permutation(n).astype(np.int32)
    widths_rows = 1 << 16
    widths = [t(rng.random(widths_rows) < 0.5),
              t(rng.integers(-128, 128, widths_rows).astype(np.int8)),
              t(rng.integers(-2**15, 2**15, widths_rows).astype(np.int16)),
              t(rng.standard_normal(widths_rows).astype(np.float32)),
              t(rng.integers(-2**62, 2**62, widths_rows)),
              t(rng.standard_normal(widths_rows))]
    def same_width(dtype):
        """Three columns of one width: the templated kernel at widths 1, 2
        and 8, at a ragged length, with indices and live flags that start
        off alignment (the scalar loads) and out-of-range indices."""
        if dtype == np.float64:
            cols = [t(rng.standard_normal(widths_rows)) for _ in range(3)]
        else:
            info = np.iinfo(dtype)
            cols = [t(rng.integers(info.min, info.max, widths_rows,
                                   endpoint=True).astype(dtype))
                    for _ in range(3)]
        idx = t(rng.integers(-5, widths_rows + 5, _RAGGED + 1)
                .astype(np.int32))[1:]
        live = t(rng.random(_RAGGED + 1) < 0.8)[1:]
        return {"name": f"same_width_{np.dtype(dtype).itemsize}_unaligned",
                "cols": cols,
                "valids": [None, t(rng.random(widths_rows) < 0.9), None],
                "idx": idx, "live": live}

    # the NDS join: item's build columns, its string as starts and
    # lengths, gathered into a store_sales batch
    items, stream = NDS_ITEM_ROWS, NDS_BATCH_ROWS
    lens = rng.integers(0, 12, items).astype(np.int32)
    join = [t(np.arange(items, dtype=np.int64))] + [
        t(rng.integers(1, 100, items).astype(np.int32)) for _ in range(3)
    ] + [t(rng.uniform(0.5, 300, items)),
         t((np.cumsum(lens) - lens).astype(np.int32)), t(lens)]
    rolling, _ = _window_inputs(dev)
    wcap = rolling["live"].shape[0]
    wperm = torch.from_numpy(np.r_[rng.permutation(NDS_STORES * NDS_DAYS),
                                   np.arange(NDS_STORES * NDS_DAYS, wcap)]
                             .astype(np.int32)).to(dev)
    dead_idx = rng.integers(0, b, n).astype(np.int32)
    dead_live = rng.random(n) < 0.5
    dead_idx[~dead_live] = rng.integers(-2**31, 2**31 - 1,
                                        int((~dead_live).sum()))
    return [
        {"name": "probe_2^21", "cols": build, "valids": [None, None],
         "idx": t(rng.integers(0, b, n).astype(np.int32)),
         "live": t(rng.random(n) < 0.9)},
        {"name": "groupby_perm_2^21",
         "cols": [t(rng.integers(1, 13, n).astype(np.int32)),
                  t(rng.uniform(0, 1e5, n).astype(np.float32))],
         "valids": [t(rng.random(n) < 0.9), None], "idx": t(perm),
         "live": t(rng.random(n) < 0.9)},
        {"name": "ragged", "cols": build, "valids": [None, None],
         "idx": t(rng.integers(0, b, _RAGGED).astype(np.int32)),
         "live": None},
        {"name": "nulls", "cols": build,
         "valids": [t(rng.random(b) < 0.95), t(rng.random(b) < 0.8)],
         "idx": t(rng.integers(0, b, n).astype(np.int32)),
         "live": t(rng.random(n) < 0.9)},
        {"name": "dead_rows_out_of_range", "cols": build,
         "valids": [None, t(rng.random(b) < 0.8)], "idx": t(dead_idx),
         "live": t(dead_live)},
        {"name": "widths_1_2_4_8", "cols": widths,
         "valids": [t(rng.random(widths_rows) < 0.9)] + [None] * 5,
         "idx": t(rng.integers(-5, widths_rows + 5, n).astype(np.int32)),
         "live": t(rng.random(n) < 0.7)},
        {"name": "nds_join_item_strings_2^20", "cols": join,
         "valids": [None] * 5 + [t(rng.random(items) < 0.95), None],
         "idx": t(rng.integers(0, items, stream).astype(np.int32)),
         "live": t(rng.random(stream) < 0.3)},
        # the window's gather of q_rolling's rows into sorted order
        {"name": "window_q_rolling_2^15",
         "cols": [c.data for c in rolling["cols"]],
         "valids": [None] * 4, "idx": wperm, "live": rolling["live"]},
    ] + [same_width(d) for d in (np.int8, np.int16, np.float64)] + [
        decimal_gather_case(dev)] + nested_k4_cases(dev)


def check_string_gather(device, seed: int = 6) -> Dict:
    """``gather_strings`` (K4 on starts and lengths, then offsets and
    chars in torch) at the NDS join's shape, an ``item`` string column
    of 32,768 rows with nulls and empty strings gathered into a 2^20-row
    batch with dead rows, against pyarrow's ``take`` of the same rows:
    offsets, chars and validity; raises on a disagreement."""
    import pyarrow as pa
    from .. import datatypes as dt
    from ..columnar.arrow_bridge import string_column_from_host
    from ..columnar.batch import bucket_bytes
    from .strings import gather_strings
    rng = np.random.default_rng(seed)
    items, n = NDS_ITEM_ROWS, NDS_BATCH_ROWS
    words = ["Electronics", "Home", "Sports", "", "Jewelry", "Müsic"]
    src = pa.array(rng.choice(words, items).tolist(),
                   mask=rng.random(items) < 0.05)
    col = string_column_from_host(dt.STRING, src, items, device)
    idx = rng.integers(0, items, n).astype(np.int32)
    live = rng.random(n) < 0.3
    longest = max(len(w.encode()) for w in words)
    got = gather_strings(col, torch.from_numpy(idx).to(device),
                         bucket_bytes(n * longest),
                         torch.from_numpy(live).to(device))
    want = src.take(pa.array(idx)).to_pylist()
    want = [w if keep else "" for w, keep in zip(want, live)]
    lens = np.array([len(w.encode()) if w else 0 for w in want])
    offsets = np.zeros(n + 1, np.int32)
    offsets[1:] = np.cumsum(lens)
    chars = np.frombuffer("".join(w or "" for w in want).encode(), np.uint8)
    valid = np.array([w is not None for w in src.take(pa.array(idx))
                      .to_pylist()]) & live
    g_chars = got.chars.cpu().numpy()
    rec = {"case": "gather_strings_nds_join_2^20", "n": n,
           "columns": 1,
           "offsets_equal": bool(np.array_equal(
               got.offsets.cpu().numpy(), offsets)),
           "chars_equal": bool(np.array_equal(g_chars[:chars.shape[0]],
                                              chars)
                               and not g_chars[chars.shape[0]:].any()),
           "validity_equal": bool(np.array_equal(
               got.validity.cpu().numpy() & live, valid)),
           "max_abs_err": 0.0}
    if not (rec["offsets_equal"] and rec["chars_equal"]
            and rec["validity_equal"]):
        raise AssertionError(f"gather_strings disagrees with pyarrow: "
                             f"{rec}")
    return rec


def check_k4(device) -> List[Dict]:
    """Both editions of K4 against their plain versions, bit for bit;
    raises on the first disagreement."""
    out = []
    for case in k4_cases(device):
        got, got_v = ck.gather_rows(case["cols"], case["valids"],
                                    case["idx"], case["live"])
        want, want_v = ck.gather_rows_torch(case["cols"], case["valids"],
                                            case["idx"], case["live"])
        same = all(_same_bits(a, b) for a, b in zip(got, want))
        same_v = all((a is None and b is None) or (
            a is not None and b is not None and _same_bits(a, b))
            for a, b in zip(got_v, want_v))
        rec = {"case": case["name"], "n": case["idx"].shape[0],
               "columns": len(case["cols"]), "data_equal": same,
               "validity_equal": same_v,
               "max_abs_err": _max_abs_diff(list(zip(got, want))
                                            + list(zip(got_v, want_v)))}
        if not (same and same_v):
            raise AssertionError(f"K4 engine edition disagrees: {rec}")
        out.append(rec)
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.standard_normal(K4_BUILD_ROWS)
                             .astype(np.float32)).to(device)
    idx = torch.from_numpy(rng.integers(0, K4_BUILD_ROWS, _RAGGED)
                           .astype(np.int32)).to(device)
    got, want = ck.gather(table, idx), ck.gather_torch(table, idx)
    same = _same_bits(got, want)
    rec = {"case": "contract_f32_ragged", "n": _RAGGED, "columns": 1,
           "data_equal": same, "validity_equal": True,
           "max_abs_err": _max_abs_diff([(got, want)])}
    if not same:
        raise AssertionError(f"K4 contract edition disagrees: {rec}")
    out.append(rec)
    return out


def time_k4(device, reps: int = 50) -> Dict[str, Dict[str, float]]:
    """Device ms of the engine edition, its plain version and
    ``torch.index_select`` of the same rows from the columns stacked (no
    live mask, no validity), with the bytes the gather must move (a dead
    row reads neither its index nor its source; each copy of the inputs
    holds its own source, so the source is read from device memory), at two
    shapes of the path: the probe (2^21 rows gathering the two int32
    build columns of 2^17 rows, 90% live) and the partial aggregate's
    permutation (2^21 rows of an int32 key with validity and a float32
    value, by a permutation, 90% live); at the probe with one column,
    which shows how the time grows with the random sectors a row; and at
    the window's gather of q_rolling's rows (``_window_inputs``: four
    columns of 2^15 rows by a permutation of its 18,250 live rows, the
    live prefix as the mask); and at the ticket lines' elements gathered
    by element index (``nested_k4_cases``: item key, quantity, price with
    its validity)."""
    rng = np.random.default_rng(6)
    b, n = K4_BUILD_ROWS, K4_PROBE_ROWS

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def live90():
        return t(rng.random(n) < 0.9)

    # name: (columns, validities, indices, live mask, output rows)
    shapes = {
        # one column: the random L2 sectors a row halve
        "probe_1col_2^21_from_2^17": (
            [t(np.arange(b, dtype=np.int32))], [None],
            lambda: t(rng.integers(0, b, n).astype(np.int32)), live90, n),
        "probe_2^21_from_2^17": (
            [t(np.arange(b, dtype=np.int32)),
             t(rng.integers(1, 13, b).astype(np.int32))], [None, None],
            lambda: t(rng.integers(0, b, n).astype(np.int32)), live90, n),
        "groupby_perm_2^21": (
            [t(rng.integers(1, 13, n).astype(np.int32)),
             t(rng.uniform(0, 1e5, n).astype(np.float32))],
            [t(rng.random(n) < 0.9), None],
            lambda: t(rng.permutation(n).astype(np.int32)), live90, n),
    }
    # the window's gather of q_rolling's four columns by its permutation
    rolling, _ = _window_inputs(device)
    wcols = [c.data for c in rolling["cols"]]
    wn = NDS_STORES * NDS_DAYS
    shapes["window_q_rolling_2^15"] = (
        wcols, [None] * 4,
        lambda: t(np.r_[rng.permutation(wn),
                        np.arange(wn, wcols[0].shape[0])].astype(np.int32)),
        lambda: rolling["live"], wcols[0].shape[0])
    # the nested texts' second launch, the ticket lines' elements by
    # element index after the compaction: made after the other shapes
    # are timed
    def nested():
        elem = nested_k4_cases(device)[1]
        return (elem["cols"], elem["valids"], lambda: elem["idx"],
                lambda: elem["live"], elem["idx"].shape[0])
    shapes["nested_lines_elements_2^19"] = nested
    def stack(cols):
        return torch.stack([c.view(torch.int32) for c in cols
                            if c.element_size() == 4]
                           + [c.view(torch.int32).view(-1, 2)[:, i]
                              for c in cols if c.element_size() == 8
                              for i in (0, 1)], 1).contiguous()

    def copy(ts):
        return [None if x is None else x.clone() for x in ts]

    out = {}
    for name, shape in shapes.items():
        cols, valids, make_idx, make_live, n_out = \
            shape() if callable(shape) else shape
        rows = cols[0].shape[0]
        # a row's bytes, in the source and in the output alike
        width = sum(c.element_size() for c in cols) + sum(
            1 for v in valids if v is not None)
        # each copy holds its own source, indices and live mask, so no
        # call finds the last one's source in L2
        items = _cycle(lambda: (copy(cols), copy(valids), make_idx(),
                                make_live()),
                       _copies_for(n_out * (4 + 1 + width) + rows * width))
        stacked = [stack(it[0]) for it in items]
        ms, plain_ms = _turns(
            lambda it: ck.gather_rows_torch(*it),
            lambda it: ck.gather_rows(*it), items, reps, reps)
        lib = _time_ms(lambda i: torch.index_select(stacked[i], 0,
                                                    items[i][2]),
                       range(len(items)), reps)
        # a dead row reads neither its index nor its source: the live
        # rows read their indices, the distinct rows they name are read
        # once, and every output row reads its live flag and is written
        live = [it[3] for it in items]
        n_live = sum(int(m.sum()) for m in live) / len(items)
        distinct = sum(int(torch.unique(it[2][m]).numel())
                       for it, m in zip(items, live)) / len(items)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib,
                     "bytes": round(n_out * (1 + width) + n_live * 4
                                    + distinct * width),
                     "rows": n_out, "live_rows": round(n_live),
                     "source_rows_read": round(distinct),
                     "table_rows": rows}
    return out


# --- K5 and K2 --------------------------------------------------------------

def _write(directory: str, name: str, arrays: Dict, **kw) -> str:
    import pyarrow as pa
    import pyarrow.parquet as pq
    path = os.path.join(directory, name)
    pq.write_table(pa.table(arrays), path, **kw)
    return path


def k5_shapes_file(directory: str, n: int, seed: int = 7) -> str:
    """A Parquet file of ``n`` rows in one row group whose columns take
    K5's other shapes: alternating values, a dictionary of 100,000
    entries (past the kernel's shared-memory budget), and 64-bit PLAIN
    int64 and float64."""
    import pyarrow as pa
    rng = np.random.default_rng(seed)
    pool = rng.integers(-1 << 31, 1 << 31, 100_000).astype(np.int32)
    return _write(directory, "shapes.parquet", {
        "alternating": pa.array(np.where(np.arange(n) % 2, 7, -3)
                                .astype(np.int32)),
        "big_dict": pa.array(np.concatenate([
            pool, rng.choice(pool, max(n - pool.shape[0], 0))])[:n]),
        "plain_i64": pa.array(rng.integers(-1 << 60, 1 << 60, n)),
        "plain_f64": pa.array(rng.standard_normal(n)),
    }, row_group_size=n, compression="snappy",
        use_dictionary=["alternating", "big_dict"])


def nds_layouts(directory: str) -> Dict[str, list]:
    """``{case: [(scan, BatchLayout), ...]}`` at the NDS path's shapes:
    ``nds.gen_tables`` at 2^22 ``store_sales`` rows (seed 42), written
    as the path writes them, with ``store_sales`` cut to its first 2^20
    rows (two row groups, which the scan coalesces into one batch), and
    ``item`` (32,768 rows, ``i_category`` a dictionary string column),
    ``store`` (25 rows, ``s_state`` a dictionary string column) and
    ``customer`` (65,536 rows) whole, every column read; and ``item``
    with ``i_category`` all null, written PLAIN (no dictionary), whose
    string store holds no strings."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from .. import nds
    from ..columnar.arrow_bridge import engine_schema
    from ..config import RapidsConf
    from ..io.scan import GpuFileScanExec
    tables = nds.gen_tables(1 << 22)
    paths = nds.write_tables(
        {"store_sales": tables["store_sales"].slice(0, NDS_BATCH_ROWS),
         "item": tables["item"], "store": tables["store"],
         "customer": tables["customer"]}, os.path.join(directory, "nds"))
    item = tables["item"]
    at = item.schema.get_field_index("i_category")
    paths["item_null_category_plain"] = os.path.join(
        directory, "nds", "item_null_category_plain.parquet")
    pq.write_table(item.set_column(at, "i_category", pa.nulls(
        item.num_rows, pa.string())), paths["item_null_category_plain"],
        use_dictionary=False)
    out = {}
    for name in ("store_sales", "item", "store", "customer",
                 "item_null_category_plain"):
        path = paths[name]
        scan = GpuFileScanExec([path], schema=engine_schema(
            pq.ParquetFile(path).schema_arrow))
        out[f"nds_{name}_batch"] = [
            (scan, lay) for lay in scan.batch_layouts(RapidsConf())]
    return out


def decimal_layouts(directory: str, seed: int = 17) -> Dict[str, list]:
    """``{case: [(scan, BatchLayout)]}``: a file of two row groups of
    2^19 rows, written as Spark writes decimals (INT32 up to 9 digits,
    INT64 up to 18): a long key, a ``DECIMAL(7,2)`` and a
    ``DECIMAL(12,2)``, both with nulls and negatives and the extremes
    +-(10^p - 1), coalesced into one batch."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from ..columnar.arrow_bridge import engine_schema
    from ..config import RapidsConf
    from ..io.scan import GpuFileScanExec
    rng = np.random.default_rng(seed)
    n = 1 << 20

    def column(p):
        v = rng.integers(-(10 ** p - 1), 10 ** p, n, dtype=np.int64)
        v[:2] = (10 ** p - 1, -(10 ** p - 1))
        words = np.empty((n, 2), np.int64)
        words[:, 0], words[:, 1] = v, v >> 63
        valid = rng.random(n) >= 0.1
        return pa.Array.from_buffers(
            pa.decimal128(p, 2), n,
            [pa.py_buffer(np.packbits(valid, bitorder="little")),
             pa.py_buffer(words)], null_count=int(n - valid.sum()))

    path = _write(directory, "decimals.parquet", {
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "price": column(7), "amount": column(12)},
        row_group_size=n // 2, compression="snappy",
        store_decimal_as_integer=True)
    scan = GpuFileScanExec([path], schema=engine_schema(
        pq.ParquetFile(path).schema_arrow))
    return {"decimal_int32_int64_2^20": [
        (scan, lay) for lay in scan.batch_layouts(RapidsConf())]}


def k5_layouts(directory: str, seed: int = 7) -> Dict[str, list]:
    """``{case: [(scan, BatchLayout), ...]}`` over Parquet files written
    into ``directory``: the q6 row group (the four q6 columns alone, as
    q6 scans them, and with l_linenumber), nulls + DELTA + v2 pages, a
    coalesced batch of row groups with differing dictionaries, 64-bit
    and large-dictionary shapes, and ``nds_layouts``."""
    import pyarrow as pa
    from .. import tpch
    from ..columnar.arrow_bridge import engine_schema
    from ..config import RapidsConf
    from ..io.scan import GpuFileScanExec
    rng = np.random.default_rng(seed)
    q6 = tpch.write_lineitem(
        tpch.gen_lineitem(MAIN_ROWS, seed=0, linenumber=True),
        os.path.join(directory, "q6"), n_files=1)
    n = 300_000
    mixed = _write(directory, "mixed.parquet", {
        "null_dict": pa.array(rng.integers(0, 50, n).astype(np.int32),
                              mask=rng.random(n) < 0.25),
        "delta64": pa.array(rng.integers(-1000, 1000, n).cumsum(),
                            mask=rng.random(n) < 0.2),
        "delta32": pa.array((rng.integers(-100, 100, n).cumsum()
                             % 1_000_000).astype(np.int32)),
        "flag": pa.array(rng.random(n) < 0.5),
        "plain_f64": pa.array(rng.standard_normal(n),
                              mask=rng.random(n) < 0.1),
        "all_null": pa.array([None] * n, type=pa.int64()),
    }, row_group_size=n, compression="zstd", data_page_version="2.0",
        data_page_size=16 << 10, use_dictionary=["null_dict", "flag",
                                                  "all_null"],
        column_encoding={"delta64": "DELTA_BINARY_PACKED",
                         "delta32": "DELTA_BINARY_PACKED",
                         "plain_f64": "PLAIN"})
    m = 240_000
    grp = np.arange(m) // 40_000
    coalesced = _write(directory, "coalesced.parquet", {
        "dict_i32": pa.array((rng.integers(0, 7, m) + grp * 1000)
                             .astype(np.int32)),
        "dict_f32": pa.array((rng.integers(0, 5, m) + grp * 0.5)
                             .astype(np.float32),
                             mask=rng.random(m) < 0.05),
        "rle": pa.array(np.sort(rng.integers(0, 5, m)).astype(np.int64)),
        "date": pa.array(rng.integers(8000, 9000, m).astype(np.int32))
        .cast(pa.date32()),
    }, row_group_size=40_000, compression="snappy")
    one_batch = RapidsConf({"spark.rapids.sql.scan.coalesceTargetBytes":
                            "1g"})
    out = {}
    for case, path, schema, conf in (
            ("q6_batch", q6[0], tpch.LINEITEM_SCHEMA, RapidsConf()),
            ("q6_by_linenumber_batch", q6[0], tpch.LINEITEM_GROUPED_SCHEMA,
             RapidsConf()),
            ("nulls_delta_v2", mixed, None, RapidsConf()),
            ("coalesced", coalesced, None, one_batch),
            ("shapes", k5_shapes_file(directory, 300_000, seed), None,
             RapidsConf())):
        import pyarrow.parquet as pq
        if schema is None:
            schema = engine_schema(pq.ParquetFile(path).schema_arrow)
        scan = GpuFileScanExec([path], schema=schema)
        out[case] = [(scan, lay) for lay in scan.batch_layouts(conf)]
    out.update(nds_layouts(directory))
    return out




def _tile_plan(n_rows: int, lane, runs, words, dictionary=None,
               def_runs=None, def_words=None, n_valid=None,
               is_delta=False):
    """A hand-made ``ChunkPlan``: a run table (rows of dense start, meta,
    value, bit offset) over ``words``; every row valid unless
    ``def_runs`` say otherwise."""
    from ..io.parquet_plan import ChunkPlan
    runs = np.asarray(runs, np.int64).reshape(-1, 4)
    words = np.asarray(words, np.uint32)
    lane = np.dtype(lane)
    dictionary = np.zeros(0, lane) if dictionary is None \
        else np.asarray(dictionary, lane)
    if def_runs is None:
        def_runs = [(0, 1 | _META_RLE, 1, 0)]
        def_words = np.zeros(2, np.uint32)
    def_runs = np.asarray(def_runs, np.int64).reshape(-1, 4)
    def_words = np.asarray(def_words, np.uint32)
    n_valid = n_rows if n_valid is None else n_valid
    nbytes = words.nbytes + runs.nbytes + dictionary.nbytes \
        + def_words.nbytes + def_runs.nbytes
    return ChunkPlan(n_rows, lane, dictionary, words, runs, def_words,
                     def_runs, n_valid, nbytes, is_delta=is_delta)


def _def_levels(rng, valid: np.ndarray):
    """Definition-level runs and words for ``valid``: RLE runs where a
    stretch of 8 rows agrees, bit-packed groups of 8 elsewhere."""
    runs, bits = [], []
    for g0 in range(0, valid.shape[0], 8):
        grp = valid[g0:g0 + 8]
        if grp.all() or not grp.any():
            runs.append((g0, 1 | _META_RLE, int(grp[0]), 0))
        else:
            runs.append((g0, 1, 0, 8 * len(bits)))
            bits.append(int(np.packbits(np.pad(grp, (0, 8 - grp.shape[0])),
                                        bitorder="little")[0]))
    raw = np.asarray(bits + [0] * 8, np.uint8)
    raw = np.pad(raw, (0, -raw.shape[0] % 4))
    return runs, raw.view(np.uint32)


def _packed(rng, n_words: int) -> np.ndarray:
    """Random words, every third with its top bit set."""
    w = rng.integers(0, 1 << 32, n_words, dtype=np.uint64).astype(np.uint32)
    w[::3] |= np.uint32(1 << 31)
    return w


def k5_tile_layouts(seed: int = 11) -> Dict[str, "BatchLayout"]:
    """``{case: BatchLayout}`` over hand-made run tables that walk K5's
    tiles (4096 rows) at their edges: RLE runs of length 1 across whole
    tiles, runs straddling two and three tiles, widths 0 to 64 (64-bit
    PLAIN from an odd word), tables of 1 and 2 words, a tile whose first
    rows are null, an all-null column, DELTA pages with nulls, identity
    runs, row counts at and one off a tile's edge, merged dictionaries
    whose base differs per run, a dictionary past the shared-memory
    budget, and an int32 lane under an int64 column."""
    from .. import datatypes as dt
    from ..columnar.batch import bucket_rows
    from .parquet_decode import BatchLayout, TILE_ROWS
    rng = np.random.default_rng(seed)
    T = TILE_ROWS
    out = {}

    def layout(name, n_rows, cols):
        schema = dt.Schema([(c, t) for c, (t, _) in cols.items()])
        out[name] = BatchLayout(schema, bucket_rows(max(n_rows, 1)), n_rows,
                                {c: p for c, (_, p) in cols.items()}, {})

    def ints(n, hi=1 << 31):
        return rng.integers(-hi, hi, n).astype(np.int32)

    # RLE runs of length 1 over two and a half tiles, and bit-packed
    # groups of 8 between RLE runs of 1
    n = 2 * T + 1000
    dict8 = ints(8)
    mixed, start, bit = [], 0, 0
    while start < n:
        mixed.append((start, 5 | _META_DICT, 0, bit))
        mixed.append((start + 8, 5 | _META_RLE | _META_DICT,
                      int(rng.integers(0, 8)),
                      0))
        start, bit = start + 9, bit + 40
    layout("rle_runs_of_one", n, {
        "ones": (dt.INT32, _tile_plan(n, np.int32, [
            (i, 3 | _META_RLE | _META_DICT, int(rng.integers(0, 8)), 0)
            for i in range(n)], np.zeros(2, np.uint32), dict8)),
        "mixed": (dt.INT32, _tile_plan(n, np.int32, mixed,
                                       _packed(rng, bit // 32 + 3),
                                       ints(32)))})
    # one RLE run over three tiles, then a 12-bit run across two
    n = 5 * T + 17
    layout("straddling_runs", n, {
        "v": (dt.INT32, _tile_plan(n, np.int32, [
            (0, 12 | _META_RLE | _META_DICT, 4000, 0),
            (2 * T + 5, 12 | _META_DICT, 0, 64),
            (4 * T + 100, 12 | _META_RLE | _META_DICT, 17, 0)],
            _packed(rng, (2 * T * 12 + 64) // 32 + 40), ints(4096)))})
    # one column per width; 64-bit PLAIN starting on an odd word
    n = 3 * T - 3
    cols = {}
    for w in (0, 1, 7, 8, 12):
        cols[f"dict_w{w}"] = (dt.INT32, _tile_plan(
            n, np.int32, [(0, w | _META_DICT, 0, 3)],
            _packed(rng, n * w // 32 + 3), ints(1 << w)))
    for w in (31, 32):
        cols[f"plain_w{w}"] = (dt.INT32, _tile_plan(
            n, np.int32, [(0, w, 0, 32 * (w == 31))],
            _packed(rng, n * w // 32 + 4)))
    cols["bool_w1"] = (dt.BOOL, _tile_plan(n, np.bool_, [(0, 1, 0, 5)],
                                           _packed(rng, n // 32 + 3)))
    cols["plain_w64_odd"] = (dt.INT64, _tile_plan(
        n, np.int64, [(0, 64, 0, 32 * 7)], _packed(rng, 2 * n + 10)))
    cols["plain_f64_odd"] = (dt.FLOAT64, _tile_plan(
        n, np.float64, [(0, 100, 0, 32 * 3), (T + 9, 64, 0, 32 * 2 * T)],
        _packed(rng, 2 * n + 10)))
    cols["lane32_as_int64"] = (dt.INT64, _tile_plan(
        n, np.int32, [(0, 9 | _META_DICT, 0, 0)],
        _packed(rng, n * 9 // 32 + 3),
        ints(512)))
    layout("widths", n, cols)
    # tables of one and two words, read through the reference's clamps
    for n_words in (1, 2):
        n = 300
        layout(f"n_words_{n_words}", n, {
            "v": (dt.INT32, _tile_plan(n, np.int32, [
                (0, 7 | _META_DICT, 0, 3),
                (100, 7 | _META_RLE | _META_DICT, 9, 0),
                (150, 13 | _META_DICT, 0, 40)], _packed(rng, n_words),
                ints(1 << 13))),
            "p": (dt.INT32, _tile_plan(n, np.int32, [(0, 32, 0, 0)],
                                       _packed(rng, n_words)))})
    # nulls: the second tile starts with 700 null rows; an all-null column
    n = 3 * T + 11
    valid = rng.random(n) < 0.7
    valid[T:T + 700] = False
    valid[2 * T - 40:2 * T + 3] = True
    def_runs, def_words = _def_levels(rng, valid)
    nv = int(valid.sum())
    dnull_runs, dnull_words = _def_levels(rng, np.zeros(n, bool))
    layout("nulls", n, {
        "v": (dt.INT32, _tile_plan(
            n, np.int32, [(0, 6 | _META_DICT, 0, 0),
                          (nv // 2, 6 | _META_RLE | _META_DICT,
                                                 33, 0),
                          (nv // 2 + 3, 6 | _META_DICT, 0, 6 * (nv // 2))],
            _packed(rng, nv * 6 // 32 + 3), ints(64), def_runs, def_words,
            nv)),
        "all_null": (dt.INT64, _tile_plan(
            n, np.int64, [(0, 1 | _META_RLE | _META_DICT, 0, 0)],
            np.zeros(2, np.uint32), None, dnull_runs, dnull_words, 0))})
    # DELTA pages (first value, then deltas with negative minima), with
    # nulls; identity runs
    delta_runs, start = [], 0
    for page in range(6):
        delta_runs.append((start, _META_RLE,
                           int(rng.integers(-1 << 40, 1 << 40)),
                           0))
        delta_runs.append((start + 1, 9 | _META_DELTA, -300, 64 * 32 * page))
        delta_runs.append((start + 700, 13 | _META_DELTA, -4096,
                           64 * 32 * page + 32 * 40))
        start += 1500
    layout("delta_identity", n, {
        "d": (dt.INT64, _tile_plan(n, np.int64, delta_runs,
                                   _packed(rng, 64 * 6 + 600), None,
                                   def_runs, def_words, nv, is_delta=True)),
        "ident": (dt.INT32, _tile_plan(n, np.int32, [
            (0, _META_IDENT, 5, 0), (T - 3, _META_IDENT, 1 << 20, 0),
            (T + 2, 4 | _META_DICT, 0, 0)], _packed(rng, n // 8 + 3),
            ints(16)))})
    # row counts at, one below and one above a tile's edge
    for n in (T - 1, T, T + 1):
        layout(f"rows_{n}", n, {"v": (dt.INT32, _tile_plan(
            n, np.int32, [(0, 10 | _META_DICT, 0, 0)],
            _packed(rng, n * 10 // 32 + 3), ints(1024)))})
    # merged row groups: every run its own dictionary base (meta 16+);
    # and a dictionary of 100,000 entries, past the shared-memory budget
    n = 2 * T + 500
    merged, start, bit = [], 0, 0
    for g in range(40):
        merged.append((start, 4 | _META_DICT | (g * 16 << 16), 0, bit))
        start, bit = start + 230, bit + 230 * 4 + 32
    layout("merged_dictionaries", n, {
        "v": (dt.INT32, _tile_plan(n, np.int32, merged,
                                   _packed(rng, bit // 32 + 3),
                                   ints(40 * 16))),
        "big_dict": (dt.INT32, _tile_plan(
            n, np.int32, [(0, 17 | _META_DICT, 0, 0)],
            _packed(rng, n * 17 // 32 + 3), ints(100_000)))})
    return out


def _blob(layout, device) -> torch.Tensor:
    host = np.zeros(layout.total_bytes, np.uint8)
    layout.fill(host[:layout.prefix_bytes])
    return torch.from_numpy(host).to(device)


def _same_or_none(a: Optional[torch.Tensor],
                  b: Optional[torch.Tensor]) -> bool:
    return (a is None and b is None) or (
        a is not None and b is not None and _same_bits(a, b))


def _reads_own_schema(scan) -> bool:
    """Whether the scan reads one file with the file's own schema (q6's
    scans read float64 columns as float32)."""
    import pyarrow.parquet as pq
    from ..columnar.arrow_bridge import engine_schema
    return scan is not None and len(scan.paths) == 1 and engine_schema(
        pq.ParquetFile(scan.paths[0]).schema_arrow) == scan.output_schema


def _equals_file(scan, batches) -> bool:
    """Whether the decoded batches hold, in order, the rows pyarrow
    reads from the scan's file."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    got = pa.Table.from_batches(batches)
    return got.equals(pq.read_table(scan.paths[0]).cast(got.schema))


def check_k5(device) -> List[Dict]:
    """K5 against its plain version on the same blobs, bit for bit, on
    the Parquet batches of ``k5_layouts`` and the hand-made run tables of
    ``k5_tile_layouts``: every column to its capacity, a string column's
    offsets and chars as well as its store indices. Every case read from
    a file is also held to pyarrow's reading of it. Raises on the first
    disagreement."""
    from ..columnar.arrow_bridge import device_to_arrow
    from ..columnar.batch import GpuBatch
    from .parquet_decode import decode_batch, decode_batch_torch
    out = []
    with tempfile.TemporaryDirectory() as d:
        cases = list(k5_layouts(d).items()) \
            + list(decimal_layouts(d).items()) + [
            (name, [(None, lay)]) for name, lay in k5_tile_layouts().items()]
        for case, items in cases:
            scan = items[0][0]
            batches = [] if _reads_own_schema(scan) else None
            for _, layout in items:
                blob = _blob(layout, device)
                plain = blob.clone()
                got = decode_batch(blob, layout)
                decode_batch_torch(plain, layout)
                want = layout.columns(plain)
                same = all(_same_or_none(a.data, b.data) for a, b in
                           zip(got, want))
                same_v = all(_same_or_none(a.validity, b.validity)
                             for a, b in zip(got, want))
                same_s = all(_same_or_none(a.offsets, b.offsets)
                             and _same_or_none(a.chars, b.chars)
                             for a, b in zip(got, want))
                rec = {"case": case, "rows": layout.n_rows,
                       "columns": len(layout.device_names),
                       "string_columns": sum(c.is_string_like
                                             for c in got),
                       "scan_jobs": len(layout.jobs),
                       "data_equal": same, "validity_equal": same_v,
                       "strings_equal": same_s,
                       "max_abs_err": _max_abs_diff(
                           [(a.data, b.data) for a, b in zip(got, want)
                            if a.data is not None
                            and a.data.dtype != torch.bool])}
                if not (same and same_v and same_s):
                    raise AssertionError(f"K5 disagrees: {rec}")
                out.append(rec)
                if batches is not None:
                    batches.append(device_to_arrow(
                        GpuBatch(got, layout.schema, layout.n_rows)))
            if batches is not None:
                out[-1]["pyarrow_equal"] = _equals_file(scan, batches)
                if not out[-1]["pyarrow_equal"]:
                    raise AssertionError(
                        f"K5's {case} batches differ from pyarrow's "
                        f"reading of the file: {out[-1]}")
    return out


def time_k5(device, reps: int = 50) -> Dict[str, float]:
    """Device ms of K5 and its plain version at a q6 batch (the four q6
    columns of 750,152 rows), over blobs that cycle past L2, with the
    bytes K5 must move: the encoded parts in, and every column out up to
    the capacity (padding rows hold 0)."""
    from .parquet_decode import decode_batch, decode_batch_torch
    with tempfile.TemporaryDirectory() as d:
        (scan, layout), = k5_layouts(d)["q6_batch"]
    nbytes = layout.encoded_bytes() + layout.written_bytes()
    blobs = [_blob(layout, device)
             for _ in range(_copies_for(layout.total_bytes))]
    ms, plain_ms = _turns(lambda b: decode_batch_torch(b, layout),
                          lambda b: decode_batch(b, layout), blobs, reps, 5)
    return {"ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
            "rows": layout.n_rows, "capacity": layout.capacity,
            "columns": len(layout.device_names),
            "encoded_bytes": layout.encoded_bytes(),
            "written_bytes": layout.written_bytes()}


@dataclasses.dataclass
class K2Case:
    """K1's inputs plus a key: the engine edition's ``(base, groups)``
    and the contract edition's int32 key in 0..7 (``None``: not run)."""
    k1: K1Case
    key: torch.Tensor
    key_valid: Optional[torch.Tensor]
    base: int
    groups: int
    contract_key: Optional[torch.Tensor]

    def bytes_read(self) -> int:
        return self.k1.bytes_read() + self.k1.row_count * (
            self.key.element_size()
            + (0 if self.key_valid is None else 1))


def k2_cases(device, seed: int = 8) -> List[K2Case]:
    from ..tpch import _linenumbers
    rng = np.random.default_rng(seed)
    dev = torch.device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    main, ragged, nulls = k1_base_cases(device, seed)
    n = MAIN_CAPACITY
    line = _linenumbers(n, seed)
    ragged_key = rng.integers(0, 8, ragged.cols[0].shape[0]).astype(np.int32)
    null_key = rng.integers(-2, 10, n)  # some outside [0, 8)
    every = rng.integers(0, 8, n).astype(np.int32)

    def shifted(case, name, shift_bytes):
        """The case's columns and masks copied to ``shift_bytes`` past a
        16-byte boundary, which sends the kernel to its scalar loop."""
        return dataclasses.replace(
            case, name=name, cols=[_offset(c, shift_bytes) for c in case.cols],
            valids=[None if v is None else _offset(v, shift_bytes)
                    for v in case.valids],
            selection=None if case.selection is None
            else _offset(case.selection, shift_bytes))

    # eight rows, most of which pass q6's leaves (rows 2 and 6 fail)
    eight = [t(np.array(v, dt)) for v, dt in (
        ([10, 20, 5, 23, 1, 30, 2, 3], np.float32),
        ([1000, 2500.5, 333, 4096, 7, 1.25, 900, 12], np.float32),
        ([0.06, 0.05, 0.08, 0.07, 0.06, 0.05, 0.06, 0.07], np.float32),
        ([9000, 8766, 9100, 9130, 8800, 9000, 9131, 8999], np.int32))]

    def short(rows):
        return dataclasses.replace(main, name=f"rows_{rows}", cols=eight,
                                   row_count=rows)

    line64 = line.astype(np.int64)
    return [
        K2Case(dataclasses.replace(main, name="q6_batch_linenumber"),
               t(line), None, 1, 7, t(line - 1)),
        K2Case(dataclasses.replace(ragged, name="ragged"), t(ragged_key),
               None, 0, 8, t(ragged_key)),
        K2Case(dataclasses.replace(nulls, name="nulls_nan_outside"),
               t(null_key), t(rng.random(n) > 0.03), 0, 8, None),
        K2Case(dataclasses.replace(main, name="one_group"),
               t(np.full(n, 5, np.int64)), None, 5, 1,
               t(np.full(n, 5, np.int32))),
        K2Case(dataclasses.replace(main, name="every_group"), t(every),
               None, 0, 8, t(every)),
        K2Case(shifted(main, "columns_key_at_4B", 4),
               _offset(t(line), 4), None, 1, 7, _offset(t(line - 1), 4)),
        K2Case(dataclasses.replace(main, name="int64_key"), t(line64),
               None, 1, 7, None),
        K2Case(dataclasses.replace(main, name="int64_key_at_8B"),
               _offset(t(line64), 8), None, 1, 7, None),
        K2Case(shifted(nulls, "masks_at_1B", 1), _offset(t(null_key), 1),
               _offset(t(rng.random(n) > 0.03), 1), 0, 8, None),
    ] + [K2Case(short(r), t(np.arange(8, dtype=np.int32) % 3), None, 0,
                8, t(np.arange(8, dtype=np.int32) % 3)) for r in (1, 3, 5)]


def _offset(x: torch.Tensor, shift_bytes: int) -> torch.Tensor:
    """A copy of ``x`` that starts ``shift_bytes // element size``
    elements into a fresh buffer: its data lies that many whole elements
    past a 16-byte boundary (a 1-byte shift moves only 1-byte masks)."""
    k = shift_bytes // x.element_size()
    buf = torch.empty(x.shape[0] + k, dtype=x.dtype, device=x.device)
    buf[k:].copy_(x)
    return buf[k:]


def _k2_engine(c: K2Case, plain: bool = False):
    fn = ck.filter_product_group_sum_torch if plain \
        else ck.filter_product_group_sum
    k1 = c.k1
    return fn(k1.cols, k1.valids, k1.selection, k1.row_count, k1.spec,
              c.key, c.key_valid, c.base, c.groups)


def _group_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.double().cpu(), want.double().cpu()
    return ((g - w).abs() / w.abs().clamp(min=1.0)).max().item()


def check_k2(device) -> List[Dict]:
    """Both editions of K2 against their plain versions; raises on the
    first disagreement."""
    out = []
    for c in k2_cases(device):
        s, nn, rows, oor = _k2_engine(c)
        ps, pnn, prows, poor = _k2_engine(c, plain=True)
        rec = {"case": c.k1.name, "edition": "engine",
               "rows": c.k1.row_count, "groups": c.groups,
               "rel_err": _group_rel(s, ps),
               "max_abs_err": (s - ps).abs().max().item(),
               "counts_equal": torch.equal(nn, pnn)
               and torch.equal(rows, prows),
               "outside": oor.item(), "plain_outside": poor.item()}
        if not (rec["counts_equal"] and rec["outside"]
                == rec["plain_outside"] and rec["rel_err"] <= ENGINE_RTOL):
            raise AssertionError(f"K2 engine edition disagrees: {rec}")
        out.append(rec)
        if c.contract_key is None:
            continue
        cols = [x[:c.k1.row_count].contiguous() for x in c.k1.cols]
        key = c.contract_key[:c.k1.row_count].contiguous()
        got = ck.fused_filter_agg(key, *cols)
        want = ck.fused_filter_agg_torch(key, *cols)
        rec = {"case": c.k1.name, "edition": "contract",
               "rows": c.k1.row_count, "groups": ck.FUSED_AGG_GROUPS,
               "rel_err": _group_rel(got, want),
               "max_abs_err": (got - want).abs().max().item()}
        if not rec["rel_err"] <= CONTRACT_RTOL:
            raise AssertionError(f"K2 contract edition disagrees: {rec}")
        out.append(rec)
    return out + _k2_repeats(device)


def _same_outputs(a, b) -> bool:
    return all(_same_bits(x.reshape(-1), y.reshape(-1))
               for x, y in zip(a, b))


def _k2_repeats(device) -> List[Dict]:
    """Two launches on one input give the same bits; and launches on two
    streams at once (each stream its own ticket counter) give each
    stream's input the bits that one stream alone gives it."""
    cases = k2_cases(device)
    main, nulls = cases[0], cases[2]
    first, second, pairs = _stream_repeats(_k2_engine, main, nulls, device)
    out = [{"case": "two_launches", "edition": "engine",
            "rows": main.k1.row_count, "groups": main.groups,
            "rel_err": 0.0 if _same_outputs(first, second) else float("inf"),
            "max_abs_err": (first[0] - second[0]).abs().max().item(),
            "counts_equal": _same_outputs(first[1:], second[1:]),
            "outside": first[3].item(), "plain_outside": second[3].item()}]
    same = all(_same_outputs(g, w) for w, gs in pairs for g in gs)
    out.append({"case": "two_streams", "edition": "engine",
                "rows": main.k1.row_count + nulls.k1.row_count,
                "groups": main.groups, "rel_err": 0.0 if same
                else float("inf"),
                "max_abs_err": max((g[0] - w[0]).abs().max().item()
                                   for w, gs in pairs for g in gs),
                "counts_equal": same, "outside": 0, "plain_outside": 0})
    for rec in out:
        if not rec["counts_equal"] or rec["rel_err"] != 0.0:
            raise AssertionError(f"K2 gives other bits on another run: "
                                 f"{rec}")
    return out


def time_k2(device, reps: int = 100) -> Dict[str, float]:
    """Device ms of K2's engine edition and its plain version at a q6
    batch grouped by line number (1..7), over inputs that cycle past L2,
    with the bytes it must read."""
    c = k2_cases(device)[0]
    copies = [dataclasses.replace(c, k1=k, key=c.key.clone())
              for k in _copies_past_l2(c.k1)]
    ms, plain_ms = _turns(lambda x: _k2_engine(x, plain=True), _k2_engine,
                          copies, reps, reps)
    out_bytes = (c.groups + 1) * 24 + 8
    return {"ms": ms, "plain_ms": plain_ms,
            "bytes": c.bytes_read() + out_bytes, "rows": c.k1.row_count,
            "ops": c.k1.row_count * (len(c.k1.spec.leaves) + 3)}


# --- K6 ---------------------------------------------------------------------

# the generated text's pieces and their weights out of 256: ASCII words,
# digits, spaces and newlines, and 2-, 3- and 4-byte UTF-8 characters
_K6_TOKENS = ([bytes([c]) for c in b"abcdefghijklmnopqrstuvwxyz"]
              + [bytes([c]) for c in b"0123456789"]
              + [b" ", b"\n", "é".encode(), "日".encode(), "𝄞".encode()])
_K6_WEIGHTS = [7] * 26 + [2] * 10 + [32, 8, 8, 4, 2]  # sum 256
K6_LIKE = "%ab%c_d%"          # 44 positions: % and _ are 10 each
K6_RLIKE = "xy|b[aeiou]+z|\\d\\d\\s\\w"
# 17 positions whose DFA passes regex.DFA_MAX_ENTRIES (an 'a' in each of
# the last 16 bytes gives about 2^16 states): route B
K6_BLOWUP = "a" + "[a-z ]" * 16
K6_TEXT_ROWS = 1 << 20
_NDS_CATEGORIES = ["Electronics", "Home", "Sports", "Books", "Music",
                   "Jewelry"]  # nds.gen_tables' i_category


def _k6_text(rng, n: int, lo: int = 20, hi: int = 120):
    """``n`` rows of generated UTF-8 text of ``lo`` to about ``hi``
    bytes (cut at character ends): ``(offsets int64, chars uint8)``."""
    table = np.repeat(np.arange(len(_K6_TOKENS)), _K6_WEIGHTS)
    lens = np.array([len(t) for t in _K6_TOKENS])
    pieces = np.zeros((len(_K6_TOKENS), 4), np.uint8)
    for i, t in enumerate(_K6_TOKENS):
        pieces[i, :len(t)] = list(t)
    want = int(n * (lo + hi) / 2 * 1.05) + hi
    ids = table[rng.integers(0, 256, want, dtype=np.uint8)]
    tl = lens[ids]
    chars = pieces[ids][np.arange(4)[None, :] < tl[:, None]]
    ends = np.cumsum(tl)
    targets = np.cumsum(rng.integers(lo, hi + 1, n))
    cut = np.searchsorted(ends, targets[targets <= ends[-1]])
    offsets = np.concatenate([[0], ends[cut]])
    return offsets, chars[:offsets[-1]]


def k6_cases(device, seed: int = 9, text_rows: int = K6_TEXT_ROWS) \
        -> List[Dict]:
    """K6's inputs: ``{"name", "starts", "lengths", "validity", "chars",
    "pattern", "prog"}``. q_like's own shape (32,768 ``i_category``
    strings under ``'%o%s%'``, 32 positions); ``text_rows`` rows of text
    of 20-120 bytes with multi-byte characters and newlines, 5% null,
    under the LIKE pattern ``K6_LIKE``, the RLIKE alternation
    ``K6_RLIKE`` and the RLIKE ``K6_BLOWUP``, whose DFA does not fit
    (route B); and the edges: the empty string, a null row, rows
    whose start lies inside an inherited chars buffer (overlapping,
    out of order), an empty chars buffer, and patterns that match
    always or only the empty string; and non-ASCII literal shapes
    (``literal_bytes``): q_fn_match's ``'%sé'`` over the categories with
    ``é`` appended, and contains, prefix and two-character literals on
    the edges."""
    from . import regex
    rng = np.random.default_rng(seed)
    dev = torch.device(device)

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(dev)

    def case(name, starts, lengths, validity, chars, pattern, like,
             literal=False):
        rx = regex.like_to_regex(pattern, "\\", literal) if like \
            else pattern
        return {"name": name, "starts": t(starts, np.int32),
                "lengths": t(lengths, np.int32),
                "validity": None if validity is None
                else t(validity, np.bool_),
                "chars": t(chars, np.uint8), "pattern": pattern,
                "prog": regex.compile_pattern(rx, literal_bytes=literal)}

    words = [w.encode() for w in rng.choice(_NDS_CATEGORIES, NDS_ITEM_ROWS)]
    off = np.concatenate([[0], np.cumsum([len(w) for w in words])])
    out = [case("q_like_item_32768", off[:-1], np.diff(off), None,
                np.frombuffer(b"".join(words), np.uint8), "%o%s%", True)]
    # q_fn_match's non-ASCII literal shape: LIKE '%sé' over the
    # categories with 'é' appended (the literal's UTF-8 bytes on K6)
    intl = [w + "é".encode() for w in words]
    off = np.concatenate([[0], np.cumsum([len(w) for w in intl])])
    out.append(case("q_fn_match_item_intl_32768", off[:-1], np.diff(off),
                    None, np.frombuffer(b"".join(intl), np.uint8), "%sé",
                    True, literal=True))
    off, chars = _k6_text(rng, text_rows)
    valid = rng.random(len(off) - 1) >= 0.05
    out += [case(f"text_{kind}_2^{text_rows.bit_length() - 1}", off[:-1],
                 np.diff(off), valid, chars, pattern, kind == "like")
            for kind, pattern in (("like", K6_LIKE), ("rlike", K6_RLIKE),
                                  ("blowup", K6_BLOWUP))]
    buf = np.frombuffer("xxos\nabcxxd zo sé日 ab c\nd".encode(), np.uint8)
    m = len(buf)
    starts = [0, 2, 5, 3, 0, m, 9, 1, 12, 4]
    lengths = [0, 5, 9, 4, m, 0, 8, 1, m - 12, 3]
    valid = [True, True, True, False, True, True, True, True, True, True]
    for pat, like in (("%o%s%", True), (K6_LIKE, True), ("%", True),
                      ("_", True), ("^$", False), ("a*", False),
                      ("s$", False)):
        out.append(case(f"edges_{pat!r}", starts, lengths, valid, buf,
                        pat, like))
    for pat in ("%é%", "sé%", "%é日%"):
        out.append(case(f"edges_{pat!r}", starts, lengths, valid, buf, pat,
                        True, literal=True))
    out.append(case("edges_no_chars", [0, 0, 0], [0, 0, 0],
                    [True, False, True], np.zeros(0, np.uint8), "^$",
                    False))
    return out


def k6_literal_cases(device, seed: int = 10,
                     text_rows: int = K6_TEXT_ROWS) -> List[Dict]:
    """K6's long literals (``regex.compile_literal`` past 64 positions,
    route A only), in ``k6_cases``' form: ``text_rows`` rows of
    ``_k6_text``, half of them carrying a 116-byte literal with
    non-ASCII bytes and borders at their start, their end or inside,
    under the prefix, suffix and contains shapes."""
    from . import regex
    rng = np.random.default_rng(seed)
    lit = "abab" * 10 + "日本é" * 5 + "abab" * 8 + "abac"
    raw = lit.encode()
    off, chars = _k6_text(rng, text_rows)
    rows = [bytes(chars[a:b]) for a, b in zip(off[:-1], off[1:])]
    where = rng.integers(0, 6, len(rows))
    rows = [raw + r if w == 0 else r + raw if w == 1
            else r[:len(r) // 2] + raw[:-1] + raw + r[len(r) // 2:]
            if w == 2 else r for r, w in zip(rows, where)]
    off = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    buf = np.frombuffer(b"".join(rows), np.uint8)
    valid = rng.random(len(rows)) >= 0.05
    dev = torch.device(device)
    return [{"name": f"text_literal_{kind}_{len(raw)}B_2^"
                     f"{text_rows.bit_length() - 1}",
             "starts": torch.from_numpy(off[:-1].astype(np.int32)).to(dev),
             "lengths": torch.from_numpy(np.diff(off).astype(np.int32))
             .to(dev),
             "validity": torch.from_numpy(valid).to(dev),
             "chars": torch.from_numpy(buf.copy()).to(dev),
             "pattern": f"{kind}({len(raw)} B)",
             "prog": regex.compile_literal(lit, kind)}
            for kind in ("prefix", "suffix", "contains")]


def _k6_routes(prog) -> List[str]:
    """Every route K6 can run ``prog`` on: the DFA where it fits, and
    position sets where the program has at most 64 positions."""
    from . import regex
    return (["dfa"] if regex.program_tables(prog)[0] == "dfa" else []) \
        + (["positions"] if prog.n_states <= regex.MAX_STATES else [])


def check_k6(device, cases: Optional[List[Dict]] = None) -> List[Dict]:
    """K6 against its plain version on every ``k6_cases`` input (or
    ``cases``), bit for bit, on the program's route and through every
    other route that can take the case (``_k6_routes``), and q_like's
    case against Python's ``re``; raises on the first disagreement."""
    import re
    from . import regex
    out = []
    for c in cases if cases is not None else k6_cases(device):
        args = (c["starts"], c["lengths"], c["validity"], c["chars"],
                c["prog"])
        want = regex.regex_match_torch(*args)
        got = regex.regex_match(*args)
        by_route = {r: _same_bits(regex.regex_match(*args, route=r), want)
                    for r in _k6_routes(c["prog"])}
        rec = {"case": c["name"], "n": c["starts"].shape[0],
               "positions": c["prog"].n_states,
               "route": regex.program_tables(c["prog"])[0],
               "matches": int(want.sum()),
               "equal": _same_bits(got, want) and all(by_route.values()),
               "equal_by_route": by_route,
               "max_abs_err": _max_abs_diff([(got.to(torch.int64),
                                              want.to(torch.int64))])}
        if c["name"].startswith("q_like"):
            host = bytes(c["chars"].cpu().numpy())
            rx = re.compile(b"(?s).*o.*s.*")
            s, n = c["starts"].cpu().numpy(), c["lengths"].cpu().numpy()
            py = torch.tensor([rx.fullmatch(host[a:a + b]) is not None
                               for a, b in zip(s, n)])
            rec["equal_re"] = bool(torch.equal(got.cpu(), py))
            rec["equal"] &= rec["equal_re"]
        if not rec["equal"]:
            raise AssertionError(f"K6 disagrees: {rec}")
        out.append(rec)
    return out


def time_k6(device, cases: Optional[List[Dict]] = None,
            reps: int = 20) -> Dict[str, Dict[str, float]]:
    """Device ms of K6 (on the program's route) and its plain version at
    q_like's shape and on the text cases, over copies of the inputs
    larger than L2, in turns (plain, kernel, kernel, plain), and of every
    way K6 can run the case (``ms_by_route``, ``_k6_routes``), with the
    bytes the kernel must move: each row's chars up to where it stops
    (``regex.regex_bytes_read``), its 4 B start and 4 B length, its
    validity byte where there is one, its 1 B result, and the route's
    tables."""
    from . import regex
    out = {}
    for c in cases if cases is not None else k6_cases(device):
        if c["name"].startswith("edges"):
            continue
        prog = c["prog"]
        n = c["starts"].shape[0]
        args = (c["starts"], c["lengths"], c["validity"], c["chars"])
        chars = regex.regex_bytes_read(*args, prog)
        route, tables = regex.program_tables(prog)
        nbytes = chars + n * (9 + (c["validity"] is not None)) \
            + len(regex._table_bytes(route, tables))

        def fresh():
            return tuple(None if a is None else a.clone() for a in args)
        copies = _cycle(fresh, _copies_for(nbytes))
        ms, plain_ms = _turns(
            lambda a: regex.regex_match_torch(*a, prog),
            lambda a: regex.regex_match(*a, prog), copies, reps, 2)
        by_route = {r: min(_time_ms(
            lambda a: regex.regex_match(*a, prog, route=r), copies, reps)
            for _ in range(2)) for r in _k6_routes(prog)}
        out[c["name"]] = {"ms": ms, "plain_ms": plain_ms,
                          "library_ms": None, "bytes": nbytes, "rows": n,
                          "chars_read": chars, "route": route,
                          "ms_by_route": by_route,
                          "positions": prog.n_states,
                          "dfa_states": tables.n_states
                          if route == "dfa" else None,
                          "pattern": c["pattern"]}
    return out


# --- K7: xxhash64 over strings ------------------------------------------------

K7_ROWS = 1 << 20
K7_ORACLE_ROWS = 1 << 16  # the rows also held to the numpy host copy


def _string_parts(rng, n: int, lo: int, hi: int):
    """``n`` random byte strings of ``lo`` to ``hi`` bytes: ``(offsets
    int32, chars uint8)``."""
    lens = rng.integers(lo, hi + 1, n)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return offsets, rng.integers(0, 256, int(offsets[-1]), dtype=np.uint8)


def k7_cases(device, seed: int = 19, rows: int = K7_ROWS) -> List[Dict]:
    """K7's inputs: ``{"name", "offsets", "chars", "validity", "fixed"}``,
    ``fixed`` the columns hashed before the strings (their running hash
    is the string step's seed). ``rows`` strings of 0-100 bytes (under
    and over the 32-byte stripe), 5% null, after an int, a long, a
    double (with -0.0 and NaN) and a ``decimal(12,2)`` column, each with
    nulls; and the edges: lengths 0-70 around the stripe and the 8- and
    4-byte tails, rows inside an inherited buffer (the first offset past
    0) at every alignment, every row null, and an empty buffer."""
    from .. import datatypes as dt
    from ..columnar.column import GpuColumnVector
    rng = np.random.default_rng(seed)
    dev = torch.device(device)

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    def fixed(n):
        d = rng.normal(size=n)
        d[rng.random(n) < 0.01] = -0.0
        d[rng.random(n) < 0.01] = np.nan
        cols = [(dt.INT32, rng.integers(-2**31, 2**31, n, dtype=np.int64)
                 .astype(np.int32)),
                (dt.INT64, rng.integers(-2**63, 2**63 - 1, n,
                                        dtype=np.int64)),
                (dt.FLOAT64, d),
                (dt.DecimalType(12, 2), rng.integers(-10**12 + 1, 10**12,
                                                     n, dtype=np.int64))]
        return [GpuColumnVector(ty, t(v), t(rng.random(n) >= 0.05))
                for ty, v in cols]

    off, chars = _string_parts(rng, rows, 0, 100)
    out = [{"name": f"strings_0_100B_2^{rows.bit_length() - 1}",
            "offsets": t(off), "chars": t(chars),
            "validity": t(rng.random(rows) >= 0.05), "fixed": fixed(rows)}]
    lens = np.tile(np.arange(71), 9)
    for shift in range(9):
        offs = shift + np.concatenate([[0], np.cumsum(lens)])
        buf = rng.integers(0, 256, int(offs[-1]) + 5, dtype=np.uint8)
        out.append({"name": f"edges_lengths_0_70_from_{shift}",
                    "offsets": t(offs, np.int32), "chars": t(buf),
                    "validity": None, "fixed": fixed(len(lens))})
    off, chars = _string_parts(rng, 100, 0, 40)
    out.append({"name": "edges_all_null", "offsets": t(off),
                "chars": t(chars), "validity": t(np.zeros(100, np.bool_)),
                "fixed": fixed(100)})
    out.append({"name": "edges_no_chars", "offsets": t(np.zeros(4,
                                                                np.int32)),
                "chars": t(np.zeros(0, np.uint8)),
                "validity": t([True, False, True], np.bool_),
                "fixed": fixed(3)})
    return out


def _k7_seed(case) -> torch.Tensor:
    from .hash import XXSEED, xxhash64_column
    n = case["offsets"].shape[0] - 1
    h = torch.full((n,), XXSEED, dtype=torch.int64,
                   device=case["offsets"].device)
    for c in case["fixed"]:
        h = xxhash64_column(c, h)
    return h


def _k7_host(case, rows: int) -> np.ndarray:
    """The numpy host copy (``hash.xxhash64_columns_numpy``) of the
    case's first ``rows`` rows: its columns, then the strings."""
    from .. import datatypes as dt
    from ..expr.base import column_to_arrow
    from ..columnar.column import GpuColumnVector
    from .hash import xxhash64_columns_numpy
    col = GpuColumnVector(dt.BINARY, None, case["validity"],
                          case["offsets"], case["chars"])
    cols = case["fixed"] + [col]
    arrays = [column_to_arrow(c, c.capacity).slice(0, rows) for c in cols]
    return xxhash64_columns_numpy(arrays, [c.dtype for c in cols], rows)


def check_k7(device, cases: Optional[List[Dict]] = None) -> List[Dict]:
    """K7 against its plain version on every ``k7_cases`` input, bit for
    bit, each chained after its fixed columns, and the chain's first
    ``K7_ORACLE_ROWS`` rows (every row of an edge case) against the
    numpy host copy; raises on the first disagreement."""
    from .hash import xxhash64_strings, xxhash64_strings_torch
    out = []
    for c in cases if cases is not None else k7_cases(device):
        seed = _k7_seed(c)
        args = (c["offsets"], c["chars"], seed, c["validity"])
        want = xxhash64_strings_torch(*args)
        got = xxhash64_strings(*args)
        rows = min(K7_ORACLE_ROWS, got.shape[0])
        host = torch.from_numpy(_k7_host(c, rows))
        rec = {"case": c["name"], "n": got.shape[0],
               "equal": _same_bits(got, want),
               "equal_host": _same_bits(got[:rows].cpu(), host),
               "host_rows": rows,
               "max_abs_err": _max_abs_diff([(got, want),
                                             (got[:rows].cpu(), host)])}
        rec["equal"] &= rec["equal_host"]
        if not rec["equal"]:
            raise AssertionError(f"K7 disagrees: {rec}")
        out.append(rec)
    return out


def time_k7(device, case: Optional[Dict] = None,
            reps: int = 50) -> Dict[str, float]:
    """Device ms of K7 and its plain version on the main case, over
    copies of the inputs larger than L2, in turns, with the bytes a call
    must move: the offsets (4 B a row and one more), each row's bytes,
    the 8 B seed in, the validity byte and the 8 B hash out."""
    from .hash import xxhash64_strings, xxhash64_strings_torch
    c = case if case is not None else k7_cases(device)[0]
    n = c["offsets"].shape[0] - 1
    seed = _k7_seed(c)
    nbytes = 4 * (n + 1) + int(c["offsets"][-1] - c["offsets"][0]) \
        + n * (8 + 8 + (c["validity"] is not None))
    args = (c["offsets"], c["chars"], seed, c["validity"])

    def fresh():
        return tuple(None if a is None else a.clone() for a in args)
    copies = _cycle(fresh, _copies_for(nbytes))
    ms, plain_ms = _turns(lambda a: xxhash64_strings_torch(*a),
                          lambda a: xxhash64_strings(*a), copies, reps, 3)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bytes": nbytes, "rows": n, "case": c["name"]}


# --- K8: the regex span finder ------------------------------------------------

K8_TEXT_ROWS = 1 << 20
#: a class run, a bounded repeat, one of 60 positions, one that matches
#: at a row's last byte (an end anchor)
K8_PATTERNS = ("[aeiou]+", "\\d\\d?\\d?", "[a-z ]" * 60, "[a-z]+$")


def k8_cases(device, seed: int = 20,
             text_rows: int = K8_TEXT_ROWS) -> List[Dict]:
    """K8's inputs: ``{"name", "offsets", "chars", "validity", "pattern",
    "prog"}``: ``text_rows`` rows of ``_k6_text`` (20-120 bytes with
    multi-byte characters and newlines, 5% null) under each of
    ``K8_PATTERNS``; and the edges: empty rows between others and at the
    buffer's end (a row starting at the chars' capacity), a null row
    with bytes, rows inside an inherited buffer, an empty buffer, and an
    anchored pattern."""
    from . import regex
    rng = np.random.default_rng(seed)
    dev = torch.device(device)

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(dev)

    def case(name, offsets, validity, chars, pattern):
        prog, why = regex.compile_replace_pattern(pattern)
        if prog is None:
            raise ValueError(f"{pattern!r}: {why}")
        return {"name": name, "offsets": t(offsets, np.int32),
                "validity": None if validity is None
                else t(validity, np.bool_), "chars": t(chars, np.uint8),
                "pattern": pattern, "prog": prog}

    off, chars = _k6_text(rng, text_rows)
    valid = rng.random(len(off) - 1) >= 0.05
    out = [case(f"text_{i}_2^{text_rows.bit_length() - 1}", off, valid,
                chars, p) for i, p in enumerate(K8_PATTERNS)]
    buf = np.frombuffer("aeixo 12 zoo\nuu 345 é日 ab ba".encode(),
                        np.uint8)
    m = len(buf)
    offs = [2, 2, 7, 13, 13, 20, m - 4, m, m]
    valid = [True, True, False, True, True, True, True, True]
    for p in ("[aeiou]+", "\\d\\d?\\d?", "[a-z]+$", "^[ax]+", "o"):
        out.append(case(f"edges_{p!r}", offs, valid, buf, p))
    out.append(case("edges_no_chars", [0, 0, 0], [True, False],
                    np.zeros(0, np.uint8), "[aeiou]+"))
    return out


def _k8_same(got, want) -> bool:
    return all(_same_bits(a, b) for a, b in zip(got, want))


def check_k8(device, cases: Optional[List[Dict]] = None) -> List[Dict]:
    """K8 against its plain version on every ``k8_cases`` input, with
    ``first_only`` off and on, all five outputs bit for bit; raises on
    the first disagreement."""
    from . import regex
    out = []
    for c in cases if cases is not None else k8_cases(device):
        args = (c["offsets"], c["chars"], c["validity"], c["prog"])
        for first_only in (False, True):
            want = regex.find_spans_torch(*args, first_only)
            got = regex.find_spans(*args, first_only)
            rec = {"case": c["name"], "first_only": first_only,
                   "n": c["offsets"].shape[0] - 1,
                   "positions": c["prog"].n_states,
                   "spans": int(want[2].sum()),
                   "equal": _k8_same(got, want),
                   "max_abs_err": _max_abs_diff([
                       (g.to(torch.int64), w.to(torch.int64))
                       for g, w in zip(got, want)])}
            if not rec["equal"]:
                raise AssertionError(f"K8 disagrees: {rec}")
            out.append(rec)
    return out


def time_k8(device, cases: Optional[List[Dict]] = None,
            reps: int = 20) -> Dict[str, Dict[str, float]]:
    """Device ms of K8 and its plain version on each text case (not the
    edges), ``first_only`` off, over copies of the inputs larger than
    L2, in turns, with the bytes the function must move: the offsets,
    each row's bytes once (a row of 20-120 B fits on chip, so a design
    may read it once, though this kernel's two phases read it twice),
    both byte lanes written, the validity byte and 12 B a row out."""
    from . import regex
    out = {}
    for c in cases if cases is not None else k8_cases(device):
        if c["name"].startswith("edges"):
            continue
        n = c["offsets"].shape[0] - 1
        live = int(c["offsets"][-1] - c["offsets"][0])
        nbytes = 4 * (n + 1) + live + 2 * c["chars"].shape[0] \
            + n * (12 + (c["validity"] is not None))
        args = (c["offsets"], c["chars"], c["validity"])
        prog = c["prog"]

        def fresh():
            return tuple(None if a is None else a.clone() for a in args)
        copies = _cycle(fresh, _copies_for(nbytes))
        ms, plain_ms = _turns(lambda a: regex.find_spans_torch(*a, prog),
                              lambda a: regex.find_spans(*a, prog),
                              copies, reps, 1)
        out[c["name"]] = {"ms": ms, "plain_ms": plain_ms,
                          "library_ms": None, "bytes": nbytes, "rows": n,
                          "positions": prog.n_states,
                          "pattern": c["pattern"]}
    return out
