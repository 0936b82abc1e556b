"""K5's tile walk on the CPU, against the plain version and the JAX package.

``decode_tiles_torch`` runs the decode kernel's decomposition in plain
torch: tiles of 4096 rows, padding tiles, one 256-way search of the run
table a tile, windows of at most 128 run records, and the staged span of
packed words each window covers, read through its offsets (a read outside
the span raises). On hand-made run tables that walk the tiles at their
edges (``kernel_checks.k5_tile_layouts``) it must give
``decode_batch_torch``'s blob and the JAX ``_decode_device``'s columns bit
for bit, and on Parquet batches ``decode_batch_torch``'s. On the card,
``kernel_checks.check_k5`` runs the kernel itself on the same layouts.
Everything here is exact: no tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.io import parquet_device as jpd
from spark_rapids_tpu_torch import tpch
from spark_rapids_tpu_torch.columnar.arrow_bridge import engine_schema
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.io.scan import GpuFileScanExec
from spark_rapids_tpu_torch.ops import kernel_checks as kc
from spark_rapids_tpu_torch.ops import parquet_decode as tpd

CASES = ["rle_runs_of_one", "straddling_runs", "widths", "n_words_1",
         "n_words_2", "nulls", "delta_identity", "rows_4095", "rows_4096",
         "rows_4097", "merged_dictionaries"]


@pytest.fixture(scope="module")
def layouts():
    return kc.k5_tile_layouts()


def _decoded(layout):
    """(the plain version's blob, the tile walk's blob, the walk's
    counts)."""
    want = kc._blob(layout, "cpu")
    got = want.clone()
    tpd.decode_batch_torch(want, layout)
    stats = tpd.decode_tiles_torch(got, layout)
    return want, got, stats


def test_the_cases_are_the_layouts(layouts):
    assert sorted(layouts) == sorted(CASES)


@pytest.mark.parametrize("case", CASES)
def test_tile_walk_matches_plain_version(layouts, case):
    layout = layouts[case]
    want, got, stats = _decoded(layout)
    assert torch.equal(got, want), case
    tiles = -(-layout.capacity // tpd.TILE_ROWS)
    assert stats["tiles"] == tiles * len(layout.device_names)


@pytest.mark.parametrize("case", CASES)
def test_tile_walk_matches_reference(layouts, case):
    layout = layouts[case]
    blob = kc._blob(layout, "cpu")
    tpd.decode_tiles_torch(blob, layout)
    cap = layout.capacity
    for name, col in zip(layout.schema.names, layout.columns(blob)):
        plan = layout.plans[name]
        if plan.lane == np.bool_:
            jdict = jnp.zeros(1, jnp.bool_)
        else:
            jdict = jnp.asarray(plan.dictionary if plan.dictionary.shape[0]
                                else np.zeros(1, plan.lane))
        jv, jvalid = jpd._decode_device(
            jnp.asarray(plan.packed), jnp.asarray(plan.runs), jdict,
            jnp.asarray(plan.def_packed), jnp.asarray(plan.def_runs),
            plan.n_rows, cap, delta=plan.is_delta)
        got = col.data.numpy()
        want = np.asarray(jv).astype(got.dtype)
        assert np.array_equal(want.view(np.uint8), got.view(np.uint8)), \
            (case, name)
        valid = np.arange(cap) < plan.n_rows if col.validity is None \
            else col.validity.numpy()
        assert np.array_equal(np.asarray(jvalid), valid), (case, name)


def test_walk_reaches_its_branches(layouts):
    """Windows after the first, padding tiles, word spans staged and
    past the staging budget, both forms of a run, and the scan jobs'
    tiles."""
    ones = _decoded(layouts["rle_runs_of_one"])[2]
    assert ones["padding_tiles"] == 2
    assert ones["windows"] > 4 * ones["searches"]
    widths = _decoded(layouts["widths"])[2]
    assert widths["staged"] and widths["unstaged"]
    # the 32-bit form, and the 64-bit one (64-bit PLAIN, wide runs)
    assert 0 < widths["fast_rows"] < widths["rows"]
    nulls = _decoded(layouts["nulls"])[2]
    # 4 definition-level tiles each column, 4 value tiles of the column
    # with valid rows, none of the all-null one
    assert nulls["searches"] == 12


@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 1000, 1501, 100_000])
def test_first_run_is_the_run_holding_lo(n):
    rng = np.random.default_rng(n)
    starts = np.sort(rng.integers(0, 3 * n, n)).astype(np.int64)
    starts[0] = rng.integers(0, 3)
    near = rng.choice(starts, min(n, 500))
    los = np.concatenate([near, near - 1, near + 1, starts[:1] - 1,
                          starts[-1:], rng.integers(-2, 3 * n + 2, 64)])
    for lo in los:
        want = max(int(np.searchsorted(starts, lo, side="right")) - 1, 0)
        assert tpd._first_run(starts, int(lo)) == want, (n, lo)


def test_written_bytes_count_every_row_to_the_capacity(layouts):
    layout = layouts["nulls"]
    cap = layout.capacity
    # an int32 column with nulls and an all-null int64 column
    assert layout.written_bytes() == cap * (4 + 1) + cap * (8 + 1)
    assert layout.decoded_bytes() == layout.n_rows * (4 + 1 + 8 + 1)


@pytest.fixture(scope="module")
def parquet_batches(tmp_path_factory):
    d = tmp_path_factory.mktemp("k5tiles")
    shapes = kc.k5_shapes_file(str(d), 20_000)
    lineitem = tpch.write_lineitem(
        tpch.gen_lineitem(30_000, linenumber=True), str(d / "li"),
        n_files=1)
    out = {}
    for case, path, schema in (
            ("shapes", shapes,
             engine_schema(pq.ParquetFile(shapes).schema_arrow)),
            ("lineitem", lineitem[0], tpch.LINEITEM_GROUPED_SCHEMA)):
        scan = GpuFileScanExec([path], schema=schema)
        out[case] = scan.batch_layouts(RapidsConf())
    return out


@pytest.mark.parametrize("case", ["shapes", "lineitem"])
def test_tile_walk_on_parquet_batches(parquet_batches, case):
    layouts = parquet_batches[case]
    assert layouts
    for layout in layouts:
        assert layout.device_names
        want, got, stats = _decoded(layout)
        assert torch.equal(got, want), case
        assert stats["searches"] >= stats["tiles"] - stats["padding_tiles"]
