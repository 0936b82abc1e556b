"""Parquet scan: files -> host decode -> staged upload -> device batches.

Counterpart of ``spark_rapids_tpu/io/scan.py:92-134,276-321,436-560,
1086-1136,1144-1163``: ``FileSplit``, ``plan_splits``, the Parquet
``_decode_split`` and ``GpuFileScanExec`` with the host-decode
``execute``, under the reference's reader modes (PERFILE, MULTITHREADED,
COALESCING) and scan metrics (``numOutputRows``, ``scanTime``,
``assembleTime``, ``uploadTime``, ``uploadWaitTime``).

The upload: pyarrow decodes a batch on the host; a feeder thread
(``pipelined_map``) unpacks its validity bitmaps to bool and lays every
column, padded to the batch capacity, into one pinned staging buffer
(``ops/parquet_decode.BatchLayout`` with no device-decoded column);
one ``non_blocking`` copy on a side CUDA stream moves it to the device
and records an event. The consumer's stream waits on that event, and
``record_stream`` hands the device buffer over to it. A staging buffer
is written again only after its last copy's event has completed (the
hazard ``io/parquet_device.py:1049-1073`` documents for the JAX path).

Device page decode (``spark.rapids.sql.format.parquet.deviceDecode.
enabled``, the reference's default) is the counterpart of ``:611-1084``
(``_use_device_decode``, ``_device_rg_tasks``, ``_plan_row_group``,
``_assemble_device_batch``, ``_coalesced_groups``, ``_merge_planned``,
``_execute_device_decode`` and ``fused_scan_execute``): a pool plans each
row group's column chunks on the host (``parquet_plan.plan_chunk``: page
walk, decompression, run headers), consecutive row groups coalesce into
batches, and the feeder thread lays each batch out in one blob
(``ops/parquet_decode.BatchLayout``) in pinned staging and copies its
encoded part to the device on the side stream. The consumer's stream
waits on the copy's event and launches **K5** (``decode_batch``) once a
batch; with a fused chain above the scan (``fused_scan_execute``), the
chain's kernel (K1 or K2) follows on the same stream with no host sync.
A chunk outside the decode envelope goes to pyarrow on the host, chosen
by its encoding before any decode, and is counted by reason
(``fallbackChunks``). String columns decode on either path: pyarrow's
buffers on the host path, K5's index stream into the staged string
store on the device path (``ops/parquet_decode.BatchLayout``). Decimal
columns decode on both paths too. A nested column (struct, array, map;
the reference's ``:528`` with ``io/parquet_device.py:502,624``) is a
host chunk with reason ``nested`` in a device-decode row group:
pyarrow decodes it and ``columnar/arrow_bridge.column_to_device``
uploads it beside the batch's flat columns, which stay on K5 (the blob
holds the flat columns only, ``_flat_schema``). The reference looks its
chunks up by leaf name, misses a nested column and reads it as nulls,
counting no chunk for it (ROADMAP queue C).
Each staged blob of the device-decode path is a pinned entry in the
memory manager's ledger from the feeder's upload until the consumer takes
it (the reference's ``:1000-1015``), so eviction pressure sees the
in-flight window; an early close releases what was never taken. The
chain splice declines (``fused_scan_execute`` returns None) while the
ledger holds more than half its budget (``:900-908``), so the chain runs
in ``fused_batches`` under split-and-retry; and the consumer checks the
query's cancellation a batch (``:1025,1117``). A spill victim chosen on
the feeder thread was made on the consumer's stream (the blob, made on
the side stream, is pinned), so its download waits for it there.
A scan spliced into its consumer's stage counts its own output rows,
batches and bytes for the operator metrics, which its execute shim
would count on any other path; ``static_bytes_estimate`` (the files'
sizes, the reference's ``:505``) is the plan verifier's estimate.
The registry (``obs/metrics.py``) sees every scan batch, as the
reference's ``:59-76,1044-1047,1131-1132``: its assembly and upload
seconds (``rapids_scan_assemble_seconds`` and
``rapids_scan_upload_seconds``, mode ``device`` or ``arrow``) and the
device-decode path's chunks (``rapids_scan_device_chunks_total``,
``rapids_scan_fallback_chunks_total`` by reason), the process-wide twins
of the query's ``assembleTime``, ``uploadTime``, ``deviceChunks`` and
``fallbackChunks``.
A scan the planner places on the CPU (``execute_cpu``, the reference's
``:1138-1163`` with ``_align``) yields pyarrow's batches in the same
split order, cast to its schema, and touches no device.

The scan's rest (the reference's ``:92-435,445-478``): the constructor
takes ``fmt`` (``parquet``, ``orc``, ``csv``, ``json``, ``hivetext``),
``columns`` (the columns read), ``pushdown`` (an expression whose simple
conjuncts prune Parquet row groups by their footer statistics,
``_simple_conjuncts`` and ``_rg_may_match``, on both decode paths; the
filter above still runs) and ``conf``. Paths below their common
directory that hold ``key=value`` components add Hive partition columns
(``_hive_partition_values``, typed by the strict ``_INT_RE`` and
``_FLOAT_RE``), a constant a file: on the device-decode path they ride
the staged blob beside the host-decoded columns. ORC, CSV and JSON
decode through pyarrow, and Hive text (LazySimpleSerDe's defaults,
``_decode_hive_text``) through Python, under an explicit schema; their
batches upload as the Parquet host path's do. K5 decodes Parquet only.
A format whose ``spark.rapids.sql.format.<fmt>.enabled`` is off scans
on the CPU (``gpu_supported_conf``).
"""
from __future__ import annotations

import concurrent.futures
import decimal
import os
import queue
import re
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import torch

from .. import datatypes as dt
from ..columnar.arrow_bridge import (arrow_schema, column_to_device,
                                     engine_schema, host_lanes,
                                     string_parts)
from ..columnar.batch import GpuBatch, bucket_rows
from ..columnar.column import GpuColumnVector, is_string_like, torch_dtype
from ..config import (FORMAT_CONF, MAX_PARTITION_BYTES,
                      PARQUET_DEVICE_DECODE,
                      PARQUET_MULTITHREADED_THREADS, PARQUET_READER_TYPE,
                      SCAN_COALESCE_TARGET_BYTES, SCAN_INFLIGHT_BATCHES,
                      SCAN_PREFETCH_BATCHES, SCAN_STAGE_FUSION,
                      SCAN_UPLOAD_THREADS, RapidsConf)
from ..exec.base import ExecCtx, LeafExec
from ..obs.metrics import REGISTRY as _METRICS, TRANSFER_BUCKETS
from ..ops.parquet_decode import BatchLayout, decode_batch
from ..pipeline import pipelined_map
from .parquet_plan import (STR_EXPANSION_CAP, HostFallback,
                           merge_chunk_plans, plan_chunk)

__all__ = ["FileSplit", "GpuFileScanExec", "plan_splits"]

# each scan batch's transfer stages, split as the query's metrics are;
# mode = device (K5's blob path) | arrow (host-decoded batches)
SCAN_ASSEMBLE_SECONDS = _METRICS.histogram(
    "rapids_scan_assemble_seconds",
    "Host-side blob/batch assembly time per scan output batch.",
    ("mode",), buckets=TRANSFER_BUCKETS)
SCAN_UPLOAD_SECONDS = _METRICS.histogram(
    "rapids_scan_upload_seconds",
    "Host->device transfer + decode-dispatch time per scan output "
    "batch.", ("mode",), buckets=TRANSFER_BUCKETS)
# every column chunk the device-decode scan plans is decoded by K5 or
# falls back to pyarrow, with its bounded reason
SCAN_DEVICE_CHUNKS = _METRICS.counter(
    "rapids_scan_device_chunks_total",
    "Column chunks decoded on device by the parquet scan.")
SCAN_FALLBACK_CHUNKS = _METRICS.counter(
    "rapids_scan_fallback_chunks_total",
    "Column chunks that fell back to host pyarrow decode, by bounded "
    "reason slug.", ("reason",))

class FileSplit:
    """A unit of scan work: one file, optionally restricted to a
    row-group range. The FilePartition analog."""

    __slots__ = ("path", "row_groups", "nbytes")

    def __init__(self, path: str, row_groups: Optional[List[int]] = None,
                 nbytes: int = 0):
        self.path = path
        self.row_groups = row_groups
        self.nbytes = nbytes

    def __repr__(self):
        rg = "" if self.row_groups is None else f" rg={self.row_groups}"
        return f"FileSplit({self.path}{rg})"


def plan_splits(paths: Sequence[str], fmt: str,
                max_partition_bytes: int) -> List[FileSplit]:
    """Row-group-aligned split planning for Parquet; whole files
    otherwise."""
    splits: List[FileSplit] = []
    for path in paths:
        if fmt != "parquet":
            splits.append(FileSplit(path))
            continue
        md = pq.ParquetFile(path).metadata
        cur: List[int] = []
        cur_bytes = 0
        for rg in range(md.num_row_groups):
            sz = md.row_group(rg).total_byte_size
            if cur and cur_bytes + sz > max_partition_bytes:
                splits.append(FileSplit(path, cur, cur_bytes))
                cur, cur_bytes = [], 0
            cur.append(rg)
            cur_bytes += sz
        if cur or md.num_row_groups == 0:
            splits.append(FileSplit(path, cur, cur_bytes))
    return splits


# strict numeric forms only: Python's float() and int() take 'nan', 'inf'
# and '1_0', which Spark and LazySimpleSerDe read as a string or a null;
# partition values and Hive text fields share them
_INT_FORM = r"[+-]?\d+"
_FLOAT_FORM = r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?"
_INT_RE = re.compile(_INT_FORM + r"\Z")
_FLOAT_RE = re.compile(_FLOAT_FORM + r"\Z")


# --- row-group pruning --------------------------------------------------------

def _simple_conjuncts(expr) -> List[Tuple[str, str, object]]:
    """The ``(column, op, literal)`` conjuncts of ``expr`` that row-group
    statistics can test; anything else is not pushed."""
    from ..expr.base import BoundReference, Literal, UnresolvedColumn
    from ..expr.predicates import (And, EqualTo, GreaterThan,
                                   GreaterThanOrEqual, LessThan,
                                   LessThanOrEqual)
    ops = {EqualTo: "=", LessThan: "<", LessThanOrEqual: "<=",
           GreaterThan: ">", GreaterThanOrEqual: ">="}
    flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}
    out: List[Tuple[str, str, object]] = []

    def colname(e):
        if isinstance(e, (UnresolvedColumn, BoundReference)):
            return e.name
        return None

    def rec(e):
        if isinstance(e, And):
            rec(e.children[0])
            rec(e.children[1])
            return
        op = ops.get(type(e))
        if op is None:
            return
        left, right = e.children
        if colname(left) is not None and isinstance(right, Literal):
            out.append((colname(left), op, right.value))
        elif colname(right) is not None and isinstance(left, Literal):
            out.append((colname(right), flip[op], left.value))

    rec(expr)
    return out


def _rg_may_match(md, rg: int, name_to_idx, conjuncts) -> bool:
    """False only where the footer's statistics prove no row of the row
    group passes."""
    row_group = md.row_group(rg)
    for name, op, lit in conjuncts:
        ci = name_to_idx.get(name)
        if ci is None:
            continue
        stats = row_group.column(ci).statistics
        if stats is None or not stats.has_min_max:
            continue
        lo, hi = stats.min, stats.max
        try:
            if op == "=" and (lit < lo or lit > hi):
                return False
            if op in ("<", "<=") and not (lo < lit or
                                          (op == "<=" and lo <= lit)):
                return False
            if op in (">", ">=") and not (hi > lit or
                                          (op == ">=" and hi >= lit)):
                return False
        except TypeError:  # incomparable statistics
            continue
    return True


def _pruned_groups(path: str, groups: Optional[List[int]],
                   conjuncts) -> List[int]:
    """The split's row groups that may hold a passing row."""
    md = pq.ParquetFile(path).metadata
    if groups is None:
        groups = list(range(md.num_row_groups))
    if not conjuncts:
        return groups
    name_to_idx = {md.schema.column(i).name: i
                   for i in range(md.num_columns)}
    return [g for g in groups
            if _rg_may_match(md, g, name_to_idx, conjuncts)]


# --- Hive partition columns ---------------------------------------------------

_HIVE_NULL = "__HIVE_DEFAULT_PARTITION__"


def _hive_partition_values(paths: Sequence[str]):
    """``({path: {key: typed value}}, Schema of the partition columns)``
    from the ``key=value`` components of the paths below their common
    directory (Spark's basePath-relative discovery: a prefix every file
    shares is not a partition), or ``({}, None)``. A column is int64
    where every value is an integer, float64 where a float, else a
    string; ``__HIVE_DEFAULT_PARTITION__`` is null."""
    import urllib.parse
    if len(paths) < 2:
        base = os.path.dirname(paths[0]) if paths else ""
    else:
        base = os.path.commonpath([os.path.dirname(p) for p in paths])
    raw: dict = {}
    keys: List[str] = []
    for p in paths:
        vals = {}
        for comp in os.path.relpath(os.path.dirname(p), base).split(os.sep):
            k, eq, v = comp.partition("=")
            if not eq or not k:
                continue
            vals[k] = urllib.parse.unquote(v)
            if k not in keys:
                keys.append(k)
        raw[p] = vals
    if not keys:
        return {}, None

    def infer(vals):
        nonnull = [v for v in vals if v is not None and v != _HIVE_NULL]
        for t, conv, pat in ((dt.INT64, int, _INT_RE),
                             (dt.FLOAT64, float, _FLOAT_RE)):
            if all(pat.match(v) for v in nonnull):
                return t, conv
        return dt.STRING, str

    fields, convs = [], {}
    for k in keys:
        t, conv = infer([raw[p].get(k) for p in paths])
        fields.append(dt.StructField(k, t, True))
        convs[k] = conv
    typed = {p: {k: (None if raw[p].get(k) in (None, _HIVE_NULL)
                     else convs[k](raw[p][k])) for k in keys}
             for p in paths}
    return typed, dt.Schema(fields)


def _partition_arrays(part_vals, part_schema, n: int) -> List[pa.Array]:
    return [pa.array([(part_vals or {}).get(f.name)] * n,
                     type=dt.to_arrow(f.dtype)) for f in part_schema.fields]


def _attach_partition_columns(rbs: List[pa.RecordBatch], part_vals,
                              part_schema) -> List[pa.RecordBatch]:
    """The split's batches with its constant partition columns after
    the file's."""
    if part_schema is None:
        return rbs
    names = part_schema.names
    return [pa.RecordBatch.from_arrays(
        list(rb.columns) + _partition_arrays(part_vals, part_schema,
                                             rb.num_rows),
        names=list(rb.schema.names) + names) for rb in rbs]


# --- host decode --------------------------------------------------------------

def _decode_split(split: FileSplit, fmt: str, columns, batch_rows: int,
                  conjuncts, schema=None) -> List[pa.RecordBatch]:
    """Host decode of one split into RecordBatches of at most
    ``batch_rows`` rows; ``schema`` names and types a Hive text file's
    fields (the format has no header)."""
    if fmt == "parquet":
        groups = _pruned_groups(split.path, split.row_groups, conjuncts)
        if not groups:
            return []
        f = pq.ParquetFile(split.path)
        return [rb for rb in f.iter_batches(batch_size=batch_rows,
                                            row_groups=groups,
                                            columns=columns)
                if rb.num_rows]
    if fmt == "hivetext":
        return _decode_hive_text(split.path, columns, batch_rows, schema)
    if fmt == "orc":
        from pyarrow import orc
        table = orc.ORCFile(split.path).read(columns=columns)
    elif fmt == "csv":
        from pyarrow import csv
        table = csv.read_csv(split.path)
        if columns:
            table = table.select(columns)
    elif fmt == "json":
        from pyarrow import json as pj
        table = pj.read_json(split.path)
        if columns:
            table = table.select(columns)
    else:
        raise ValueError(f"unknown scan format {fmt!r}")
    return [rb for rb in table.combine_chunks().to_batches(
        max_chunksize=batch_rows) if rb.num_rows]


def _hive_unescape(tok: str):
    if tok == "\\N":
        return None
    if "\\" not in tok:
        return tok
    out, i = [], 0
    while i < len(tok):
        ch = tok[i]
        if ch == "\\" and i + 1 < len(tok):
            out.append({"n": "\n", "r": "\r"}.get(tok[i + 1], tok[i + 1]))
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def _hive_split_row(line: str) -> List[str]:
    """A line's fields at each unescaped \\x01."""
    if "\\" not in line:
        return line.split("\x01")
    toks, cur, i = [], [], 0
    while i < len(line):
        ch = line[i]
        if ch == "\\" and i + 1 < len(line):
            cur.append(line[i:i + 2])
            i += 2
            continue
        if ch == "\x01":
            toks.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
        i += 1
    toks.append("".join(cur))
    return toks


def _hive_date(v: str):
    import datetime
    y, m, d = v.split("-")
    return datetime.date(int(y), int(m), int(d))


def _hive_timestamp(v: str):
    import datetime
    ts = datetime.datetime.fromisoformat(v)
    return ts if ts.tzinfo is not None \
        else ts.replace(tzinfo=datetime.timezone.utc)


def _hive_converter(t: dt.DataType):
    """A field's text read as ``t`` in Python: raises ValueError (or
    returns None) where the serde reads a null, as for a malformed
    number."""
    import base64
    if dt.is_integral(t):
        return lambda v: int(v) if _INT_RE.match(v) else None
    if dt.is_floating(t):
        return lambda v: float(v) if _FLOAT_RE.match(v) else None
    if isinstance(t, dt.DateType):
        return _hive_date
    if isinstance(t, dt.TimestampType):
        return _hive_timestamp
    if isinstance(t, dt.DecimalType):
        return decimal.Decimal
    if isinstance(t, dt.BinaryType):
        return base64.b64decode  # Hive's Base64 binary
    raise TypeError(f"no Hive text converter for {t}")


def _only_null_escapes(data: bytes) -> bool:
    """Whether every backslash of ``data`` opens a \\N that is a whole
    field: after a delimiter, a line's start or the file's, and before a
    delimiter, a line's end or the file's."""
    raw = np.frombuffer(data, np.uint8)
    at = np.flatnonzero(raw == ord("\\"))
    if not len(at):
        return True
    padded = np.concatenate([[10], raw, [10, 10]])  # the file's ends
    before, n_at, after = padded[at], padded[at + 2], padded[at + 3]
    return bool((n_at == ord("N")).all() & np.isin(before, (1, 10)).all()
                & np.isin(after, (1, 10, 13)).all())


def _hive_arrow_column(col: pa.Array, t: dt.DataType) -> pa.Array:
    """A column of unescaped field texts (null for \\N) read as ``t``,
    the one converter of both ways of splitting a file: strings as they
    are, booleans and ASCII numbers through pyarrow's compute under the
    strict forms, every other value by ``_hive_converter``; a malformed
    value is null."""
    if not isinstance(col, pa.Array):
        col = col.combine_chunks()
    target = dt.to_arrow(t)
    if is_string_like(t) and not isinstance(t, dt.BinaryType):
        return col.cast(target)
    if isinstance(t, dt.BooleanType):
        return pc.equal(pc.utf8_lower(col), "true")
    numeric = dt.is_integral(t) or dt.is_floating(t)
    # RE2's \d is ASCII and Python's is not: a column holding another
    # digit is read value by value, as int() and float() read it
    if numeric and pc.all(pc.string_is_ascii(col)).as_py() is not False:
        form = _INT_FORM if dt.is_integral(t) else _FLOAT_FORM
        ok = pc.match_substring_regex(col, f"^(?:{form})$")
        kept = pc.replace_substring_regex(
            pc.if_else(ok, col, pa.scalar(None, pa.string())), r"^\+", "")
        if dt.is_integral(t):
            return kept.cast(target)
        return kept.cast(pa.float64()).cast(target, safe=False)
    conv, out = _hive_converter(t), []
    for v in col.to_pylist():
        if v is not None:
            try:
                v = conv(v)
            except (ValueError, TypeError, ArithmeticError):
                v = None
        out.append(v)
    return pa.array(out, type=target)


def _hive_text_arrow(data: bytes, all_names, names, schema,
                     batch_rows: int) -> Optional[List[pa.RecordBatch]]:
    """The file through pyarrow's CSV reader where that reads what the
    serde does: every backslash opens a whole-field \\N, every \\r
    ends a line before its \\n, no line is empty, and every row has
    every field. None where it cannot (then ``_decode_hive_text`` walks
    the lines)."""
    from pyarrow import csv
    lines = b"\n" + data.replace(b"\r\n", b"\n")
    if b"\r" in lines or b"\n\n" in lines or not _only_null_escapes(data):
        return None  # a bare \r, an empty line (one field) or an escape
    try:
        table = csv.read_csv(
            pa.py_buffer(data),
            read_options=csv.ReadOptions(column_names=all_names),
            parse_options=csv.ParseOptions(
                delimiter="\x01", quote_char=False, escape_char=False,
                ignore_empty_lines=False),
            convert_options=csv.ConvertOptions(
                column_types={n: pa.string() for n in all_names},
                null_values=["\\N"], strings_can_be_null=True,
                include_columns=names))
    except pa.ArrowInvalid:  # a row of another width
        return None
    table = pa.table([_hive_arrow_column(table.column(n), schema[n].dtype)
                      for n in names], names=names).combine_chunks()
    return [rb for rb in table.to_batches(max_chunksize=batch_rows)
            if rb.num_rows]


def _decode_hive_text(path: str, columns, batch_rows: int,
                      schema) -> List[pa.RecordBatch]:
    """A Hive LazySimpleSerDe text file (the GpuHiveTextFileFormat
    analog): \\x01 between fields, \\N for null, the serde's
    escapes, no header; ``schema`` names and types the fields. Rows end
    at \\n alone (a bare \\r may sit inside an escaped field); one \\r
    before it is the terminator's. A file without escapes is split into
    fields by pyarrow (``_hive_text_arrow``), any other line by line;
    both read the fields through ``_hive_arrow_column``."""
    if schema is None:
        raise ValueError("hivetext scans need an explicit schema= "
                         "(the format has no header)")
    all_names = [f.name for f in schema.fields]
    names = [n for n in all_names if columns is None or n in columns]
    with open(path, "rb") as fh:
        data = fh.read()
    if not data:
        return []
    fast = _hive_text_arrow(data, all_names, names, schema, batch_rows)
    if fast is not None:
        return fast
    lines = data.decode("utf-8").split("\n")
    if lines and lines[-1] == "":
        lines.pop()  # the last row's terminator
    out: List[pa.RecordBatch] = []
    for lo in range(0, len(lines), batch_rows):
        rows = [_hive_split_row(ln[:-1] if ln.endswith("\r") else ln)
                for ln in lines[lo:lo + batch_rows]]
        arrays = []
        for name in names:
            fi = all_names.index(name)
            texts = [_hive_unescape(r[fi]) if fi < len(r) else None
                     for r in rows]
            arrays.append(_hive_arrow_column(pa.array(texts, pa.string()),
                                             schema[name].dtype))
        out.append(pa.RecordBatch.from_arrays(arrays, names=names))
    return out


def _concat(rbs: List[pa.RecordBatch]) -> pa.RecordBatch:
    t = pa.Table.from_batches(rbs).combine_chunks()
    bs = t.to_batches()
    return bs[0] if bs else rbs[0].slice(0, 0)


def _align(rb: pa.RecordBatch, target: pa.Schema) -> pa.RecordBatch:
    """Cast decoded batches to the declared scan schema (checked)."""
    if rb.schema == target:
        return rb
    cols = []
    for f in target:
        idx = rb.schema.get_field_index(f.name)
        if idx < 0:
            cols.append(pa.nulls(rb.num_rows, f.type))
        else:
            c = rb.column(idx)
            cols.append(c if c.type == f.type else c.cast(f.type))
    return pa.RecordBatch.from_arrays(cols, schema=target)


def _check_type(t: dt.DataType) -> None:
    """Raise for a type the scan cannot read (a nested type's leaves
    checked each)."""
    if isinstance(t, dt.StructType):
        for f in t.fields:
            _check_type(f.dtype)
    elif isinstance(t, dt.ArrayType):
        _check_type(t.element_type)
    elif isinstance(t, dt.MapType):
        _check_type(t.key_type)
        _check_type(t.value_type)
    elif not is_string_like(t) and not isinstance(t, dt.DecimalType):
        torch_dtype(t)


def _check_types(schema: dt.Schema) -> None:
    for f in schema.fields:
        _check_type(f.dtype)


def _lane_stat(v, t: dt.DataType) -> Optional[int]:
    """A row-group statistic in lane units: an integer as it is, a
    decimal's ``decimal.Decimal`` as its unscaled value at the column's
    scale (the reference converts a decimal's text to ``Decimal``,
    ``:392-394``), else None."""
    if isinstance(v, bool):
        return None
    if isinstance(v, int) and not isinstance(t, dt.DecimalType):
        return v
    if isinstance(v, decimal.Decimal) and isinstance(t, dt.DecimalType):
        from ..ops.decimals import EXACT
        return int(v.scaleb(t.scale, EXACT))
    return None


def _host_field(col, f: dt.StructField):
    """Host lanes of one decoded column: ``(values, validity or None)``,
    or ``(offsets, chars, validity or None)`` for a string field."""
    if is_string_like(f.dtype):
        return string_parts(col)
    return host_lanes(col, f.dtype)


_STAGED_SCHEMA = dt.Schema([dt.StructField("__staged__", dt.INT8, False)])


def _staged_batch(blob: torch.Tensor) -> GpuBatch:
    """A staged blob as a one-column batch, the shape a ledger entry
    takes; its bytes are the blob's."""
    from ..columnar.column import GpuColumnVector
    return GpuBatch([GpuColumnVector(dt.INT8, blob.view(torch.int8))],
                    _STAGED_SCHEMA, blob.numel())


class _StagedUpload:
    """Host-to-device copies through a ring of pinned staging buffers on
    a side stream. ``stage`` runs on the feeder thread; ``hand_over``
    on the consumer's."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self._ring: List[Optional[list]] = [None] * slots
        self._next = 0

    def stage_blob(self, prefix: int, total: int, fill):
        """A device blob of ``total`` bytes whose first ``prefix`` bytes
        ``fill(host uint8 array)`` writes on the host and one copy moves
        to the device; the rest is left for the device to write. Returns
        ``(blob, event)``; ``event`` is None on the CPU."""
        if not self.cuda:
            host = np.zeros(total, np.uint8)
            fill(host[:prefix])
            return torch.from_numpy(host), None
        k = self._next
        self._next = (k + 1) % len(self._ring)
        slot = self._ring[k]
        if slot is None or slot[0].numel() < prefix:
            if slot is not None:
                slot[1].synchronize()  # its last copy may still read it
            slot = [torch.empty(max(prefix, 1), dtype=torch.uint8,
                                pin_memory=True), None]
            self._ring[k] = slot
        elif slot[1] is not None:
            slot[1].synchronize()  # reuse only after its copy completed
        pinned = slot[0]
        fill(pinned.numpy()[:prefix])
        with torch.cuda.stream(self.stream):
            blob = torch.empty(total, dtype=torch.uint8, device=self.device)
            blob[:prefix].copy_(pinned[:prefix], non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        slot[1] = event
        return blob, event

    def hand_over(self, blob: torch.Tensor, event) -> None:
        """Make the consumer's stream wait for the copy, and tell the
        allocator that stream now uses the blob."""
        if event is None:
            return
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        blob.record_stream(stream)


class GpuFileScanExec(LeafExec):
    """Leaf scan over files (the GpuBatchScanExec analog): ``fmt`` one of
    ``_FORMATS``; ``pushdown`` an expression whose simple conjuncts prune
    Parquet row groups (the filter above still runs)."""

    def __init__(self, paths: Sequence[str], fmt: str = "parquet",
                 schema: Optional[dt.Schema] = None,
                 columns: Optional[List[str]] = None, pushdown=None,
                 conf: Optional[RapidsConf] = None):
        super().__init__()
        if isinstance(paths, str):
            paths = [paths]
        if not paths:
            raise ValueError("scan needs at least one file")
        if fmt not in FORMAT_CONF:
            raise ValueError(f"unknown scan format {fmt!r}")
        self.paths = list(paths)
        self.fmt = fmt
        self.columns = columns
        self.pushdown = pushdown
        self._conjuncts = _simple_conjuncts(pushdown) \
            if pushdown is not None else []
        self._max_partition_bytes = None if conf is None \
            else conf.get(MAX_PARTITION_BYTES)
        self._part_values, self._part_schema = _hive_partition_values(
            self.paths)
        if schema is None:
            schema = self._infer_schema()
            if self._part_schema is not None:
                schema = dt.Schema(list(schema.fields)
                                   + list(self._part_schema.fields))
        elif self._part_schema is not None:
            # an explicit schema takes only the partition columns it names
            kept = [f for f in self._part_schema.fields
                    if f.name in set(schema.names)]
            self._part_schema = dt.Schema(kept) if kept else None
        self._schema = schema
        # the fields the staged blob holds: all but the nested ones
        self._flat_schema = dt.Schema([f for f in schema.fields
                                       if not dt.is_nested(f.dtype)])
        self._bounds = {}
        self._pf_local = threading.local()

    def __getstate__(self):
        # the per-thread open files are per-run state: a plan that goes
        # into a cluster task's pickle, or a deep copy, opens its own
        state = dict(self.__dict__)
        state.pop("_pf_local", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._pf_local = threading.local()

    def _infer_schema(self) -> dt.Schema:
        """The first file's schema (a CSV or JSON file is read for it)."""
        if self.fmt == "parquet":
            asch = pq.ParquetFile(self.paths[0]).schema_arrow
        elif self.fmt == "orc":
            from pyarrow import orc
            asch = orc.ORCFile(self.paths[0]).schema
        elif self.fmt == "hivetext":
            raise ValueError("hivetext scans need an explicit schema= "
                             "(the format has no header)")
        else:
            rbs = _decode_split(FileSplit(self.paths[0]), self.fmt,
                                self.columns, 1 << 16, [])
            if not rbs:
                raise ValueError(
                    f"cannot infer schema from empty {self.fmt} file "
                    f"{self.paths[0]}: pass schema=")
            asch = rbs[0].schema
        if self.columns:
            asch = pa.schema([asch.field(c) for c in self.columns])
        return engine_schema(asch)

    @property
    def output_schema(self):
        return self._schema

    def static_bytes_estimate(self):
        """The files' sizes: the plan verifier's estimate of the scan's
        bytes (the reference's ``:505``)."""
        try:
            return sum(os.path.getsize(p) for p in self.paths)
        except OSError:
            return None

    def describe(self):
        return (f"FileScanExec [{self.fmt} x{len(self.paths)}"
                + (f" pushdown={self._conjuncts}" if self._conjuncts
                   else "") + "]")

    def pretty_name(self):
        return "FileScanExec"

    def gpu_supported_conf(self, conf: RapidsConf) -> Optional[str]:
        entry = FORMAT_CONF[self.fmt]
        if not conf.get(entry):
            return f"the {self.fmt} scan is disabled by {entry.key}"
        return None

    def expressions(self):
        return [self.pushdown] if self.pushdown is not None else []

    def _splits(self, conf) -> List[FileSplit]:
        return plan_splits(self.paths, self.fmt,
                           self._max_partition_bytes
                           or conf.get(MAX_PARTITION_BYTES))

    def _decode_with_parts(self, split: FileSplit,
                           batch_rows: int) -> List[pa.RecordBatch]:
        rbs = _decode_split(split, self.fmt, self.columns, batch_rows,
                            self._conjuncts, schema=self._schema)
        return _attach_partition_columns(
            rbs, self._part_values.get(split.path), self._part_schema)

    def _host_batches(self, ctx: ExecCtx) -> Iterator[pa.RecordBatch]:
        """Decoded host batches in split order, per the reader mode (a
        format other than Parquet reads MULTITHREADED)."""
        conf = ctx.conf
        mode = conf.get(PARQUET_READER_TYPE) if self.fmt == "parquet" \
            else "MULTITHREADED"
        batch_rows = conf.batch_size_rows
        splits = self._splits(conf)
        if mode == "PERFILE" or len(splits) <= 1:
            for s in splits:
                yield from self._decode_with_parts(s, batch_rows)
            return
        # MULTITHREADED / COALESCING: a pool decodes splits ahead; results
        # are consumed in split order so the output is deterministic
        nthreads = max(1, conf.get(PARQUET_MULTITHREADED_THREADS))
        coalesce = mode == "COALESCING"
        with concurrent.futures.ThreadPoolExecutor(nthreads) as pool:
            futures: "queue.Queue" = queue.Queue()
            stop = threading.Event()

            def submit_all():
                for s in splits:
                    if stop.is_set():
                        return
                    futures.put(pool.submit(self._decode_with_parts, s,
                                            batch_rows))
                futures.put(None)

            feeder = threading.Thread(target=submit_all, daemon=True)
            feeder.start()
            pending: List[pa.RecordBatch] = []
            pending_rows = 0
            try:
                while True:
                    fut = futures.get()
                    if fut is None:
                        break
                    for rb in fut.result():
                        if not coalesce:
                            yield rb
                            continue
                        pending.append(rb)
                        pending_rows += rb.num_rows
                        if pending_rows >= batch_rows:
                            yield _concat(pending)
                            pending, pending_rows = [], 0
                if pending:
                    yield _concat(pending)
            finally:
                stop.set()
                feeder.join()
                while True:  # cancel what was queued so the pool drains
                    try:
                        f = futures.get_nowait()
                    except queue.Empty:
                        break
                    if f is not None:
                        f.cancel()

    def column_bounds(self, name: str) -> Optional[Tuple[int, int]]:
        """``(min, max)`` of an integer column over every row group the
        scan reads, from the footers' row-group statistics (the ones
        ``_rg_may_match``, ``spark_rapids_tpu/io/scan.py:172``, reads);
        None when a row group lacks them. Read once, before the first
        batch; the grouped aggregate sizes K2's keyspace with it."""
        if name not in self._bounds:
            self._bounds[name] = self._read_bounds(name)
        return self._bounds[name]

    def _read_bounds(self, name: str) -> Optional[Tuple[int, int]]:
        if self.fmt != "parquet":
            return None
        lo = hi = None
        for path in self.paths:
            md = pq.ParquetFile(path).metadata
            names = [md.schema.column(i).name for i in range(md.num_columns)]
            if name not in names:
                return None
            ci = names.index(name)
            for g in range(md.num_row_groups):
                st = md.row_group(g).column(ci).statistics
                if st is None or not st.has_min_max:
                    return None
                t = self._schema[name].dtype
                smin, smax = _lane_stat(st.min, t), _lane_stat(st.max, t)
                if smin is None or smax is None:
                    return None
                lo = smin if lo is None else min(lo, smin)
                hi = smax if hi is None else max(hi, smax)
        return None if lo is None else (lo, hi)

    # --- device page decode ------------------------------------------------

    def _use_device_decode(self, conf) -> bool:
        return (self.fmt == "parquet" and conf.get(PARQUET_DEVICE_DECODE)
                and conf.get(PARQUET_READER_TYPE) != "COALESCING")

    def _device_rg_tasks(self, conf) -> List[Tuple[str, int]]:
        """(path, row group) work list, in split order, the row groups
        the pushdown rules out dropped."""
        return [(s.path, g) for s in self._splits(conf)
                for g in _pruned_groups(s.path, s.row_groups,
                                        self._conjuncts)]

    def _thread_pf(self, path: str) -> "pq.ParquetFile":
        """Per-(thread, path) ParquetFile: one footer parse per pool
        thread, and no file handle shared across threads."""
        cache = getattr(self._pf_local, "cache", None)
        if cache is None:
            cache = self._pf_local.cache = {}
        pf = cache.get(path)
        if pf is None:
            pf = cache[path] = pq.ParquetFile(path)
        return pf

    def _plan_row_group(self, path: str, g: int):
        """Host side of one row group on the reader pool: ``(rows, plans
        by column, pyarrow batch of the fallback columns or None, the
        fallback reasons)``."""
        pf = self._thread_pf(path)
        md = pf.metadata
        rg = md.row_group(g)
        name_to_ci = {md.schema.column(i).name: i
                      for i in range(md.num_columns)}
        plans: Dict[str, object] = {}
        host_cols: List[str] = []
        reasons: List[str] = []
        with open(path, "rb") as f:
            for fld in self._schema.fields:
                if dt.is_nested(fld.dtype):
                    if fld.name in pf.schema_arrow.names:
                        host_cols.append(fld.name)
                        reasons.append("nested")
                    continue
                ci = name_to_ci.get(fld.name)
                if ci is None:
                    continue  # a column the file lacks: nulls at assembly
                try:
                    plans[fld.name] = plan_chunk(
                        f, rg.column(ci), pf.schema.column(ci), fld.dtype,
                        pf.schema_arrow.field(fld.name).type)
                except HostFallback as hf:
                    host_cols.append(fld.name)
                    reasons.append(hf.reason)
        host_rb = None
        if host_cols:
            t = pf.read_row_group(g, columns=host_cols)
            host_rb = t.combine_chunks().to_batches()[0] if t.num_rows \
                else None
        if self._part_schema is not None and rg.num_rows:
            # the file's partition values, a constant a column, staged
            # beside the host-decoded columns
            parts = _partition_arrays(self._part_values.get(path),
                                      self._part_schema, rg.num_rows)
            host_rb = pa.RecordBatch.from_arrays(
                ([] if host_rb is None else list(host_rb.columns)) + parts,
                names=([] if host_rb is None else host_rb.schema.names)
                + self._part_schema.names)
        return rg.num_rows, plans, host_rb, tuple(reasons)

    @staticmethod
    def _decoded_estimate(item) -> int:
        """Decoded bytes one planned row group will occupy on the device:
        the coalescer's currency."""
        plans, host_rb = item[1], item[2]
        est = host_rb.nbytes if host_rb is not None else 0
        for plan in plans.values():
            est += plan.n_rows * np.dtype(plan.lane).itemsize \
                + plan.str_char_cap
        return est

    @staticmethod
    def _coalesce_compatible(a, b) -> bool:
        """May two consecutive planned row groups merge into one batch?
        The same device columns of the same lane and DELTA shape, and the
        same fallback schema; dictionaries and sizes may differ."""
        if set(a[1]) != set(b[1]):
            return False
        ha, hb = a[2], b[2]
        if (ha is None) != (hb is None) \
                or (ha is not None and not ha.schema.equals(hb.schema)):
            return False
        return all(x.lane == b[1][k].lane and x.is_delta == b[1][k].is_delta
                   for k, x in a[1].items())

    def _coalesced_groups(self, planned, target_bytes: int, max_rows: int):
        """Group consecutive planned row groups toward ``target_bytes``
        of decoded output and at most ``max_rows`` rows, in split order;
        ``target_bytes <= 0`` keeps one row group a batch. A merged
        string store stays under the expansion cap (``merge_chunk_plans``
        sums the groups' bounds)."""
        group: List = []
        rows = est = str_bound = 0
        for item in planned:
            bound = max((p.str_bound for p in item[1].values()), default=0)
            if group and (rows + item[0] > max_rows
                          or str_bound + bound > STR_EXPANSION_CAP
                          or not self._coalesce_compatible(group[0], item)):
                yield group
                group, rows, est, str_bound = [], 0, 0, 0
            group.append(item)
            rows += item[0]
            str_bound += bound
            est += self._decoded_estimate(item)
            if target_bytes <= 0 or est >= target_bytes \
                    or rows >= max_rows:
                yield group
                group, rows, est, str_bound = [], 0, 0, 0
        if group:
            yield group

    @staticmethod
    def _merge_planned(group):
        """One batch from a coalesced group: each column's plans merged,
        the fallback batches concatenated, the reasons kept."""
        if len(group) == 1:
            return group[0]
        n_rows = sum(g[0] for g in group)
        plans = {k: merge_chunk_plans([g[1][k] for g in group])
                 for k in group[0][1]}
        host_rbs = [g[2] for g in group if g[2] is not None]
        host_rb = _concat(host_rbs) if host_rbs else None
        return n_rows, plans, host_rb, tuple(r for g in group for r in g[3])

    def _host_columns(self, host_rb, plans, n_rows: int):
        """Host lanes of every field that is not decoded on the device:
        pyarrow's decode of a fallback chunk, or nulls for a column the
        file lacks."""
        host = {}
        for f in self._flat_schema.fields:
            if f.name in plans:
                continue
            idx = -1 if host_rb is None \
                else host_rb.schema.get_field_index(f.name)
            if idx < 0:
                if is_string_like(f.dtype):
                    host[f.name] = (np.zeros(n_rows + 1, np.int32),
                                    np.zeros(0, np.uint8),
                                    np.zeros(n_rows, np.bool_))
                else:
                    host[f.name] = (np.zeros(n_rows, f.dtype.np_dtype),
                                    np.zeros(n_rows, np.bool_))
                continue
            col = host_rb.column(idx)
            target = dt.to_arrow(f.dtype)
            host[f.name] = _host_field(col if col.type == target
                                       else col.cast(target), f)
        return host

    def _batch_layout(self, group):
        """The blob layout of one coalesced group's flat columns, its
        fallback reasons and its pyarrow batch (the nested columns)."""
        n_rows, plans, host_rb, reasons = self._merge_planned(group)
        return BatchLayout(self._flat_schema, bucket_rows(max(n_rows, 1)),
                           n_rows, plans, self._host_columns(
                               host_rb, plans, n_rows)), reasons, host_rb

    def _with_nested(self, flat_cols, host_rb, capacity: int,
                     device: torch.device):
        """The batch's columns in schema order: the flat ones as decoded
        or staged, each nested one uploaded from pyarrow's batch (nulls
        where the file lacks it)."""
        if len(self._flat_schema) == len(self._schema):
            return flat_cols
        it = iter(flat_cols)
        out = []
        for f in self._schema.fields:
            if not dt.is_nested(f.dtype):
                out.append(next(it))
                continue
            idx = -1 if host_rb is None \
                else host_rb.schema.get_field_index(f.name)
            if idx < 0:
                out.append(GpuColumnVector.nulls(f.dtype, capacity, device))
                continue
            col = host_rb.column(idx)
            target = dt.to_arrow(f.dtype)
            out.append(column_to_device(
                col if col.type == target else col.cast(target), f.dtype,
                capacity, device))
        return out

    def batch_layouts(self, conf) -> List[BatchLayout]:
        """Every batch's blob layout, as the device-decode path plans and
        coalesces them, planned serially (for the kernel checks)."""
        planned = (self._plan_row_group(p, g)
                   for p, g in self._device_rg_tasks(conf))
        return [self._batch_layout(group)[0]
                for group in self._coalesced_groups(
                    planned, conf.get(SCAN_COALESCE_TARGET_BYTES),
                    max(1, conf.batch_size_rows))]

    def fused_scan_execute(self, ctx: ExecCtx, chain):
        """Scan-rooted fusion (``exec.base.fused_batches``): batches of
        ``chain(batch, eval_ctx)``, each launched on the scan's stream
        right after the batch's K5 decode; None when the device-decode
        path or scan fusion is off, or the ledger is past half its budget
        (the splice has no split-and-retry), and the caller runs the chain
        over ``execute``."""
        if not self._use_device_decode(ctx.conf) \
                or not ctx.conf.get(SCAN_STAGE_FUSION):
            return None
        if ctx.mm.device_bytes > ctx.mm.budget // 2:
            return None
        return self._execute_device_decode(ctx, chain)

    def _execute_device_decode(self, ctx: ExecCtx, chain=None):
        _check_types(self._schema)
        conf = ctx.conf
        rows = ctx.metric(self, "numOutputRows")
        scan_t = ctx.metric(self, "scanTime")
        asm_t = ctx.metric(self, "assembleTime")
        up_t = ctx.metric(self, "uploadTime")
        wait_t = ctx.metric(self, "uploadWaitTime")
        enc_m = ctx.metric(self, "encodedBytes")
        dec_m = ctx.metric(self, "decodedBytes")
        dev_m = ctx.metric(self, "deviceChunks")
        fb_m = ctx.metric(self, "fallbackChunks")
        # scanPrograms counts the batches that launched K5 (or ran a chain
        # without it), fusedDispatches those whose chain ran right after
        # K5 on the same stream
        programs_m = ctx.metric(self, "scanPrograms")
        fused_m = ctx.metric(self, "fusedDispatches")
        # a spliced scan is not run through its execute shim: it counts
        # its own output (the decoded batches) for the operator metrics
        counted = chain is not None and ctx.opm.enabled
        if counted:
            out_rows_m = ctx.metric(self, "rows")
            out_batches_m = ctx.metric(self, "batches")
            out_bytes_m = ctx.metric(self, "outputBytes")
        tasks = self._device_rg_tasks(conf)
        if not tasks:
            return
        nthreads = max(1, conf.get(PARQUET_MULTITHREADED_THREADS))
        depth = nthreads + max(0, conf.get(SCAN_PREFETCH_BATCHES))
        window = max(1, conf.get(SCAN_INFLIGHT_BATCHES))
        # the staging ring has one writer: one feeder thread, or none
        threads = min(1, conf.get(SCAN_UPLOAD_THREADS))
        uploader = _StagedUpload(ctx.device, slots=window + 1)
        pool = concurrent.futures.ThreadPoolExecutor(
            nthreads, thread_name_prefix="scan-plan")

        def planned():
            pending: List = []
            it = iter(tasks)

            def topup():
                while len(pending) < depth:
                    try:
                        p, g = next(it)
                    except StopIteration:
                        return
                    pending.append(pool.submit(self._plan_row_group, p, g))
            topup()
            while pending:
                t0 = time.perf_counter()
                item = pending.pop(0).result()
                scan_t.value += time.perf_counter() - t0
                topup()
                yield item

        mm = ctx.mm
        inflight: set = set()  # ledger entries not yet handed over
        ilock = threading.Lock()
        closed = [False]

        def assemble(group):
            t0 = time.perf_counter()
            # counted before the merge: one count per planned chunk
            dev_chunks = sum(len(g[1]) for g in group)
            layout, reasons, host_rb = self._batch_layout(group)
            t1 = time.perf_counter()
            blob, event = uploader.stage_blob(
                layout.prefix_bytes, layout.total_bytes, layout.fill)
            sb = mm.register(_staged_batch(blob), pinned=True)
            with ilock:
                if closed[0]:  # the consumer is gone: never delivered
                    sb.release()
                    return None
                inflight.add(sb)
            return (blob, event, sb, layout, dev_chunks, reasons, host_rb,
                    t1 - t0, time.perf_counter() - t1)

        groups = self._coalesced_groups(planned(),
                                        conf.get(SCAN_COALESCE_TARGET_BYTES),
                                        max(1, conf.batch_size_rows))
        gen = pipelined_map(assemble, groups, threads=threads, window=window)
        qx = ctx.qctx
        try:
            while True:
                if qx is not None:
                    qx.check()
                t0 = time.perf_counter()
                try:
                    (blob, event, sb, layout, dev_chunks, reasons, host_rb,
                     asm_s, up_s) = next(gen)
                except StopIteration:
                    break
                with ilock:
                    inflight.discard(sb)
                sb.release()  # the consumer holds the blob now
                wait_t.value += time.perf_counter() - t0
                asm_t.value += asm_s
                up_t.value += up_s
                SCAN_ASSEMBLE_SECONDS.labels("device").observe(asm_s)
                SCAN_UPLOAD_SECONDS.labels("device").observe(up_s)
                enc_m.value += layout.encoded_bytes()
                dec_m.value += layout.decoded_bytes()
                dev_m.value += dev_chunks
                fb_m.value += len(reasons)
                if dev_chunks:
                    SCAN_DEVICE_CHUNKS.inc(dev_chunks)
                for r in reasons:
                    ctx.metric(self, f"fallbackChunks.{r}").value += 1
                    SCAN_FALLBACK_CHUNKS.labels(r).inc()
                rows.value += layout.n_rows
                uploader.hand_over(blob, event)
                batch = GpuBatch(self._with_nested(
                    decode_batch(blob, layout), host_rb, layout.capacity,
                    ctx.device), self._schema, layout.n_rows)
                decoded = bool(layout.device_names)
                if decoded or chain is not None:
                    programs_m.value += 1
                if counted:
                    out_rows_m.value += layout.n_rows
                    out_batches_m.value += 1
                    out_bytes_m.value += batch.device_size_bytes()
                if chain is not None:
                    if decoded:
                        fused_m.value += 1
                    batch = chain(batch, ctx.eval_ctx)
                yield batch
        finally:
            gen.close()
            pool.shutdown(wait=False, cancel_futures=True)
            # an early close: release what the consumer never took (a
            # straggler sees closed and releases its own)
            with ilock:
                closed[0] = True
                leftovers = list(inflight)
                inflight.clear()
            for sb in leftovers:
                sb.release()

    # --- host decode ---------------------------------------------------------

    def execute_cpu(self, ctx: ExecCtx):
        """The CPU path (the reference's ``:1138-1141``): pyarrow's
        decode in the reader mode's split order, each batch cast to the
        scan's schema; nothing is decoded on the card."""
        _check_types(self._schema)
        rows = ctx.metric(self, "numOutputRows")
        target = arrow_schema(self._schema)
        for rb in self._host_batches(ctx):
            rows += rb.num_rows
            yield _align(rb, target)

    def execute(self, ctx: ExecCtx):
        _check_types(self._schema)
        if self._use_device_decode(ctx.conf):
            yield from self._execute_device_decode(ctx)
            return
        rows = ctx.metric(self, "numOutputRows")
        scan_t = ctx.metric(self, "scanTime")
        asm_t = ctx.metric(self, "assembleTime")
        up_t = ctx.metric(self, "uploadTime")
        wait_t = ctx.metric(self, "uploadWaitTime")
        target = arrow_schema(self._schema)
        depth = max(ctx.conf.get(SCAN_PREFETCH_BATCHES), 0)
        uploader = _StagedUpload(ctx.device, slots=depth + 1)

        def upload(rb):
            t0 = time.perf_counter()
            rb = _align(rb, target)
            layout = BatchLayout(
                self._flat_schema, bucket_rows(rb.num_rows), rb.num_rows, {},
                {f.name: _host_field(rb.column(i), f)
                 for i, f in enumerate(self._schema.fields)
                 if not dt.is_nested(f.dtype)})
            t1 = time.perf_counter()
            blob, event = uploader.stage_blob(
                layout.prefix_bytes, layout.total_bytes, layout.fill)
            return (blob, event, layout, rb, t1 - t0,
                    time.perf_counter() - t1)

        def timed_source():
            t0 = time.perf_counter()
            for rb in self._host_batches(ctx):
                scan_t.value += time.perf_counter() - t0
                yield rb
                t0 = time.perf_counter()

        # a feeder thread stages and copies up to `depth` batches ahead of
        # the consumer; depth 0 is the serial path
        gen = pipelined_map(upload, timed_source(), threads=1, window=depth)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    blob, event, layout, rb, asm_s, up_s = next(gen)
                except StopIteration:
                    break
                wait_t.value += time.perf_counter() - t0
                asm_t.value += asm_s
                up_t.value += up_s
                SCAN_ASSEMBLE_SECONDS.labels("arrow").observe(asm_s)
                SCAN_UPLOAD_SECONDS.labels("arrow").observe(up_s)
                uploader.hand_over(blob, event)
                rows.value += layout.n_rows
                yield GpuBatch(self._with_nested(
                    layout.columns(blob), rb, layout.capacity, ctx.device),
                    self._schema, layout.n_rows)
        finally:
            gen.close()
