"""Columnar file writes: device batches -> Parquet, ORC, CSV or Hive
text part files.

Counterpart of ``spark_rapids_tpu/io/write.py`` (``write_files``,
``_write_one``, ``_write_hive_text``, ``GpuFileWriteExec``; the
reference's ``GpuParquetFileFormat``/``ColumnarOutputWriter`` with
``GpuDataWritingCommandExec`` on top). Each batch is downloaded once,
its lazy selection applied by the download (``device_to_arrow``
compacts), and pyarrow encodes it on the host. ``partition_by`` writes
Hive-style ``key=value/part-*.parquet`` directories, Parquet only. The
exec yields no batch: the files are the result, listed in
``written_files``; the time from the first batch asked of the child to
the last file closed is its ``writeTime``. Parquet's codec is
``spark.sql.parquet.compression.codec``.
"""
from __future__ import annotations

import os
import time
import uuid
from typing import Iterator, List, Optional, Sequence

import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.dataset as pads

from ..columnar.arrow_bridge import arrow_schema, device_to_arrow
from ..config import PARQUET_COMPRESSION, RapidsConf
from ..exec.base import ExecCtx, GpuExec, OpContract, UnaryExec

__all__ = ["GpuFileWriteExec", "write_files"]

_FMT_EXT = {"parquet": "parquet", "orc": "orc", "csv": "csv",
            "hivetext": "txt"}
_MIN_GROUP_ROWS = 1 << 17


def _write_one(table: pa.Table, path: str, fmt: str, compression: str):
    if fmt == "parquet":
        import pyarrow.parquet as pq
        pq.write_table(table, path,
                       compression=None if compression == "none"
                       else compression)
    elif fmt == "orc":
        from pyarrow import orc
        orc.write_table(table, path)
    elif fmt == "csv":
        from pyarrow import csv
        csv.write_csv(table, path)
    elif fmt == "hivetext":
        _write_hive_text(table, path)
    else:
        raise ValueError(f"unknown write format {fmt!r}")


def _hive_text_column(col: pa.Array) -> pa.Array:
    """One column's fields as the serde writes them: a string's
    backslash, \\x01, \\n and \\r escaped, a boolean ``true`` or
    ``false``, a binary value in Base64, a number as its shortest text
    that reads back to it, anything else as ``str``; null as \\N."""
    import base64
    t = col.type
    if pa.types.is_boolean(t):
        out = pc.if_else(col, "true", "false")
    elif pa.types.is_string(t) or pa.types.is_large_string(t):
        out = col.cast(pa.string())
        for a, b in (("\\", "\\\\"), ("\x01", "\\\x01"),
                     ("\n", "\\n"), ("\r", "\\r")):
            out = pc.replace_substring(out, a, b)
    elif pa.types.is_integer(t) or pa.types.is_floating(t):
        out = col.cast(pa.string())
    elif pa.types.is_binary(t) or pa.types.is_large_binary(t):
        out = pa.array([None if v is None
                        else base64.b64encode(v).decode("ascii")
                        for v in col.to_pylist()], pa.string())
    else:
        out = pa.array([None if v is None else str(v)
                        for v in col.to_pylist()], pa.string())
    return out.fill_null("\\N")


def _write_hive_text(table: pa.Table, path: str):
    """Hive LazySimpleSerDe's text defaults: \\x01 between fields, \\N
    for null, \\n after a row, no header (``_hive_text_column``)."""
    table = table.combine_chunks()
    if table.num_columns:
        lines = pc.binary_join_element_wise(
            *[_hive_text_column(c.combine_chunks() if c.num_chunks
                                else pa.array([], c.type))
              for c in table.columns], "\x01").to_pylist()
    else:
        lines = [""] * table.num_rows
    with open(path, "w", encoding="utf-8") as f:
        f.write("".join(line + "\n" for line in lines))


def write_files(batches: Iterator[pa.RecordBatch], schema: pa.Schema,
                path: str, fmt: str = "parquet",
                partition_by: Optional[Sequence[str]] = None,
                compression: str = "snappy",
                rows_per_file: int = 1 << 22,
                task_id: str = "00000") -> List[str]:
    """Write host batches as part files under ``path`` (at most
    ``rows_per_file`` rows a file, at least one file); returns the files
    written."""
    os.makedirs(path, exist_ok=True)
    ext = _FMT_EXT[fmt]
    written: List[str] = []
    if partition_by:
        if fmt != "parquet":
            raise ValueError("partitioned writes support parquet only")
        table = pa.Table.from_batches(list(batches), schema=schema)
        fmt_obj = pads.ParquetFileFormat()
        opts = fmt_obj.make_write_options(
            compression=None if compression == "none" else compression)
        pads.write_dataset(
            table, path, format=fmt_obj, file_options=opts,
            partitioning=pads.partitioning(
                pa.schema([schema.field(c) for c in partition_by]),
                flavor="hive"),
            basename_template=f"part-{task_id}-{{i}}.{ext}",
            existing_data_behavior="overwrite_or_ignore",
            # a row group a partition's rows, up to the file's rows:
            # pyarrow's default flushes a group per incoming chunk
            min_rows_per_group=min(rows_per_file, _MIN_GROUP_ROWS),
            max_rows_per_group=rows_per_file)
        for root, _dirs, files in os.walk(path):
            written.extend(os.path.join(root, f) for f in files
                           if f.startswith(f"part-{task_id}-"))
        return sorted(written)
    pending: List[pa.RecordBatch] = []
    pending_rows = 0

    def flush():
        nonlocal pending, pending_rows
        table = pa.Table.from_batches(pending, schema=schema)
        f = os.path.join(path, f"part-{task_id}-{len(written):05d}.{ext}")
        _write_one(table, f, fmt, compression)
        written.append(f)
        pending, pending_rows = [], 0

    for rb in batches:
        pending.append(rb)
        pending_rows += rb.num_rows
        if pending_rows >= rows_per_file:
            flush()
    if pending or not written:
        flush()
    return written


class GpuFileWriteExec(UnaryExec):
    """Write the child's output to files (the GpuDataWritingCommandExec
    analog). It yields no batch; ``written_files`` lists the files, the
    same list on every copy the planner makes of the node."""

    CONTRACT = OpContract(
        schema_preserving=True,
        notes="a sink: downloads each batch once and writes it to files; "
              "yields no batch")

    def __init__(self, child: GpuExec, path: str, fmt: str = "parquet",
                 partition_by: Optional[Sequence[str]] = None,
                 conf: Optional[RapidsConf] = None):
        super().__init__(child)
        self.path = path
        self.fmt = fmt
        self.partition_by = list(partition_by) if partition_by else None
        self.compression = (conf or RapidsConf()).get(PARQUET_COMPRESSION)
        self.written_files: List[str] = []

    def describe(self):
        part = f" partitionBy={self.partition_by}" if self.partition_by \
            else ""
        return f"FileWriteExec [{self.fmt} -> {self.path}{part}]"

    def pretty_name(self):
        return "FileWriteExec"

    def gpu_supported(self) -> Optional[str]:
        if self.fmt not in _FMT_EXT:
            return f"write format {self.fmt} not supported"
        return None

    def _write(self, ctx: ExecCtx, batches) -> None:
        t = ctx.metric(self, "writeTime")
        t0 = time.perf_counter()
        self.written_files[:] = write_files(
            batches, arrow_schema(self.child.output_schema), self.path,
            self.fmt, self.partition_by, self.compression,
            task_id=uuid.uuid4().hex[:8])
        t.value += time.perf_counter() - t0

    def execute(self, ctx: ExecCtx):
        self._write(ctx, (device_to_arrow(b)
                          for b in self.child.execute(ctx)))
        return
        yield  # a generator that yields nothing

    def execute_cpu(self, ctx: ExecCtx):
        self._write(ctx, iter(self.child.execute_cpu(ctx)))
        return
        yield
