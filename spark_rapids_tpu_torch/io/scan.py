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
split order, cast to its schema, and touches no device. Column pruning,
row-group pushdown, Hive partition columns and the
ORC/CSV/JSON/Hive-text formats wait (ROADMAP items 5 and 12).
"""
from __future__ import annotations

import concurrent.futures
import decimal
import os
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import torch

from .. import datatypes as dt
from ..columnar.arrow_bridge import (arrow_schema, column_to_device,
                                     engine_schema, host_lanes,
                                     string_parts)
from ..columnar.batch import GpuBatch, bucket_rows
from ..columnar.column import GpuColumnVector, is_string_like, torch_dtype
from ..config import (MAX_PARTITION_BYTES, PARQUET_DEVICE_DECODE,
                      PARQUET_MULTITHREADED_THREADS, PARQUET_READER_TYPE,
                      SCAN_COALESCE_TARGET_BYTES, SCAN_INFLIGHT_BATCHES,
                      SCAN_PREFETCH_BATCHES, SCAN_STAGE_FUSION,
                      SCAN_UPLOAD_THREADS)
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


def plan_splits(paths: Sequence[str],
                max_partition_bytes: int) -> List[FileSplit]:
    """Row-group-aligned split planning for Parquet."""
    splits: List[FileSplit] = []
    for path in paths:
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


def _decode_split(split: FileSplit,
                  batch_rows: int) -> List[pa.RecordBatch]:
    """Host decode of one split into RecordBatches of at most
    ``batch_rows`` rows."""
    f = pq.ParquetFile(split.path)
    groups = split.row_groups
    if groups is None:
        groups = list(range(f.metadata.num_row_groups))
    if not groups:
        return []
    return [rb for rb in f.iter_batches(batch_size=batch_rows,
                                        row_groups=groups) if rb.num_rows]


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
    """Leaf scan over Parquet files (the GpuBatchScanExec analog)."""

    def __init__(self, paths: Sequence[str],
                 schema: Optional[dt.Schema] = None):
        super().__init__()
        if isinstance(paths, str):
            paths = [paths]
        if not paths:
            raise ValueError("scan needs at least one file")
        self.paths = list(paths)
        if schema is None:
            schema = engine_schema(pq.ParquetFile(self.paths[0]).schema_arrow)
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
        return f"FileScanExec [parquet x{len(self.paths)}]"

    def pretty_name(self):
        return "FileScanExec"

    def _host_batches(self, ctx: ExecCtx) -> Iterator[pa.RecordBatch]:
        """Decoded host batches in split order, per the reader mode."""
        conf = ctx.conf
        mode = conf.get(PARQUET_READER_TYPE)
        batch_rows = conf.batch_size_rows
        splits = plan_splits(self.paths, conf.get(MAX_PARTITION_BYTES))
        if mode == "PERFILE" or len(splits) <= 1:
            for s in splits:
                yield from _decode_split(s, batch_rows)
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
                    futures.put(pool.submit(_decode_split, s, batch_rows))
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
        return (conf.get(PARQUET_DEVICE_DECODE)
                and conf.get(PARQUET_READER_TYPE) != "COALESCING")

    def _device_rg_tasks(self, conf) -> List[Tuple[str, int]]:
        """(path, row group) work list, in split order."""
        return [(s.path, g) for s in plan_splits(
            self.paths, conf.get(MAX_PARTITION_BYTES)) for g in s.row_groups]

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
