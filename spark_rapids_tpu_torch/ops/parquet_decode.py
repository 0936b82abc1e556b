"""K5: Parquet page decode on the device, and its plain PyTorch version.

Counterpart of ``spark_rapids_tpu/io/parquet_device.py:953-1046``
(``_expand`` and ``_decode_device``), the XLA program that expands a
column chunk's run table into values: RLE runs, bit-packed runs read
through a two-word funnel shift (with the 64-bit PLAIN case),
dictionary runs and the merged group's dictionary base in meta bits 16+,
DELTA prefix sums restarted at each page, and definition levels expanded
through a dense -> row gather.

- ``expand_runs_torch`` and ``decode_chunk_torch`` are the plain
  versions, line for line the reference's arithmetic. torch has no
  unsigned 64-bit shifts or compares on the CPU, so the uint64 lanes are
  int64 tensors holding the same bits: ``(hi << 32) | lo`` may come out
  negative, and an arithmetic ``>>`` then shifts in copies of bit 63,
  which the width mask clears as long as shift + width <= 64 (true for
  every width up to 32; 64-bit PLAIN values take their own branch).
- ``BatchLayout`` places one row-group batch in one byte blob: a table of
  column descriptors and scan jobs, each device column's encoded parts
  (packed words, run table, dictionary, definition words and runs), the
  host-decoded columns, then, past the part the host fills and uploads,
  the decoded output columns in ``GpuBatch`` layout and the scans'
  scratch.
- ``decode_batch`` is the wrapper: a blob on the CPU takes the plain
  version; a blob on a CUDA device launches ``csrc/parquet_decode.cu``
  once for every device column of the batch (``decode_batch.launches``
  counts those calls).
- A string column (BYTE_ARRAY) decodes, through the same K5 launch, to
  its index stream into the chunk's string store, which the blob stages
  beside the encoded parts (``:1183-1188``). ``BatchLayout.columns``
  then builds the column in torch as ``:1242-1265`` does: each row's
  length from the store's offsets, the offsets by a cumulative sum, and
  the chars copied from the store (``ops/strings.assemble_strings``)
  into the plan's host-known char capacity.
- ``decode_tiles_torch`` runs the kernel's decomposition in plain torch:
  tiles of ``TILE_ROWS`` rows, padding tiles, one 256-way search of the
  run table a tile, windows of at most ``RUN_WINDOW`` run records, and
  the staged span of packed words each window covers, read through its
  offsets. It computes what ``decode_batch_torch`` computes, so the CPU
  tests hold the kernel's tile walk to the reference.
"""
from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import datatypes as dt
from ..columnar.column import GpuColumnVector, is_string_like, torch_dtype
from .strings import assemble_strings

if TYPE_CHECKING:  # the io package imports this module
    from ..io.parquet_plan import ChunkPlan

__all__ = ["expand_runs_torch", "decode_chunk_torch", "BatchLayout",
           "decode_batch", "decode_batch_torch", "decode_tiles_torch",
           "SCAN_TILE", "TILE_ROWS", "RUN_WINDOW"]

_U32 = 0xFFFFFFFF
_ALIGN = 16
SCAN_TILE = 1024  # elements a block scans; the CUDA source's kScanThreads
TILE_ROWS = 4096  # rows a decode block takes; kTileRows
RUN_WINDOW = 128  # run records a window holds; kWindow
_WORD_PAD = 8     # staged words beyond a tile of 32-bit values; kWordCap
_NO_RUN = (1 << 63) - 1  # the start after the last run; kNoRun
_THREADS = 256    # threads a decode block; kThreads

# column descriptor and scan job, mirrors of K5Col and K5Job in the CUDA
# source; every offset is in bytes from the start of the blob, -1 = none
_COL = np.dtype([(f, "<i8") for f in (
    "words", "n_words", "runs", "n_runs", "dict", "n_dict", "def_words",
    "n_def_words", "def_runs", "n_def_runs", "out", "valid", "n_rows",
    "dense", "delta")] + [(f, "<i4") for f in (
        "lane_bytes", "out_bytes", "flags", "pad_")])
_JOB = np.dtype([(f, "<i8") for f in (
    "col", "kind", "n", "vals", "flags", "sums", "sflags", "n_blocks")])
_HAS_NULLS, _DELTA, _BOOL = 1, 2, 4
_JOB_VALID, _JOB_DELTA = 0, 1


# --- plain PyTorch versions --------------------------------------------------

def _mask_bits(width: torch.Tensor) -> torch.Tensor:
    """``(1 << width) - 1`` as int64 bits; all ones for width >= 64."""
    low = (torch.ones_like(width) << width.clamp(max=63)) - 1
    return torch.where(width >= 64, torch.full_like(width, -1), low)


def expand_runs_torch(words: torch.Tensor, tab: torch.Tensor,
                      idx: torch.Tensor, delta: bool = False) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """``_expand``: the run table ``tab`` (int64 ``[r, 4]``: dense start,
    meta, value, bit offset) over the packed ``words`` (int64 tensor of
    uint32 values) at dense positions ``idx``. Returns the raw uint64 bits
    (as int64) and an is-dictionary-index flag (0/1). With ``delta`` the
    bits are DELTA contributions, prefix-summed and restarted at every
    RLE run (each page's first value)."""
    starts = tab[:, 0].contiguous()
    rid = (torch.searchsorted(starts, idx, right=True) - 1).clamp(
        0, tab.shape[0] - 1)
    meta = tab[rid, 1]
    width = meta & 0xFF
    is_rle = ((meta >> 8) & 1) == 1
    is_dict = (meta >> 9) & 1
    is_ident = ((meta >> 10) & 1) == 1
    is_delta = ((meta >> 11) & 1) == 1
    off = idx - starts[rid]
    bitpos = tab[rid, 3] + off * width
    widx = (bitpos >> 5).clamp(0, words.shape[0] - 2)
    lo = words[widx]
    hi = words[widx + 1]
    sh = bitpos & 31
    window = (hi << 32) | lo
    bits = (window >> sh) & _mask_bits(width)
    # 64-bit PLAIN values sit on word pairs; a region that starts on an
    # odd word reads the next pair
    hi2 = words[(widx + 2).clamp(0, words.shape[0] - 1)]
    full64 = torch.where(sh == 0, window, (hi2 << 32) | hi)
    bits = torch.where(width >= 64, full64, bits)
    raw = tab[rid, 2]
    bits = torch.where(is_rle, raw, bits)
    bits = torch.where(is_ident, raw + off, bits)
    bits = torch.where(is_delta, bits + raw, bits)
    bits = bits + (meta >> 16)
    if delta:
        run_rle = ((tab[:, 1] >> 8) & 1) == 1
        page_start = torch.cummax(
            torch.where(run_rle, starts, torch.full_like(starts, -1)),
            0).values[rid]
        csum = torch.cumsum(bits, 0)
        before = csum[(page_start - 1).clamp(0, idx.shape[0] - 1)]
        bits = csum - torch.where(page_start > 0, before,
                                  torch.zeros_like(before))
    return bits, is_dict


def _low32(bits: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of int64 lanes as int32 (two's complement)."""
    low = bits & _U32
    return torch.where(low >= 1 << 31, low - (1 << 32), low).to(torch.int32)


def decode_chunk_torch(words: torch.Tensor, tab: torch.Tensor,
                       dict_arr: torch.Tensor, def_words: torch.Tensor,
                       def_tab: torch.Tensor, n_rows: int, cap: int,
                       delta: bool = False) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """``_decode_device``: ``(values[cap]`` in the dictionary's lane dtype,
    ``validity[cap])``; null and padding rows hold 0."""
    dev = words.device
    i = torch.arange(cap, dtype=torch.int64, device=dev)
    def_bits, _ = expand_runs_torch(def_words, def_tab, i)
    valid = ((def_bits & 1) != 0) & (i < n_rows)
    # dense index of each valid row into the value stream
    didx = torch.cumsum(valid.to(torch.int64), 0) - 1
    bits, is_dict = expand_runs_torch(words, tab, i, delta=delta)
    lane = dict_arr.dtype
    if lane == torch.bool:
        vals = (bits & 1) != 0
    elif dict_arr.element_size() == 8:
        vals = bits.view(lane)
    else:
        vals = _low32(bits).view(lane)
    k = _low32(bits).to(torch.int64).clamp(0, dict_arr.shape[0] - 1)
    vals = torch.where(is_dict == 1, dict_arr[k], vals)
    out = vals[didx.clamp(0, cap - 1)]
    out = torch.where(valid, out, torch.zeros((), dtype=lane, device=dev))
    return out, valid


# --- the blob ---------------------------------------------------------------

def _round_up(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _lane_bytes(plan: ChunkPlan) -> int:
    return np.dtype(plan.lane).itemsize


class BatchLayout:
    """One row-group batch in one byte blob.

    The prefix, which the host fills (``fill``) and copies to the device,
    holds the column descriptors, the scan jobs, every device column's
    encoded parts and the host-decoded columns (padded to ``capacity``).
    The suffix exists only on the device: the decoded columns (data, then
    a validity where the chunk has nulls) and the scans' scratch. A chunk
    with nulls needs a prefix count of its valid rows (its dense index)
    and a DELTA chunk a prefix sum of its deltas: each is a scan job.
    ``host`` maps a field to its host lanes ``(values, validity or
    None)``, or ``(offsets, chars, validity or None)`` for a string
    field; every other field must be in ``plans``. A string field in
    ``plans`` decodes to int32 indices into its store (offsets, then
    chars), staged in the prefix."""

    def __init__(self, schema: dt.Schema, capacity: int, n_rows: int,
                 plans: Dict[str, ChunkPlan],
                 host: Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]]):
        self.schema = schema
        self.capacity = capacity
        self.n_rows = n_rows
        self.plans = plans
        self.host = host
        self.device_names = [f.name for f in schema.fields
                             if f.name in plans]
        cap = capacity
        off = 0

        def take(nbytes: int) -> int:
            nonlocal off
            start = off
            off = _round_up(off + nbytes)
            return start

        n_dev = len(self.device_names)
        self.desc = np.zeros(n_dev, _COL)
        self.desc_off = take(self.desc.nbytes)
        jobs = []
        for j, name in enumerate(self.device_names):
            plan = plans[name]
            if plan.has_nulls:
                jobs.append((j, _JOB_VALID, plan.n_rows))
            if plan.is_delta and plan.n_valid:
                jobs.append((j, _JOB_DELTA, plan.n_valid))
        self.jobs = np.zeros(len(jobs), _JOB)
        self.jobs_off = take(self.jobs.nbytes)
        self._parts: List[Tuple[int, np.ndarray]] = []
        # a string column's store: (offsets at, entries + 1, chars at,
        # bytes, the decoded chars' capacity)
        self._str: Dict[str, Tuple[int, int, int, int, int]] = {}
        for j, name in enumerate(self.device_names):
            plan = plans[name]
            d = self.desc[j]
            # an empty dictionary (an all-null chunk) still gets the one
            # entry the clamped gather reads, as the reference's padding
            # gives it
            dictionary = plan.dictionary if plan.dictionary.shape[0] \
                else np.zeros(1, plan.lane)
            for key, arr in (("words", plan.packed), ("runs", plan.runs),
                             ("dict", dictionary),
                             ("def_words", plan.def_packed),
                             ("def_runs", plan.def_runs)):
                arr = np.ascontiguousarray(arr)
                d[key] = take(arr.nbytes)
                d["n_" + key] = arr.shape[0]
                self._parts.append((int(d[key]), arr))
            if plan.str_dict is not None:
                offs, chars = plan.str_dict
                self._str[name] = (take(offs.nbytes), offs.shape[0],
                                   take(chars.nbytes), chars.shape[0],
                                   plan.str_char_cap)
                self._parts.append((self._str[name][0], offs))
                self._parts.append((self._str[name][2], chars))
            d["n_rows"] = plan.n_rows
            d["lane_bytes"] = _lane_bytes(plan)
            d["flags"] = (_HAS_NULLS if plan.has_nulls else 0) \
                | (_DELTA if plan.is_delta else 0) \
                | (_BOOL if plan.lane == np.bool_ else 0)
        # host-decoded columns: data then validity, as GpuBatch holds them
        self._host_slots: Dict[str, Tuple] = {}
        for f in schema.fields:
            if f.name in plans:
                continue
            lanes = host[f.name]
            valid = lanes[-1]
            if is_string_like(f.dtype):
                offs, chars, _ = lanes
                char_cap = max(len(chars), 1)
                slot = (take((cap + 1) * 4), take(char_cap), char_cap)
            else:
                slot = (take(cap * f.dtype.np_dtype.itemsize),)
            self._host_slots[f.name] = slot + (
                None if valid is None else take(cap),)
        self.prefix_bytes = off
        # device-only suffix: decoded columns, then the scans' scratch
        for j, name in enumerate(self.device_names):
            d = self.desc[j]
            width = _lane_bytes(plans[name]) if name in self._str \
                else schema[name].dtype.np_dtype.itemsize
            d["out_bytes"] = width
            d["out"] = take(cap * width)
            d["valid"] = take(cap) if plans[name].has_nulls else -1
            d["dense"] = d["delta"] = -1
        self.max_job_n = 0
        for k, (col, kind, n) in enumerate(jobs):
            blocks = -(-n // SCAN_TILE)
            job = self.jobs[k]
            job["col"], job["kind"], job["n"] = col, kind, n
            job["n_blocks"] = blocks
            job["vals"] = take(8 * n)
            job["flags"] = take(n)
            job["sums"] = take(8 * blocks)
            job["sflags"] = take(blocks)
            self.desc[col]["dense" if kind == _JOB_VALID else "delta"] = \
                job["vals"]
            self.max_job_n = max(self.max_job_n, n)
        self.total_bytes = max(off, _ALIGN)

    def encoded_bytes(self) -> int:
        """Bytes of encoded parts the device decode reads."""
        return sum(arr.nbytes for _, arr in self._parts)

    def decoded_bytes(self) -> int:
        """Bytes of decoded live rows (the scan's ``decodedBytes``); a
        string column counts its offsets and its char capacity."""
        return int(sum(self.n_rows * d["out_bytes"]
                       + (self.n_rows if d["valid"] >= 0 else 0)
                       for d in self.desc)
                   + sum(4 * (self.n_rows + 1) + s[4]
                         for s in self._str.values()))

    def written_bytes(self) -> int:
        """Bytes the device decode writes: every device column up to the
        capacity (padding rows must hold 0), and its validity where the
        chunk has nulls."""
        return int(sum(self.capacity * (d["out_bytes"]
                                        + (1 if d["valid"] >= 0 else 0))
                       for d in self.desc))

    def fill(self, host: np.ndarray) -> None:
        """Write the prefix (``prefix_bytes`` of uint8) on the host."""
        host[self.desc_off:self.desc_off + self.desc.nbytes] = \
            self.desc.view(np.uint8)
        host[self.jobs_off:self.jobs_off + self.jobs.nbytes] = \
            self.jobs.view(np.uint8)
        for start, arr in self._parts:
            host[start:start + arr.nbytes] = arr.reshape(-1).view(np.uint8)
        cap = self.capacity
        for name, slot in self._host_slots.items():
            lanes = self.host[name]
            valid, valid_off = lanes[-1], slot[-1]
            if len(lanes) == 3:
                offs, chars, _ = lanes
                n = len(offs) - 1
                o = host[slot[0]:slot[0] + (cap + 1) * 4].view(np.int32)
                o[:n + 1] = offs
                o[n + 1:] = offs[-1]
                c = host[slot[1]:slot[1] + slot[2]]
                c[:len(chars)] = chars
                c[len(chars):] = 0
            else:
                values = lanes[0]
                np_t = self.schema[name].dtype.np_dtype
                n = len(values)
                data = host[slot[0]:slot[0] + cap * np_t.itemsize].view(np_t)
                data[:n] = values
                data[n:] = 0
            if valid_off is not None:
                v = host[valid_off:valid_off + cap].view(np.bool_)
                v[:n] = valid
                v[n:] = False

    def columns(self, blob: torch.Tensor) -> List[GpuColumnVector]:
        """Typed views of every field's column in the blob, in schema
        order."""
        cap = self.capacity
        slots = {name: (int(d["out"]), int(d["valid"]))
                 for name, d in zip(self.device_names, self.desc)}
        cols = []
        for f in self.schema.fields:
            if f.name in self._str:
                cols.append(self._string_column(blob, f, *slots[f.name]))
                continue
            if f.name in slots:
                data_off, valid_off = slots[f.name]
                valid_off = None if valid_off < 0 else valid_off
            elif is_string_like(f.dtype):
                o_off, c_off, char_cap, valid_off = self._host_slots[f.name]
                cols.append(GpuColumnVector(
                    f.dtype, None, None if valid_off is None else
                    blob[valid_off:valid_off + cap].view(torch.bool),
                    blob[o_off:o_off + (cap + 1) * 4].view(torch.int32),
                    blob[c_off:c_off + char_cap]))
                continue
            else:
                data_off, valid_off = self._host_slots[f.name]
            width = f.dtype.np_dtype.itemsize
            data = blob[data_off:data_off + cap * width].view(
                torch_dtype(f.dtype))
            validity = None if valid_off is None else \
                blob[valid_off:valid_off + cap].view(torch.bool)
            cols.append(GpuColumnVector(f.dtype, data, validity))
        return cols


    def out_dtype(self, name: str) -> torch.dtype:
        """The dtype K5 writes for a device column: the field's lane, or
        int32 store indices for a string column."""
        if name in self._str:
            return torch.int32
        return torch_dtype(self.schema[name].dtype)

    def _string_column(self, blob: torch.Tensor, f: dt.StructField,
                       out_off: int, valid_off: int) -> GpuColumnVector:
        """A decoded string column from its index stream and its staged
        store: the store's length of each valid row (null and padding
        rows 0), the offsets by a cumulative sum, the chars copied into
        the plan's char capacity. A store of no strings (fewer than two
        offsets: a chunk of no rows, or all null without a dictionary)
        gives every row start 0 and length 0."""
        cap = self.capacity
        so_off, so_n, sc_off, sc_n, char_cap = self._str[f.name]
        idx = blob[out_off:out_off + cap * 4].view(torch.int32)
        valid = None if valid_off < 0 else \
            blob[valid_off:valid_off + cap].view(torch.bool)
        if so_n < 2:
            starts = torch.zeros(cap, dtype=torch.int32, device=blob.device)
            lengths = starts
        else:
            store_offs = blob[so_off:so_off + so_n * 4].view(torch.int32)
            k = idx.long().clamp_(0, so_n - 2)
            starts = store_offs[k]
            lengths = store_offs[k + 1] - starts
        live = torch.arange(cap, device=blob.device) < self.n_rows
        if valid is not None:
            live = live & valid
        lengths = torch.where(live, lengths, torch.zeros_like(lengths))
        store = GpuColumnVector(f.dtype, None, None, None,
                                blob[sc_off:sc_off + sc_n])
        return assemble_strings(store, starts, lengths, valid, char_cap)


# --- the wrapper -------------------------------------------------------------

def _view(blob: torch.Tensor, off: int, n: int, dtype: torch.dtype) \
        -> torch.Tensor:
    size = torch.empty((), dtype=dtype).element_size()
    return blob[off:off + n * size].view(dtype)


def decode_batch_torch(blob: torch.Tensor, layout: BatchLayout) -> None:
    """``decode_batch``'s plain version: each device column decoded with
    ``decode_chunk_torch`` from its encoded parts in the blob into its
    output slot."""
    cap = layout.capacity
    for name, d in zip(layout.device_names, layout.desc):
        plan = layout.plans[name]
        lane = torch.from_numpy(np.empty(0, plan.lane)).dtype

        def words(key):
            return _view(blob, int(d[key]), int(d["n_" + key]),
                         torch.int32).to(torch.int64) & _U32

        def table(key):
            return _view(blob, int(d[key]), 4 * int(d["n_" + key]),
                         torch.int64).reshape(-1, 4)

        if lane == torch.bool:
            dict_arr = torch.zeros(1, dtype=torch.bool, device=blob.device)
        else:
            dict_arr = _view(blob, int(d["dict"]), int(d["n_dict"]), lane)
        vals, valid = decode_chunk_torch(
            words("words"), table("runs"), dict_arr, words("def_words"),
            table("def_runs"), int(d["n_rows"]), cap, delta=plan.is_delta)
        out_t = layout.out_dtype(name)
        _view(blob, int(d["out"]), cap, out_t).copy_(vals.to(out_t))
        if d["valid"] >= 0:
            _view(blob, int(d["valid"]), cap, torch.bool).copy_(valid)


# --- the kernel's decomposition in plain torch ------------------------------

def _first_run(starts: np.ndarray, lo: int) -> int:
    """The tile's one search of the run table, as the block makes it:
    256 probes a step narrow the count of starts at or before ``lo``.
    Returns the run holding ``lo`` (run 0 where no run starts at or
    before it)."""
    a, b = 0, starts.shape[0]
    probes = np.arange(1, _THREADS + 1, dtype=np.int64)
    while a < b:
        step = -(-(b - a) // _THREADS)
        q = a + probes * step - 1
        n = int(((q < b) & (starts[np.minimum(q, b - 1)] <= lo)).sum())
        a, b = a + n * step, min(b, a + (n + 1) * step - 1)
    return max(a - 1, 0)


def _word0(bitpos: torch.Tensor, n_words: int) -> torch.Tensor:
    """The first word the funnel shift reads, clamped as the reference's
    gather clamps (a table of one word reads that word twice)."""
    return (bitpos >> 5).clamp(0, max(n_words - 2, 0))


class _Window:
    """A block's window: the run records from ``wa`` that start at or
    before ``hi`` (at most ``RUN_WINDOW``, at least one), the packed
    words they cover over ``[lo, hi]``, staged as a slice where the span
    fits ``word_cap`` words, and each run's 32-bit form: ``fast`` where
    the caller needs only the low 32 bits of its values (``narrow``, or
    dictionary indices) and its words are staged and need none of the
    reference's clamps; ``c32`` the constant added to every value and
    ``relz`` the staged bit of ``d = lo``."""

    def __init__(self, tab: torch.Tensor, words: torch.Tensor, wa: int,
                 first: bool, lo: int, hi: int, word_cap: int,
                 narrow: bool):
        rec = tab[wa:wa + RUN_WINDOW]
        inside = rec[:, 0] <= hi
        inside[0] = True
        wn = int(inside.sum())
        self.wa, self.wn, self.lo = wa, wn, lo
        self.start, self.meta = rec[:wn, 0].contiguous(), rec[:wn, 1]
        self.raw, self.bit = rec[:wn, 2], rec[:wn, 3]
        self.next = int(tab[wa + wn, 0]) if wa + wn < tab.shape[0] \
            else _NO_RUN
        n_words = words.shape[0]
        nxt = torch.tensor([self.next], dtype=torch.int64)
        ends = torch.cat([self.start[1:], nxt])
        first_d = self.start.clamp(min=lo)
        if first:
            first_d[0] = lo
        last_d = torch.minimum(ends - 1, torch.tensor(hi))
        meta, width = self.meta, self.meta & 0xFF
        rle, ident = ((meta >> 8) & 1) == 1, ((meta >> 10) & 1) == 1
        packed = ~rle & ~ident & (width > 0)
        uses = packed & (first_d <= last_d)
        b0 = self.bit + (first_d - self.start) * width
        b1 = self.bit + (last_d - self.start) * width
        unclamped = ~uses | ((b0 >= 0) & ((b1 >> 5) <= n_words - 2))
        self.staged = False
        self.wbase = 0
        self.words = words
        if bool(uses.any()):
            w_lo = _word0(b0, n_words)[uses].min().item() & ~3
            w_hi = (_word0(b1, n_words) + torch.where(width >= 64, 2, 1)) \
                .clamp(max=n_words - 1)[uses].max().item()
            if w_hi - w_lo < word_cap:
                self.staged, self.wbase = True, w_lo
                self.words = words[w_lo:w_hi + 1].clone()
        is_dict = ((meta >> 9) & 1) == 1
        delta = ((meta >> 11) & 1) == 1
        self.fast = (is_dict | narrow) & ~delta & (~packed | (
            (width <= 32) & unclamped & self.staged))
        base = (meta >> 16) & _U32
        self.c32 = torch.where(rle, self.raw + base, torch.where(
            ident, self.raw - self.start + lo + base, base)) & _U32
        self.relz = self.bit + (lo - self.start) * width - 32 * self.wbase

    def _read(self, idx: torch.Tensor, need: torch.Tensor) -> torch.Tensor:
        """Words ``idx`` where ``need``, through the staged slice's
        offsets; a read outside the slice is a fault of the span."""
        at = idx - self.wbase
        bad = need & ((at < 0) | (at >= self.words.shape[0]))
        if bool(bad.any()):
            raise AssertionError("a word outside the staged span")
        return torch.where(need, self.words[at.clamp(
            0, self.words.shape[0] - 1)], torch.zeros_like(at))

    def expand(self, d: torch.Tensor, n_words: int):
        """``_expand`` at dense positions ``d`` that this window holds:
        ``(bits, is_dict, run_start, fast)``; a fast row's bits are the
        32-bit form's (the low 32 bits of the reference's)."""
        j = (torch.searchsorted(self.start, d, right=True) - 1).clamp(min=0)
        meta = self.meta[j]
        width = meta & 0xFF
        is_rle = ((meta >> 8) & 1) == 1
        is_ident = ((meta >> 10) & 1) == 1
        fast = self.fast[j]
        off = d - self.start[j]
        bitpos = self.bit[j] + off * width
        need = ~is_rle & ~is_ident & (width > 0)
        slow = need & ~fast
        i0 = _word0(bitpos, n_words)
        w0 = self._read(i0, slow)
        w1 = self._read((i0 + 1).clamp(max=n_words - 1), slow)
        w2 = self._read((i0 + 2).clamp(max=n_words - 1), slow & (width >= 64))
        sh = bitpos & 31
        # __funnelshift_r(w0, w1, sh) for widths up to 32, else the
        # 64-bit window (and the word pair at 64)
        funnel = ((w0 >> sh) | (w1 << (32 - sh))) & _U32
        window = (w1 << 32) | w0
        bits = torch.where(width <= 32, funnel, window >> sh) \
            & _mask_bits(width)
        bits = torch.where(width >= 64, torch.where(
            sh == 0, window, (w2 << 32) | w1), bits)
        bits = torch.where(need, bits, torch.zeros_like(bits))
        raw = self.raw[j]
        bits = torch.where(is_rle, raw, bits)
        bits = torch.where(is_ident, raw + off, bits)
        bits = torch.where(((meta >> 11) & 1) == 1, bits + raw, bits)
        bits = bits + (meta >> 16)
        # the 32-bit form: the run's constant, plus the offset (identity)
        # or one funnel shift of two staged words at a 32-bit bit offset
        dl = d - self.lo
        r = self.relz[j] + dl * width
        packed = need & fast
        f0 = self._read((r >> 5) + self.wbase, packed)
        f1 = self._read((r >> 5) + 1 + self.wbase, packed)
        sh32 = r & 31
        fun32 = ((f0 >> sh32) | (f1 << (32 - sh32))) & _U32 & _mask_bits(width)
        v32 = self.c32[j] + torch.where(is_ident, dl, torch.zeros_like(dl)) \
            + torch.where(packed, fun32, torch.zeros_like(fun32))
        bits = torch.where(fast, v32 & _U32, bits)
        return bits, ((meta >> 9) & 1) == 1, is_rle & (off == 0), fast


def _expand_tile(tab: torch.Tensor, words: torch.Tensor, d: torch.Tensor,
                 lo: int, hi: int, word_cap: int, narrow: bool,
                 stats: Dict[str, int]):
    """One tile's expansion at increasing dense positions ``d`` in
    ``[lo, hi]``: the search, then window after window until every
    position is decoded."""
    stats["searches"] += 1
    wa, first = _first_run(tab[:, 0].numpy(), lo), True
    bits = torch.zeros_like(d)
    is_dict = torch.zeros(d.shape, dtype=torch.bool)
    run_start = torch.zeros(d.shape, dtype=torch.bool)
    pending = torch.ones(d.shape, dtype=torch.bool)
    while True:
        w = _Window(tab, words, wa, first, lo, hi, word_cap, narrow)
        stats["windows"] += 1
        stats["staged" if w.staged else "unstaged"] += 1
        take = pending & (d < w.next)
        b, k, r, fast = w.expand(d[take], words.shape[0])
        bits[take], is_dict[take], run_start[take] = b, k, r
        stats["fast_rows"] += int(fast.sum())
        stats["rows"] += int(take.sum())
        pending &= ~take
        if not bool(pending.any()):
            return bits, is_dict, run_start
        wa, first = wa + w.wn, False


def _expand_tiles(tab, words, n: int, tile_rows: int, word_cap: int,
                  narrow: bool, stats) -> Tuple[torch.Tensor, torch.Tensor]:
    """``k5_scan_fill``: the table expanded at 0..n-1, a tile at a time:
    ``(bits, run_start)``."""
    bits = torch.zeros(n, dtype=torch.int64)
    run_start = torch.zeros(n, dtype=torch.bool)
    for t0 in range(0, n, tile_rows):
        t1 = min(t0 + tile_rows, n)
        d = torch.arange(t0, t1, dtype=torch.int64)
        b, _, r = _expand_tile(tab, words, d, t0, t1 - 1, word_cap, narrow,
                               stats)
        bits[t0:t1], run_start[t0:t1] = b, r
    return bits, run_start


def _segmented_sum(vals: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """The inclusive scan restarted at every flagged element (uint64
    wrapping, as int64 bits)."""
    csum = torch.cumsum(vals, 0)
    pos = torch.arange(vals.shape[0])
    seg = torch.cummax(torch.where(flags, pos, torch.full_like(pos, -1)),
                       0).values
    before = csum[(seg - 1).clamp(min=0)]
    return csum - torch.where(seg > 0, before, torch.zeros_like(before))


def decode_tiles_torch(blob: torch.Tensor, layout: BatchLayout,
                       tile_rows: int = TILE_ROWS) -> Dict[str, int]:
    """K5's decomposition in plain torch, on a blob on the CPU: each
    device column decoded tile by tile into its slot, as the kernel
    walks it (see the CUDA source's header). Returns counts of the walk:
    tiles, padding tiles, searches, windows, windows whose words were
    staged or not (read from the table, or none needed), and expanded
    rows, all and in the 32-bit form."""
    stats = dict.fromkeys(("tiles", "padding_tiles", "searches", "windows",
                           "staged", "unstaged", "rows", "fast_rows"), 0)
    cap = layout.capacity
    word_cap = tile_rows + _WORD_PAD
    for name, d in zip(layout.device_names, layout.desc):
        plan = layout.plans[name]
        lane = torch.from_numpy(np.empty(0, plan.lane)).dtype
        n_rows = int(d["n_rows"])

        def words(key):
            return _view(blob, int(d[key]), int(d["n_" + key]),
                         torch.int32).to(torch.int64) & _U32

        def table(key):
            return _view(blob, int(d[key]), 4 * int(d["n_" + key]),
                         torch.int64).reshape(-1, 4)

        if lane == torch.bool:
            dict_arr = torch.zeros(1, dtype=torch.bool)
        else:
            dict_arr = _view(blob, int(d["dict"]), int(d["n_dict"]), lane)
        tab, vwords = table("runs"), words("words")
        dense = deltas = None
        if plan.has_nulls:  # scan job 0: valid rows through each row
            bits, _ = _expand_tiles(table("def_runs"), words("def_words"),
                                    n_rows, tile_rows, word_cap, True, stats)
            dense = torch.cumsum(bits & 1, 0)
        if plan.is_delta and plan.n_valid:  # scan job 1
            bits, starts = _expand_tiles(tab, vwords, plan.n_valid,
                                         tile_rows, word_cap, False, stats)
            deltas = _segmented_sum(bits, starts)
        out_t = layout.out_dtype(name)
        out = _view(blob, int(d["out"]), cap, out_t)
        vout = _view(blob, int(d["valid"]), cap, torch.bool) \
            if d["valid"] >= 0 else None
        for t0 in range(0, cap, tile_rows):
            t1 = min(t0 + tile_rows, cap)
            stats["tiles"] += 1
            out[t0:t1] = 0
            if vout is not None:
                vout[t0:t1] = False
            if t0 >= n_rows:
                stats["padding_tiles"] += 1
                continue
            live = torch.arange(t0, min(t1, n_rows), dtype=torch.int64)
            if dense is None:
                valid = torch.ones(live.shape, dtype=torch.bool)
                dpos, lo, hi = live, t0, int(live[-1])
            else:
                prev = torch.cat([dense[:1] * 0, dense])[live]
                valid = dense[live] != prev
                dpos = dense[live] - 1
                lo = int(prev[0])
                hi = int(dense[live[-1]]) - 1
            dpos = dpos[valid]
            if deltas is not None:
                bits = deltas[dpos]
                is_dict = torch.zeros(dpos.shape, dtype=torch.bool)
            elif hi >= lo and tab.shape[0]:
                bits, is_dict, _ = _expand_tile(
                    tab, vwords, dpos, lo, hi, word_cap,
                    np.dtype(plan.lane).itemsize <= 4, stats)
            else:
                bits = torch.zeros_like(dpos)
                is_dict = torch.zeros(dpos.shape, dtype=torch.bool)
            if lane == torch.bool:
                vals = (bits & 1) != 0
            elif dict_arr.element_size() == 8:
                vals = bits.view(lane)
            else:
                vals = _low32(bits).view(lane)
            k = _low32(bits).to(torch.int64).clamp(0, dict_arr.shape[0] - 1)
            vals = torch.where(is_dict, dict_arr[k], vals)
            rows = live[valid]
            out[rows] = vals.to(out_t)
            if vout is not None:
                vout[rows] = True
    return stats


def _library():
    from ._build import load
    lib = load("parquet_decode")
    if not getattr(lib, "_spark_ready", False):
        for fn in (lib.spark_k5_col_size, lib.spark_k5_job_size,
                   lib.spark_k5_scan_tile, lib.spark_k5_tile_rows):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        lib.spark_k5_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        lib.spark_k5_decode.restype = ctypes.c_int
        if (lib.spark_k5_col_size(), lib.spark_k5_job_size(),
                lib.spark_k5_scan_tile(), lib.spark_k5_tile_rows()) != (
                    _COL.itemsize, _JOB.itemsize, SCAN_TILE, TILE_ROWS):
            raise RuntimeError(
                "K5Col/K5Job or the tiles in the CUDA source do not match "
                f"the layout: {lib.spark_k5_col_size()}/"
                f"{lib.spark_k5_job_size()} bytes, tiles of "
                f"{lib.spark_k5_tile_rows()} rows against {_COL.itemsize}/"
                f"{_JOB.itemsize}, {TILE_ROWS}")
        lib._spark_ready = True
    return lib


def decode_batch(blob: torch.Tensor, layout: BatchLayout) \
        -> List[GpuColumnVector]:
    """Decode every device column of the batch into its slot of the blob
    and return all the batch's columns. A blob on the CPU takes the plain
    version; on a CUDA device it launches K5 on the current stream."""
    if blob.dtype != torch.uint8 or blob.dim() != 1 \
            or blob.shape[0] < layout.total_bytes:
        raise ValueError(f"the blob must be a 1-D uint8 tensor of at least "
                         f"{layout.total_bytes} bytes")
    if layout.device_names:
        if blob.device.type == "cpu":
            decode_batch_torch(blob, layout)
        elif blob.device.type == "cuda":
            if blob.data_ptr() % _ALIGN or layout.capacity % 4:
                raise ValueError("the blob must be 16-byte aligned and the "
                                 "capacity a multiple of 4")
            lib = _library()
            stream = torch.cuda.current_stream(blob.device).cuda_stream
            err = lib.spark_k5_decode(
                blob.data_ptr(), layout.desc_off, len(layout.device_names),
                layout.jobs_off, len(layout.jobs), layout.capacity,
                layout.max_job_n, stream)
            if err != 0:
                raise RuntimeError(f"parquet_decode kernel launch failed: "
                                   f"cudaError {err}")
            decode_batch.launches += 1
        else:
            raise ValueError(f"unsupported device {blob.device}")
    return layout.columns(blob)


decode_batch.launches = 0
