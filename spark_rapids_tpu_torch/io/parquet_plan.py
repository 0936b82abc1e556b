"""Host half of device page decode: plan Parquet column chunks for K5.

Counterpart of ``spark_rapids_tpu/io/parquet_device.py:75-949``, the
port's own copy in numpy and Python (it imports nothing of the JAX
package): ``FALLBACK_REASONS`` and ``HostFallback``; the Thrift compact
reader and ``parse_page_header``; the RLE/bit-packed run-header walk
(``_parse_runs``) and ``_popcount_valid``; ``ChunkPlan`` and
``_decompress``; the DELTA_BINARY_PACKED and BYTE_ARRAY planning;
``plan_chunk``, ``encoded_nbytes`` and ``merge_chunk_plans``.

The host reads a chunk's bytes, decompresses its pages and walks only the
run headers into a run table ``int64[n_runs, 4]`` of (dense row start,
meta, value, bit offset); the payload bytes stay opaque and cross to the
device as uint32 words. The device half is ``ops/parquet_decode.py``
(plain PyTorch) and ``csrc/parquet_decode.cu`` (K5). Anything outside the
envelope raises ``HostFallback`` with a bounded reason and the scan
decodes that chunk with pyarrow. A BYTE_ARRAY chunk's plan decodes to
its index stream into a string store (``ChunkPlan.str_dict``) that the
scan stages beside it; the scan builds the string column from both.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

from .. import datatypes as dt
from ..columnar.batch import bucket_bytes, bucket_rows

__all__ = ["plan_chunk", "merge_chunk_plans", "ChunkPlan", "HostFallback",
           "encoded_nbytes", "parse_page_header", "FALLBACK_REASONS",
           "STR_EXPANSION_CAP"]


# string-expansion device cap shared by plan_chunk's per-chunk guard and
# the coalescer's merge precheck (io/scan.py)
STR_EXPANSION_CAP = 1 << 26


#: Bounded label set for the per-reason fallback histogram (obs metric
#: labels must not explode; free-form messages stay on the exception).
FALLBACK_REASONS = ("phys-type", "nested", "def-depth", "codec",
                    "encoding", "dict-width", "delta-width", "page",
                    "truncated", "size-guard", "string-cap", "other")


class HostFallback(Exception):
    """This column chunk is outside the device-decode envelope; the scan
    decodes it with pyarrow instead (per-chunk granularity). ``reason``
    is one of :data:`FALLBACK_REASONS` — the bounded slug the scan's
    fallback histogram is labeled with."""

    def __init__(self, msg: str, reason: str = "other"):
        super().__init__(msg)
        self.reason = reason if reason in FALLBACK_REASONS else "other"


# --- Thrift compact protocol (just enough for PageHeader) ------------------

_CT_STOP, _CT_TRUE, _CT_FALSE, _CT_BYTE, _CT_I16, _CT_I32, _CT_I64, \
    _CT_DOUBLE, _CT_BINARY, _CT_LIST, _CT_SET, _CT_MAP, _CT_STRUCT = \
    range(13)


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _zigzag(buf: bytes, pos: int) -> Tuple[int, int]:
    v, pos = _varint(buf, pos)
    return (v >> 1) ^ -(v & 1), pos


def _skip(buf: bytes, pos: int, ctype: int) -> int:
    if ctype in (_CT_TRUE, _CT_FALSE):
        return pos
    if ctype == _CT_BYTE:
        return pos + 1
    if ctype in (_CT_I16, _CT_I32, _CT_I64):
        return _varint(buf, pos)[1]
    if ctype == _CT_DOUBLE:
        return pos + 8
    if ctype == _CT_BINARY:
        n, pos = _varint(buf, pos)
        return pos + n
    if ctype in (_CT_LIST, _CT_SET):
        head = buf[pos]
        pos += 1
        size = head >> 4
        if size == 15:
            size, pos = _varint(buf, pos)
        for _ in range(size):
            pos = _skip(buf, pos, head & 0x0F)
        return pos
    if ctype == _CT_MAP:
        size, pos = _varint(buf, pos)
        if size == 0:
            return pos
        kv = buf[pos]
        pos += 1
        for _ in range(size):
            pos = _skip(buf, pos, kv >> 4)
            pos = _skip(buf, pos, kv & 0x0F)
        return pos
    if ctype == _CT_STRUCT:
        fid = 0
        while True:
            head = buf[pos]
            pos += 1
            if head == 0:
                return pos
            delta = head >> 4
            if delta == 0:
                fid, pos = _zigzag(buf, pos)
            else:
                fid += delta
            pos = _skip(buf, pos, head & 0x0F)
    raise HostFallback(f"unknown thrift type {ctype}", "page")


def _read_struct(buf: bytes, pos: int) -> Tuple[Dict[int, object], int]:
    """Field-id → value for i32/i64/bool fields; nested structs recurse;
    everything else (statistics blobs etc.) is skipped."""
    out: Dict[int, object] = {}
    fid = 0
    while True:
        head = buf[pos]
        pos += 1
        if head == 0:
            return out, pos
        delta = head >> 4
        if delta == 0:
            fid, pos = _zigzag(buf, pos)
        else:
            fid += delta
        ctype = head & 0x0F
        if ctype in (_CT_TRUE, _CT_FALSE):
            out[fid] = ctype == _CT_TRUE
        elif ctype in (_CT_I16, _CT_I32, _CT_I64):
            out[fid], pos = _zigzag(buf, pos)
        elif ctype == _CT_STRUCT:
            out[fid], pos = _read_struct(buf, pos)
        else:
            pos = _skip(buf, pos, ctype)


# PageType / Encoding enum values from parquet.thrift (public format spec)
_PAGE_DATA, _PAGE_INDEX, _PAGE_DICT, _PAGE_DATA_V2 = 0, 1, 2, 3
_ENC_PLAIN, _ENC_PLAIN_DICT, _ENC_RLE, _ENC_RLE_DICT = 0, 2, 3, 8
_ENC_DELTA_BINARY_PACKED, _ENC_DELTA_LENGTH_BA, _ENC_DELTA_BA = 5, 6, 7

# Run-table meta bits (column 1 of the int64[n_runs, 4] run table).
# Bits 0-7 hold the bit-packed width; bits 16+ hold the merged-group
# index base merge_chunk_plans adds for dictionary/string runs.
_META_RLE = 1 << 8      # constant run: value rides in column 2
_META_DICT = 1 << 9     # expanded value is a dictionary index
_META_IDENT = 1 << 10   # value_i = col2 + (i - row_start): the identity
                        # index stream PLAIN / DELTA_LENGTH strings use
_META_DELTA = 1 << 11   # bit-packed DELTA miniblock: col2 = min_delta,
                        # the device prefix-sums the expanded deltas


def parse_page_header(buf: bytes, pos: int):
    """(dict with keys: type, uncompressed, compressed, data_hdr|dict_hdr,
    header_len)."""
    fields, end = _read_struct(buf, pos)
    return {
        "type": fields.get(1),
        "uncompressed": fields.get(2),
        "compressed": fields.get(3),
        "data_hdr": fields.get(5),
        "dict_hdr": fields.get(7),
        "v2_hdr": fields.get(8),
        "header_len": end - pos,
    }


# --- RLE / bit-packed hybrid run parsing (headers only) --------------------

def _parse_runs(data: bytes, start: int, end: int, width: int,
                total: int, packed_base_bits: int):
    """Walk the RLE/bit-packed hybrid stream's run headers. Returns
    (runs, stream_end): runs = list of (value_row_start, is_rle, value,
    bit_start) where bit_start is relative to `packed_base_bits` +
    (offset within data[start:end])*8 — i.e. positions in the packed
    buffer the caller appends data[start:end] to. Payload bytes are
    never touched here."""
    runs = []
    count = 0
    pos = start
    byte_w = (width + 7) // 8
    while count < total:
        if pos >= end:
            raise HostFallback("RLE stream truncated", "truncated")
        header, pos = _varint(data, pos)
        if header & 1:  # bit-packed: groups of 8 values
            groups = header >> 1
            runs.append((count, False, 0,
                         packed_base_bits + (pos - start) * 8))
            pos += groups * width
            count += groups * 8
        else:
            repeat = header >> 1
            if repeat == 0:
                raise HostFallback("zero-length RLE run", "truncated")
            value = int.from_bytes(data[pos:pos + byte_w], "little")
            pos += byte_w
            runs.append((count, True, value, 0))
            count += repeat
    return runs, pos


def _popcount_valid(def_runs, packed: bytes, base_bits: int,
                    n_rows: int) -> int:
    """Number of set definition-level bits (width 1) among the first
    n_rows — host-side, numpy unpackbits over the tiny level buffer."""
    total = 0
    for i, (row0, is_rle, value, bit_start) in enumerate(def_runs):
        row1 = def_runs[i + 1][0] if i + 1 < len(def_runs) else n_rows
        row1 = min(row1, n_rows)
        if row1 <= row0:
            continue
        n = row1 - row0
        if is_rle:
            total += n * (value & 1)
        else:
            b0 = (bit_start - base_bits) // 8
            nbytes = (n + 7) // 8
            bits = np.unpackbits(
                np.frombuffer(packed, np.uint8, count=nbytes, offset=b0),
                bitorder="little")[:n]
            total += int(bits.sum())
    return total


# --- chunk planning --------------------------------------------------------

_PHYS_LANE = {"INT32": np.dtype(np.int32), "INT64": np.dtype(np.int64),
              "FLOAT": np.dtype(np.float32), "DOUBLE": np.dtype(np.float64),
              "BOOLEAN": np.dtype(np.bool_)}
_SUPPORTED_CODECS = {"UNCOMPRESSED", "SNAPPY", "ZSTD", "GZIP", "BROTLI"}
_MAX_DICT_WIDTH = 24  # funnel-shift window bound: shift(<=31) + width <= 55


class ChunkPlan:
    """Host-side product of planning one column chunk for device decode:
    numpy arrays ready for upload + the static facts the kernel needs.
    For STRING chunks (BYTE_ARRAY), `lane` is int32 (the index stream),
    `dictionary` is None and `str_dict` holds the host-side string
    store (offsets int32[n+1], chars uint8[...]) — dictionary-page
    entries first, then any PLAIN / DELTA_LENGTH page values in page
    order; dictionary runs index the dict slice, identity runs index
    their page's slice, and the device gathers the characters in HBM
    either way. `is_delta` marks DELTA_BINARY_PACKED numeric chunks
    whose values the device reconstructs by prefix sum; `str_bound` is
    the chunk's worst-case decoded character count (the string output
    buffer currency — merge sums it)."""

    __slots__ = ("n_rows", "lane", "dictionary", "packed", "runs",
                 "def_packed", "def_runs", "n_valid", "has_nulls",
                 "encoded_bytes", "str_dict", "str_char_cap",
                 "str_max_len", "is_delta", "str_bound")

    def __init__(self, n_rows, lane, dictionary, packed, runs, def_packed,
                 def_runs, n_valid, encoded_bytes, str_dict=None,
                 str_char_cap=0, str_max_len=0, is_delta=False,
                 str_bound=0):
        self.n_rows = n_rows
        self.lane = lane
        self.dictionary = dictionary
        self.packed = packed
        self.runs = runs              # int64[n_runs, 4]: row, flags, val, bit
        self.def_packed = def_packed
        self.def_runs = def_runs
        self.n_valid = n_valid
        self.has_nulls = n_valid < n_rows
        self.encoded_bytes = encoded_bytes
        self.str_dict = str_dict      # (offsets, chars) or None
        self.str_char_cap = str_char_cap
        self.str_max_len = str_max_len  # longest store string
        self.is_delta = is_delta
        self.str_bound = str_bound


def _decompress(codec: str, payload: bytes, uncompressed: int) -> bytes:
    if codec == "UNCOMPRESSED":
        return payload
    return pa.Codec(codec.lower()).decompress(
        payload, decompressed_size=uncompressed).to_pybytes()


def _align8(parts: List[bytes]) -> int:
    """Pad the packed accumulator to an 8-byte boundary (keeps PLAIN
    32/64-bit regions word-aligned for the 2-gather extraction) and
    return the new base offset in bytes."""
    total = sum(len(p) for p in parts)
    pad = (-total) % 8
    if pad:
        parts.append(b"\x00" * pad)
    return total + pad


# --- host-side helpers for the widened envelope ----------------------------

def _walk_plain_byte_array(data: bytes, off: int, count: int):
    """PLAIN BYTE_ARRAY page body -> (lengths int64[count], contiguous
    character bytes). The 4-byte little-endian length prefixes chain
    sequentially, so the host walks them once — ONE int read + list
    append per value, the only inherently serial work; everything else
    (start positions, the ragged character gather) derives vectorized."""
    lens_list = []
    pos = off
    end = len(data)
    for _ in range(count):
        if pos + 4 > end:
            raise HostFallback("PLAIN byte-array page truncated",
                               "truncated")
        ln = int.from_bytes(data[pos:pos + 4], "little")
        lens_list.append(ln)
        pos += 4 + ln
    if pos > end:
        raise HostFallback("PLAIN byte-array page truncated", "truncated")
    lens = np.asarray(lens_list, np.int64) if lens_list \
        else np.zeros(0, np.int64)
    total = int(lens.sum())
    if total == 0:
        return lens, b""
    # value i's data starts after i+1 length prefixes and the i
    # preceding values' characters
    arr = np.frombuffer(data, np.uint8)
    starts = off + 4 * np.arange(1, count + 1, dtype=np.int64)
    starts[1:] += np.cumsum(lens[:-1])
    out_off = np.concatenate([np.zeros(1, np.int64), np.cumsum(lens)])
    idx = np.repeat(starts - out_off[:-1], lens) \
        + np.arange(total, dtype=np.int64)
    return lens, arr[idx].tobytes()


def _delta_header(data: bytes, pos: int):
    """<block_size><miniblocks/block><total_count><first_value> — the
    DELTA_BINARY_PACKED stream preamble."""
    block_size, pos = _varint(data, pos)
    mb_per_block, pos = _varint(data, pos)
    total, pos = _varint(data, pos)
    first, pos = _zigzag(data, pos)
    if block_size <= 0 or mb_per_block <= 0 \
            or block_size % mb_per_block \
            or (block_size // mb_per_block) % 32:
        # the spec fixes values-per-miniblock at a multiple of 32; a
        # header violating it would make `cpm * w // 8` floor and
        # desynchronize every subsequent miniblock read into silently
        # wrong values
        raise HostFallback(
            f"malformed delta header ({block_size}/{mb_per_block})",
            "truncated")
    return block_size, mb_per_block, total, first, pos


def _delta_miniblocks(data: bytes, pos: int, mb: int, cpm: int,
                      total: int):
    """The ONE miniblock walk both delta consumers share: yields
    (min_delta, width, payload_byte_pos, take) per USED miniblock of a
    DELTA_BINARY_PACKED stream and returns them with the end position.
    All truncation / width-bound classification lives here so the
    numeric-chunk planner and the DELTA_LENGTH lengths decoder can
    never drift apart."""
    out = []
    remaining = total - 1
    while remaining > 0:
        if pos >= len(data):
            raise HostFallback("delta stream truncated", "truncated")
        min_d, pos = _zigzag(data, pos)
        if pos + mb > len(data):
            raise HostFallback("delta stream truncated", "truncated")
        widths = data[pos:pos + mb]
        pos += mb
        for w in widths:
            if remaining <= 0:
                break
            if w > 32:
                # funnel-shift window bound: shift(<=31) + width <= 63
                raise HostFallback(f"delta miniblock width {w}",
                                   "delta-width")
            nbytes = cpm * w // 8
            if pos + nbytes > len(data):
                raise HostFallback("delta stream truncated", "truncated")
            take = min(cpm, remaining)
            out.append((min_d, w, pos, take))
            pos += nbytes
            remaining -= take
    return out, pos


def _plan_delta_page(data: bytes, off: int, total_expected: int):
    """Walk one DELTA_BINARY_PACKED page's miniblock headers WITHOUT
    touching the packed delta payload: returns (first_value,
    [(value_start, width, min_delta, bit_off)], end_pos) where bit_off
    is relative to ``off`` — the caller appends data[off:end] to the
    packed accumulator and shifts. The device expands each miniblock
    like any bit-packed run, adds its min_delta, and prefix-sums."""
    bs, mb, total, first, pos = _delta_header(data, off)
    if total != total_expected:
        raise HostFallback(
            f"delta page count {total} != page values {total_expected}",
            "truncated")
    cpm = bs // mb  # values per miniblock (spec: multiple of 32)
    blocks, pos = _delta_miniblocks(data, pos, mb, cpm, total)
    mbs = []
    vstart = 1
    for min_d, w, bpos, take in blocks:
        mbs.append((vstart, w, min_d, (bpos - off) * 8))
        vstart += take
    return first, mbs, pos


def _decode_delta_ints(data: bytes, off: int):
    """Fully host-decode a DELTA_BINARY_PACKED int stream (the lengths
    preamble of DELTA_LENGTH_BYTE_ARRAY — the lengths gate where the
    character bytes start, so the host needs the actual values):
    returns (int64 values, end_pos). numpy unpackbits per miniblock —
    no per-value python loop."""
    bs, mb, total, first, pos = _delta_header(data, off)
    out = np.zeros(max(total, 1), np.int64)
    out[0] = first
    cpm = bs // mb
    blocks, pos = _delta_miniblocks(data, pos, mb, cpm, total)
    filled = 1
    for min_d, w, bpos, take in blocks:
        if w:
            bits = np.unpackbits(
                np.frombuffer(data, np.uint8, count=cpm * w // 8,
                              offset=bpos),
                bitorder="little")
            vals = bits.reshape(cpm, w).astype(np.int64)
            vals = (vals << np.arange(w, dtype=np.int64)).sum(1)
        else:
            vals = np.zeros(cpm, np.int64)
        out[filled:filled + take] = vals[:take] + min_d
        filled += take
    np.cumsum(out[:total], out=out[:total])
    return out[:total], pos


def plan_chunk(f, col_md, descriptor, engine_dtype: dt.DataType,
               arrow_field_type) -> ChunkPlan:
    """Plan one column chunk (one row group × one column) for device
    decode. `f` is an open seekable file object; raises HostFallback
    anywhere outside the envelope."""
    phys = col_md.physical_type
    is_string = phys == "BYTE_ARRAY" \
        and isinstance(engine_dtype, (dt.StringType, dt.BinaryType))
    lane = np.dtype(np.int32) if is_string else _PHYS_LANE.get(phys)
    if lane is None:
        raise HostFallback(f"physical type {phys}", "phys-type")
    if descriptor.max_repetition_level != 0:
        raise HostFallback("repetition levels (nested)", "nested")
    max_def = descriptor.max_definition_level
    if max_def > 1:
        raise HostFallback("definition depth > 1", "def-depth")
    codec = col_md.compression
    if codec not in _SUPPORTED_CODECS:
        raise HostFallback(f"codec {codec}", "codec")
    # bit-identity gate: the file's arrow type must equal the engine
    # dtype's arrow type, be an integer widening the device can astype
    # exactly (int8/int16 ride INT32 physically), or be the same bits
    # under a reinterpreting cast (date32 <-> int32, timestamp[us] <->
    # int64 — what the host path's _align view-casts anyway)
    def _bits_class(t):
        if pa.types.is_date32(t):
            return "i32"
        if pa.types.is_timestamp(t) and t.unit == "us" and t.tz is None:
            return "i64"
        if t == pa.int32():
            return "i32"
        if t == pa.int64():
            return "i64"
        return str(t)
    eng_arrow = dt.to_arrow(engine_dtype)
    if not is_string and arrow_field_type != eng_arrow \
            and _bits_class(arrow_field_type) != _bits_class(eng_arrow):
        both_int = pa.types.is_integer(arrow_field_type) \
            and pa.types.is_integer(eng_arrow)
        if not both_int:
            raise HostFallback(
                f"file type {arrow_field_type} vs engine {eng_arrow}",
                "phys-type")

    n_rows = col_md.num_values
    start = col_md.data_page_offset
    if col_md.dictionary_page_offset is not None:
        start = min(start, col_md.dictionary_page_offset)
    f.seek(start)
    buf = f.read(col_md.total_compressed_size)

    dictionary: Optional[np.ndarray] = None
    # string store: dictionary-page values first, then PLAIN /
    # DELTA_LENGTH page values in page order (identity runs index the
    # page's own slice)
    sd_lens: List[np.ndarray] = []
    sd_chars: List[bytes] = []
    sd_count = 0
    n_dict = 0                      # store entries from the dict page
    dict_rows = 0                   # rows decoded via dictionary runs
    ident_chars = 0                 # chars reachable via identity runs
    packed_parts: List[bytes] = []
    runs: List[tuple] = []          # (value_row, meta, value, bit)
    def_packed_parts: List[bytes] = []
    def_runs: List[tuple] = []
    values_seen = 0                 # dense (non-null) value-stream rows
    rows_seen = 0
    has_delta = has_nondelta = False
    pos = 0
    while rows_seen < n_rows:
        if pos >= len(buf):
            raise HostFallback("page walk ran past chunk bytes",
                               "truncated")
        hdr = parse_page_header(buf, pos)
        payload_start = pos + hdr["header_len"]
        payload = buf[payload_start: payload_start + hdr["compressed"]]
        pos = payload_start + hdr["compressed"]
        if hdr["type"] == _PAGE_DICT:
            dh = hdr["dict_hdr"] or {}
            if dh.get(2, _ENC_PLAIN) not in (_ENC_PLAIN, _ENC_PLAIN_DICT):
                raise HostFallback("non-PLAIN dictionary page",
                                   "encoding")
            data = _decompress(codec, payload, hdr["uncompressed"])
            if phys == "BOOLEAN":
                raise HostFallback("boolean dictionary", "encoding")
            if is_string:
                if sd_count:
                    raise HostFallback("dictionary page after values",
                                       "page")
                d_lens, d_chars = _parse_byte_array_dict(data,
                                                         dh.get(1, 0))
                sd_lens.append(d_lens)
                sd_chars.append(d_chars)
                sd_count = n_dict = d_lens.shape[0]
            else:
                dictionary = np.frombuffer(data, lane, count=dh.get(1, 0))
            continue
        if hdr["type"] == _PAGE_INDEX:
            continue
        if hdr["type"] == _PAGE_DATA:
            dph = hdr["data_hdr"] or {}
            num_values = dph.get(1, 0)
            enc = dph.get(2)
            data = _decompress(codec, payload, hdr["uncompressed"])
            off = 0
            page_valid = num_values
            if max_def > 0:
                if dph.get(3) != _ENC_RLE:
                    raise HostFallback("non-RLE definition levels",
                                       "encoding")
                (dl,) = struct.unpack_from("<i", data, 0)
                base_bits = _align8(def_packed_parts) * 8
                page_def, _ = _parse_runs(data, 4, 4 + dl, 1, num_values,
                                          base_bits)
                page_def = [(r + rows_seen, k, v, b)
                            for r, k, v, b in page_def]
                def_packed_parts.append(data[4:4 + dl])
                page_valid = _popcount_valid(
                    [(r - rows_seen, k, v, b - base_bits)
                     for r, k, v, b in page_def],
                    data[4:4 + dl], 0, num_values)
                def_runs.extend(page_def)
                off = 4 + dl
        elif hdr["type"] == _PAGE_DATA_V2:
            # v2 pages: rep/def level regions ride UNCOMPRESSED before
            # the (optionally compressed) data region, levels carry no
            # 4-byte length prefix, and the null count is in the header
            h2 = hdr["v2_hdr"] or {}
            num_values = h2.get(1, 0)
            num_nulls = h2.get(2, 0)
            enc = h2.get(4)
            def_len = h2.get(5, 0)
            rep_len = h2.get(6, 0)
            if rep_len:
                raise HostFallback("v2 repetition levels (nested)",
                                   "nested")
            body = payload[def_len:]
            if h2.get(7, True) and codec != "UNCOMPRESSED":
                body = _decompress(codec, body,
                                   hdr["uncompressed"] - def_len)
            page_valid = num_values - num_nulls
            if max_def > 0 and def_len:
                def_bytes = bytes(payload[:def_len])
                base_bits = _align8(def_packed_parts) * 8
                page_def, _ = _parse_runs(def_bytes, 0, def_len, 1,
                                          num_values, base_bits)
                def_runs.extend((r + rows_seen, k, v, b)
                                for r, k, v, b in page_def)
                def_packed_parts.append(def_bytes)
            elif num_nulls:
                raise HostFallback("v2 nulls without definition levels",
                                   "page")
            elif max_def > 0:
                # level region elided for an all-valid page: a previous
                # page's trailing run must not govern these rows
                def_runs.append((rows_seen, True, 1, 0))
            data = bytes(body)
            off = 0
        else:
            raise HostFallback("unknown page type", "page")

        # --- shared per-encoding dispatch (v1 and v2 pages) ------------
        if enc in (_ENC_RLE_DICT, _ENC_PLAIN_DICT) \
                and (dictionary is not None or n_dict):
            has_nondelta = True
            width = data[off]
            if width > _MAX_DICT_WIDTH:
                raise HostFallback(f"dict index width {width}",
                                   "dict-width")
            # string chunks: the INDEX stream is the decoded value
            # (no _META_DICT -> the kernel returns raw indices; the
            # device gathers strings from the uploaded store)
            dmeta = 0 if is_string else _META_DICT
            dict_rows += page_valid
            base_bits = _align8(packed_parts) * 8
            if width == 0:
                # every value is dictionary[0]
                runs.append((values_seen, 1 | _META_RLE | dmeta, 0, 0))
            else:
                pruns, stream_end = _parse_runs(data, off + 1, len(data),
                                                width, page_valid,
                                                base_bits)
                packed_parts.append(data[off + 1: stream_end])
                runs.extend(
                    (r + values_seen,
                     (width | _META_RLE | dmeta) if k
                     else (width | dmeta), v, b)
                    for r, k, v, b in pruns)
        elif enc == _ENC_PLAIN and is_string:
            # host walks the length prefixes once into the store; the
            # device gathers the characters via an identity index run
            has_nondelta = True
            lens, chars = _walk_plain_byte_array(data, off, page_valid)
            runs.append((values_seen, _META_IDENT, sd_count, 0))
            sd_lens.append(lens)
            sd_chars.append(chars)
            sd_count += page_valid
            ident_chars += len(chars)
        elif enc == _ENC_PLAIN:
            has_nondelta = True
            base = _align8(packed_parts)
            if phys == "BOOLEAN":
                nbytes = (page_valid + 7) // 8
                packed_parts.append(data[off: off + nbytes])
                runs.append((values_seen, 1, 0, base * 8))
            else:
                w = lane.itemsize * 8
                packed_parts.append(
                    data[off: off + page_valid * lane.itemsize])
                runs.append((values_seen, w, 0, base * 8))
        elif enc == _ENC_RLE and phys == "BOOLEAN":
            # v2 boolean values: RLE/bit-packed hybrid with an i32
            # byte-length prefix (same stream shape as def levels)
            has_nondelta = True
            (bl,) = struct.unpack_from("<i", data, off)
            base_bits = _align8(packed_parts) * 8
            pruns, _ = _parse_runs(data, off + 4, off + 4 + bl, 1,
                                   page_valid, base_bits)
            packed_parts.append(data[off + 4: off + 4 + bl])
            runs.extend((r + values_seen,
                         (1 | _META_RLE) if k else 1, v, b)
                        for r, k, v, b in pruns)
        elif enc == _ENC_DELTA_BINARY_PACKED \
                and phys in ("INT32", "INT64"):
            # miniblock headers -> bit-packed delta runs; the device
            # prefix-sums from each page's first-value run
            has_delta = True
            first, mbs, _ = _plan_delta_page(data, off, page_valid)
            if page_valid:  # a 0-value page must not emit a phantom
                base_bits = _align8(packed_parts) * 8  # first-value run
                runs.append((values_seen, _META_RLE, first, 0))
                runs.extend((values_seen + vs, w | _META_DELTA, md,
                             base_bits + bo)
                            for vs, w, md, bo in mbs)
                packed_parts.append(data[off:])
        elif enc == _ENC_DELTA_LENGTH_BA and is_string:
            # lengths are a host-decoded delta stream (they gate where
            # the character bytes start); characters ride the store
            has_nondelta = True
            lens, cpos = _decode_delta_ints(data, off)
            if lens.shape[0] != page_valid:
                raise HostFallback(
                    f"delta-length count {lens.shape[0]} != "
                    f"{page_valid}", "truncated")
            total = int(lens.sum()) if lens.size else 0
            if cpos + total > len(data):
                # a short slice would silently gather padding as string
                # content — classify, never truncate quietly
                raise HostFallback("delta-length characters truncated",
                                   "truncated")
            runs.append((values_seen, _META_IDENT, sd_count, 0))
            sd_lens.append(lens)
            sd_chars.append(bytes(data[cpos:cpos + total]))
            sd_count += page_valid
            ident_chars += total
        else:
            raise HostFallback(f"encoding {enc}", "encoding")
        values_seen += page_valid
        rows_seen += num_values

    if has_delta and has_nondelta:
        # the prefix-sum reconstruction treats every RLE run as a page
        # restart; a chunk mixing delta pages with other encodings
        # cannot ride it
        raise HostFallback("mixed DELTA/non-DELTA data pages",
                           "encoding")

    packed = b"".join(packed_parts)
    def_packed = b"".join(def_packed_parts)
    run_tab = np.zeros((max(len(runs), 1), 4), np.int64)
    for i, r in enumerate(runs):
        run_tab[i] = r
    if not runs:
        run_tab[0] = (0, 1 | _META_RLE, 0, 0)
    def_tab = np.zeros((max(len(def_runs), 1), 4), np.int64)
    for i, (row, is_rle, value, bit) in enumerate(def_runs):
        def_tab[i] = (row, 1 | (int(is_rle) << 8), value, bit)
    if not def_runs:
        def_tab[0] = (0, 1 | _META_RLE, 1, 0)  # all-valid constant run
    encoded = (len(packed) + len(def_packed) + run_tab.nbytes
               + def_tab.nbytes
               + (dictionary.nbytes if dictionary is not None else 0))
    str_dict = None
    str_char_cap = 0
    str_max_len = 0
    str_bound = 0
    if is_string:
        if not sd_lens and values_seen:
            raise HostFallback("string chunk without dictionary",
                               "encoding")
        lens = np.concatenate(sd_lens) if sd_lens \
            else np.zeros(0, np.int64)
        offs = np.zeros(lens.shape[0] + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        if offs[-1] > np.iinfo(np.int32).max:
            raise HostFallback("string store over int32 offsets",
                               "string-cap")
        chars = np.frombuffer(b"".join(sd_chars) + b"\x00" * 8, np.uint8)
        str_dict = (offs.astype(np.int32), chars)
        str_max_len = int(lens.max()) if lens.size else 0
        d_max = int(lens[:n_dict].max()) if n_dict else 0
        # worst-case decoded characters: dictionary runs can repeat the
        # longest dictionary entry per row; identity runs emit each
        # page value at most once
        str_bound = dict_rows * max(d_max, 1) + ident_chars
        str_bound = max(str_bound, 16)
        if str_bound > STR_EXPANSION_CAP:
            raise HostFallback(
                f"string expansion bound {str_bound}B over the device "
                "cap", "string-cap")
        encoded += offs.nbytes // 2 + chars.nbytes  # int32 on device
        str_char_cap = bucket_bytes(str_bound)
    else:
        # no-win guard: the host-decode path uploads bucket_rows(n)×lane
        # data + a bool validity lane — but it ALSO pays the pyarrow
        # host decode and rides the per-column arrow upload instead of
        # the fused blob, so parity-sized encoded forms still win on
        # device; only a substantially bigger encoded form (pathological
        # dictionaries: near-unique values dict-encoded) is a real loss
        host_upload = bucket_rows(n_rows) * (lane.itemsize + 1)
        if encoded * 2 > host_upload * 3:
            raise HostFallback(
                f"encoded {encoded}B > 1.5x host upload {host_upload}B",
                "size-guard")
    return ChunkPlan(n_rows, lane,
                     dictionary if dictionary is not None
                     else np.zeros(1, lane),
                     _as_words(packed), run_tab,
                     _as_words(def_packed), def_tab, values_seen, encoded,
                     str_dict=str_dict, str_char_cap=str_char_cap,
                     str_max_len=str_max_len, is_delta=has_delta,
                     str_bound=str_bound)


def _parse_byte_array_dict(data: bytes, count: int):
    """PLAIN BYTE_ARRAY dictionary page -> (lengths int64[count],
    contiguous character bytes) — the string-store shape plan_chunk
    accumulates page values into."""
    return _walk_plain_byte_array(data, 0, count)


def _as_words(b: bytes) -> np.ndarray:
    """uint32 word view of the byte stream, padded so widx+1 is always
    in bounds for the funnel-shift gather."""
    pad = (-len(b)) % 4
    arr = np.frombuffer(b + b"\x00" * (pad + 8), np.uint32)
    return arr


def encoded_nbytes(plan: ChunkPlan) -> int:
    return plan.encoded_bytes


def merge_chunk_plans(plans: Sequence[ChunkPlan]) -> ChunkPlan:
    """Concatenate consecutive row groups' plans for ONE column into a
    single plan, so small row groups coalesce into one fused-decode
    dispatch instead of one program + transfer each.

    Streams concatenate 8-byte aligned; run tables shift their dense
    row starts and absolute bit offsets; dictionaries concatenate, and
    every dictionary-index run (numeric ``is_dict`` runs, every value
    run of a string chunk) records its group's index base in meta bits
    16+ so indices keep pointing at their OWN row group's slice of the
    merged dictionary — heterogeneous dictionaries merge without
    re-encoding any payload bytes."""
    if len(plans) == 1:
        return plans[0]
    p0 = plans[0]
    lane = p0.lane
    is_string = p0.str_dict is not None
    is_delta = p0.is_delta
    words_parts: List[np.ndarray] = []
    def_parts: List[np.ndarray] = []
    run_tabs: List[np.ndarray] = []
    def_tabs: List[np.ndarray] = []
    dict_parts: List[np.ndarray] = []
    offs_parts: List[np.ndarray] = []
    chars_parts: List[bytes] = []
    w_words = dw_words = 0
    dense_base = row_base = dict_base = char_base = 0
    n_rows = n_valid = encoded = 0
    str_max_len = 0
    str_bound = 0
    for p in plans:
        if p.lane != lane or (p.str_dict is None) != (not is_string) \
                or p.is_delta != is_delta:
            raise ValueError("merge_chunk_plans: incompatible plans")
        if w_words % 2:  # keep every stream 8-byte aligned (PLAIN w=64)
            words_parts.append(np.zeros(1, np.uint32))
            w_words += 1
        if dw_words % 2:
            def_parts.append(np.zeros(1, np.uint32))
            dw_words += 1
        rt = p.runs.copy()
        rt[:, 0] += dense_base
        rt[:, 3] += w_words * 32
        if dict_base:
            if is_string:
                idx_runs = np.ones(rt.shape[0], bool)
            else:
                idx_runs = ((rt[:, 1] >> 9) & 1) == 1
            rt[idx_runs, 1] += np.int64(dict_base) << 16
        run_tabs.append(rt)
        dtab = p.def_runs.copy()
        dtab[:, 0] += row_base
        dtab[:, 3] += dw_words * 32
        def_tabs.append(dtab)
        words_parts.append(p.packed)
        w_words += p.packed.shape[0]
        def_parts.append(p.def_packed)
        dw_words += p.def_packed.shape[0]
        if is_string:
            offs, chars = p.str_dict
            nd = offs.shape[0] - 1
            o64 = offs.astype(np.int64) + char_base
            offs_parts.append(o64 if not offs_parts else o64[1:])
            real = int(offs[-1]) if offs.size else 0
            chars_parts.append(chars[:real].tobytes())
            char_base += real
            dict_base += nd
        else:
            dict_parts.append(p.dictionary)
            dict_base += p.dictionary.shape[0]
        dense_base += p.n_valid
        row_base += p.n_rows
        n_rows += p.n_rows
        n_valid += p.n_valid
        encoded += p.encoded_bytes
        str_max_len = max(str_max_len, p.str_max_len)
        str_bound += p.str_bound
    str_dict = None
    str_char_cap = 0
    if is_string:
        # each group's rows only reach its own slice of the merged
        # store, so the merged worst case is the SUM of per-group
        # bounds — tight for identity (PLAIN/DELTA_LENGTH) groups too
        if str_bound > STR_EXPANSION_CAP:  # the coalescer prechecks this
            raise HostFallback(
                f"merged string expansion bound {str_bound}B over the "
                "cap", "string-cap")
        if char_base > np.iinfo(np.int32).max:  # coalescer-prechecked
            raise HostFallback(
                "merged string store over int32 offsets", "string-cap")
        offs64 = np.concatenate(offs_parts)
        str_dict = (offs64.astype(np.int32),
                    np.frombuffer(b"".join(chars_parts) + b"\x00" * 8,
                                  np.uint8))
        str_char_cap = bucket_bytes(max(str_bound, 16))
        dictionary = np.zeros(1, lane)
    else:
        dictionary = np.concatenate(dict_parts)
    return ChunkPlan(n_rows, lane, dictionary,
                     np.concatenate(words_parts),
                     np.concatenate(run_tabs),
                     np.concatenate(def_parts),
                     np.concatenate(def_tabs),
                     n_valid, encoded, str_dict=str_dict,
                     str_char_cap=str_char_cap, str_max_len=str_max_len,
                     is_delta=is_delta, str_bound=str_bound)
