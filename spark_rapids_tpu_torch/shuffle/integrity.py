"""Sealed files: CRC32C footers, manifests and classified verified reads.

Counterpart of ``spark_rapids_tpu/shuffle/integrity.py:52-348``, byte for
byte the same format, so a file either package seals the other reads:

- **footer**: every sealed file is ``<payload>`` followed by a 16-byte
  trailer ``<u64 payload_len><u32 crc32c><4s magic>`` (magic ``RSF1``).
  A truncated or overwritten trailer is ``torn``; a payload whose CRC
  disagrees is ``corrupt``.
- **commit**: ``write_sealed_file`` writes ``<path>.tmp`` and publishes
  it with one ``os.replace``; any failure unlinks the partial file.
- **manifest**: ``MANIFEST.json`` records each file of a committed map
  output with its size and CRC, so a missing block is detected too.
- **classified reads**: ``read_sealed_file`` turns every failure into the
  caller's error of kind ``missing``, ``corrupt``, ``torn`` or ``io``;
  transient IO errors are retried in place with exponential backoff. A
  ``<file>.eio`` sidecar holds a countdown of reads that must fail with
  EIO, the test seam for that retry.

``crc32c`` is CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) on
every machine: ``google_crc32c`` where it imports, else ``crc32c_numpy``,
this module's own. The reference falls back to ``zlib.crc32`` (a
different checksum under the same footer) where ``google_crc32c`` is
missing; the port does not. ``CRC32C_IMPL`` names the one in use.

``crc32c_numpy`` cuts the payload into equal lanes, runs the table-driven
CRC of every lane at once (numpy, four bytes a step through four
tables), then folds the lanes' CRCs pairwise: ``crc(A || B)`` is the CRC
register after A pushed through ``len(B)`` zero bytes, XOR ``crc(B)``,
and pushing a register through n zero bytes is a linear map on its 32
bits, applied as four 256-entry tables.
"""
from __future__ import annotations

import contextlib
import errno
import json
import os
import re
import struct
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .transport import FetchFailure

__all__ = ["FOOTER_LEN", "MANIFEST_NAME", "CRC32C_IMPL", "crc32c",
           "crc32c_numpy", "write_block", "footer_bytes",
           "write_sealed_file", "verify_sealed", "read_sealed_file",
           "write_manifest", "read_manifest", "verify_payload",
           "read_block", "expected_partition_files",
           "expected_partition_index"]

_FOOTER_MAGIC = b"RSF1"
FOOTER_LEN = 16  # <Q payload_len> <I crc32c> <4s magic>
MANIFEST_NAME = "MANIFEST.json"

# --- CRC-32C -----------------------------------------------------------------

_POLY = 0x82F63B78
_MASK = 0xFFFFFFFF


def _byte_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(_POLY), t >> 1)
    return t.astype(np.uint32)


_T0 = _byte_table()
# slice-by-4: _T[k][b] is byte b's contribution k bytes before the end of
# a 4-byte word
_T = [_T0]
for _k in range(3):
    _T.append((_T[-1] >> 8) ^ _T0[_T[-1] & 0xFF])
_T = np.stack(_T)


def _zero_byte_images() -> List[int]:
    """The register after one zero byte, for each of its 32 unit
    registers (a column of the linear map)."""
    return [int(_T0[(1 << i) & 0xFF]) ^ ((1 << i) >> 8) for i in range(32)]


def _apply(images: List[int], x: int) -> int:
    out, i = 0, 0
    while x:
        if x & 1:
            out ^= images[i]
        x >>= 1
        i += 1
    return out


def _compose(a: List[int], b: List[int]) -> List[int]:
    """The map ``a(b(x))``."""
    return [_apply(a, v) for v in b]


_SHIFTS: Dict[int, List[int]] = {}


def _shift_images(n: int) -> List[int]:
    """The linear map of n zero bytes through the register."""
    got = _SHIFTS.get(n)
    if got is not None:
        return got
    result = [1 << i for i in range(32)]
    power = _zero_byte_images()
    k = n
    while k:
        if k & 1:
            result = _compose(power, result)
        power = _compose(power, power)
        k >>= 1
    if len(_SHIFTS) < 256:
        _SHIFTS[n] = result
    return result


def _shift_tables(n: int) -> np.ndarray:
    """``(4, 256)`` uint32: the map of n zero bytes, a table per byte
    of the register."""
    img = np.asarray(_shift_images(n), dtype=np.uint32).reshape(4, 8)
    bits = (np.arange(256)[:, None] >> np.arange(8)) & 1  # (256, 8)
    tabs = np.zeros((4, 256), dtype=np.uint32)
    for j in range(8):
        tabs ^= np.where(bits[:, j][None, :] == 1, img[:, j][:, None],
                         np.uint32(0)).astype(np.uint32)
    return tabs


def _apply_tables(tabs: np.ndarray, x: np.ndarray) -> np.ndarray:
    return (tabs[0][x & 0xFF] ^ tabs[1][(x >> 8) & 0xFF]
            ^ tabs[2][(x >> 16) & 0xFF] ^ tabs[3][x >> 24])


def _raw_scalar(buf: np.ndarray) -> int:
    """Zero-initialised register over a few bytes."""
    r = 0
    for b in buf.tolist():
        r = int(_T0[(r ^ b) & 0xFF]) ^ (r >> 8)
    return r


_MAX_LANES = 1 << 16


def crc32c_numpy(data) -> int:
    """CRC-32C of ``data`` (bytes, bytearray, memoryview or a uint8
    array) in numpy; equal to ``google_crc32c.value``."""
    buf = np.frombuffer(data, dtype=np.uint8) \
        if not isinstance(data, np.ndarray) else data.reshape(-1)
    n = buf.size
    lane = max(64, -(-n // _MAX_LANES))
    lane += -lane % 4
    k = n // lane
    main = 0
    if k:
        words = buf[:k * lane].view("<u4").reshape(k, lane // 4)
        regs = np.zeros(k, dtype=np.uint32)
        for j in range(lane // 4):
            x = regs ^ words[:, j]
            regs = (_T[3][x & 0xFF] ^ _T[2][(x >> 8) & 0xFF]
                    ^ _T[1][(x >> 16) & 0xFF] ^ _T[0][x >> 24])
        # leading zero bytes leave a zero register as it was, so lanes
        # of zeros pad the count to a power of two
        width = 1 << (k - 1).bit_length()
        regs = np.concatenate([np.zeros(width - k, np.uint32), regs])
        span = lane
        while regs.size > 1:
            regs = _apply_tables(_shift_tables(span), regs[0::2]) \
                ^ regs[1::2]
            span *= 2
        main = int(regs[0])
    tail = buf[k * lane:]
    raw = _apply(_shift_images(tail.size), main) ^ _raw_scalar(tail)
    # the standard register starts at all ones and ends inverted
    return (raw ^ _apply(_shift_images(n), _MASK)) ^ _MASK


try:
    from google_crc32c import value as _gcrc32c

    def crc32c(data) -> int:
        if not isinstance(data, (bytes, bytearray)):
            data = bytes(data)  # the C implementation rejects memoryview
        return _gcrc32c(data)

    CRC32C_IMPL = "google_crc32c"
except ImportError:  # the module's own, the same checksum
    crc32c = crc32c_numpy
    CRC32C_IMPL = "numpy"


# --- write side --------------------------------------------------------------

def footer_bytes(payload, crc: Optional[int] = None) -> bytes:
    """The 16-byte trailer for ``payload``."""
    if crc is None:
        crc = crc32c(payload)
    return struct.pack("<QI4s", len(payload), crc, _FOOTER_MAGIC)


def write_block(path: str, payload: bytes) -> Tuple[int, int]:
    """``payload`` plus its footer; returns the file's size and the
    payload's CRC (a manifest entry)."""
    crc = crc32c(payload)
    with open(path, "wb") as f:
        f.write(payload)
        f.write(footer_bytes(payload, crc))
    return len(payload) + FOOTER_LEN, crc


def write_sealed_file(path: str, payload, fail_hook=None) -> Tuple[int, int]:
    """Crash-safe sealed write: ``<path>.tmp`` published by one
    ``os.replace``; any failure unlinks the partial file before it
    propagates. ``fail_hook`` runs after the payload and before the
    footer, the seam for an injected mid-write failure. Returns (file
    size, payload crc)."""
    crc = crc32c(payload)
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(payload)
            if fail_hook is not None:
                fail_hook()
            f.write(footer_bytes(payload, crc))
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    return len(payload) + FOOTER_LEN, crc


def write_manifest(staging_dir: str, task_key: str, attempt: int,
                   files: Dict[str, Dict]) -> str:
    """The attempt's record of its files, committed in its staging
    directory."""
    path = os.path.join(staging_dir, MANIFEST_NAME)
    doc = {"task": task_key, "attempt": attempt, "files": files}
    with open(path + ".tmp", "w") as f:
        json.dump(doc, f)
    os.replace(path + ".tmp", path)
    return path


def read_manifest(mapout_dir: str, shuffle_id: int = -1) -> Optional[Dict]:
    """The directory's manifest, None when it has none; one that exists
    but does not parse is ``torn``."""
    path = os.path.join(mapout_dir, MANIFEST_NAME)
    task_key = os.path.basename(mapout_dir).rsplit(".mapout", 1)[0]
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise FetchFailure(shuffle_id, task_key, path, "torn",
                           f"unreadable manifest: {e}")
    if not isinstance(doc, dict) or not isinstance(doc.get("files"), dict):
        raise FetchFailure(shuffle_id, task_key, path, "torn",
                           "malformed manifest")
    return doc


# --- read side ---------------------------------------------------------------

def verify_sealed(data: bytes, make_error,
                  expected_crc: Optional[int] = None):
    """The payload of one sealed file (a memoryview over ``data``) after
    its footer is checked; ``make_error(kind, detail)`` classifies a
    failure (``torn`` or ``corrupt``)."""
    if len(data) < FOOTER_LEN or data[-4:] != _FOOTER_MAGIC:
        raise make_error("torn", f"bad footer (file is {len(data)} bytes)")
    plen, crc = struct.unpack("<QI", data[-FOOTER_LEN:-4])
    if plen != len(data) - FOOTER_LEN:
        raise make_error(
            "torn",
            f"footer claims {plen} payload bytes, file holds "
            f"{len(data) - FOOTER_LEN}")
    if expected_crc is not None and expected_crc != crc:
        raise make_error("corrupt",
                         f"footer crc {crc:#010x} != manifest "
                         f"{expected_crc:#010x}")
    payload = memoryview(data)[:-FOOTER_LEN]
    got = crc32c(payload)
    if got != crc:
        raise make_error("corrupt",
                         f"crc {got:#010x} != footer {crc:#010x}")
    return payload


def verify_payload(data: bytes, path: str, shuffle_id: int = -1,
                   map_task=None, expected_crc: Optional[int] = None):
    """``verify_sealed`` whose failures are ``FetchFailure``s."""
    return verify_sealed(
        data,
        lambda kind, detail: FetchFailure(shuffle_id, map_task, path,
                                          kind, detail),
        expected_crc=expected_crc)


def _maybe_inject_eio(path: str) -> None:
    """A ``<file>.eio`` sidecar counts down reads that fail with EIO."""
    sidecar = path + ".eio"
    try:
        with open(sidecar) as f:
            left = int(f.read().strip() or 0)
    except (OSError, ValueError):
        return
    if left <= 0:
        return
    with open(sidecar + ".tmp", "w") as f:
        f.write(str(left - 1))
    os.replace(sidecar + ".tmp", sidecar)
    raise OSError(errno.EIO, f"injected EIO ({left - 1} left)", path)


def read_sealed_file(path: str, make_error, *,
                     expected_size: Optional[int] = None,
                     expected_crc: Optional[int] = None,
                     max_retries: int = 0, retry_wait_s: float = 0.05,
                     on_retry=None,
                     missing_detail: str = "sealed file is gone"):
    """Read and verify one sealed file; its payload as a memoryview.
    A gone file is ``missing`` (no retry), a bad footer or a size other
    than ``expected_size`` ``torn``, a CRC mismatch ``corrupt``, and any
    other OSError is retried in place with backoff, then ``io``."""
    last: Optional[OSError] = None
    for attempt in range(max(0, max_retries) + 1):
        if attempt and on_retry is not None:
            on_retry(attempt, last)
        try:
            _maybe_inject_eio(path)
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            raise make_error("missing", missing_detail)
        except OSError as e:
            last = e
            if attempt < max_retries:  # no sleep before the escalation
                time.sleep(retry_wait_s * (2 ** attempt))
            continue
        if expected_size is not None and expected_size != len(data):
            raise make_error(
                "torn",
                f"manifest expects {expected_size} bytes, file holds "
                f"{len(data)}")
        return verify_sealed(data, make_error, expected_crc=expected_crc)
    raise make_error(
        "io",
        f"still failing after {max_retries} in-place retries: {last}")


def read_block(path: str, meta: Optional[Dict] = None, *,
               shuffle_id: int = -1, map_task=None,
               max_retries: int = 3, retry_wait_s: float = 0.05,
               on_retry=None):
    """One shuffle block: ``read_sealed_file`` with the manifest's
    expectations, failures as ``FetchFailure``s."""
    meta = meta or {}
    map_task = meta.get("task", map_task)
    return read_sealed_file(
        path,
        lambda kind, detail: FetchFailure(shuffle_id, map_task, path,
                                          kind, detail),
        expected_size=meta.get("size"), expected_crc=meta.get("crc"),
        max_retries=max_retries, retry_wait_s=retry_wait_s,
        on_retry=on_retry,
        missing_detail="block listed in the manifest is gone")


_PID_RE = re.compile(r"_p(\d+)\.arrow$")


def expected_partition_index(
        sdir: str, expected_mapouts: Optional[List[str]] = None,
        shuffle_id: int = -1) -> Dict[int, List[Tuple[str,
                                                      Optional[Dict]]]]:
    """``{partition_id: [(path, manifest meta)]}`` over a shuffle
    directory, each committed directory's manifest read once; an expected
    map output whose directory is gone raises ``missing``."""
    try:
        names = sorted(os.listdir(sdir))
    except FileNotFoundError:
        names = []
    seen_dirs = {n[:-len(".mapout")] for n in names
                 if n.endswith(".mapout")
                 and os.path.isdir(os.path.join(sdir, n))}
    for key in sorted(expected_mapouts or []):
        if key not in seen_dirs:
            raise FetchFailure(
                shuffle_id, key, os.path.join(sdir, f"{key}.mapout"),
                "missing", "committed map output dir is gone")
    out: Dict[int, List[Tuple[str, Optional[Dict]]]] = {}

    def add(pid, path, meta):
        out.setdefault(pid, []).append((path, meta))

    for n in names:
        p = os.path.join(sdir, n)
        m = _PID_RE.search(n)
        if m is not None:
            add(int(m.group(1)), p, None)
        elif n.endswith(".mapout") and os.path.isdir(p):
            task_key = n[:-len(".mapout")]
            manifest = read_manifest(p, shuffle_id)
            if manifest is None:
                for f in sorted(os.listdir(p)):
                    fm = _PID_RE.search(f)
                    if fm is not None:
                        add(int(fm.group(1)), os.path.join(p, f), None)
                continue
            for f in sorted(manifest["files"]):
                fm = _PID_RE.search(f)
                if fm is None:
                    continue
                meta = dict(manifest["files"][f] or {})
                meta.setdefault("task", manifest.get("task", task_key))
                add(int(fm.group(1)), os.path.join(p, f), meta)
    return out


def expected_partition_files(
        sdir: str, partition_id: int,
        expected_mapouts: Optional[List[str]] = None,
        shuffle_id: int = -1) -> List[Tuple[str, Optional[Dict]]]:
    """One partition's slice of ``expected_partition_index``."""
    return expected_partition_index(sdir, expected_mapouts,
                                    shuffle_id).get(partition_id, [])
