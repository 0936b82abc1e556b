"""The port's CUDA kernels and their plain PyTorch versions.

K1 on the H100: the q6 filter -> product -> sum chain as one CUDA kernel.
Counterpart of ``spark_rapids_tpu/ops/pallas_kernels.py:33-84``
(``masked_product_sum_xla`` and ``masked_product_sum_pallas``). The
kernel is ``csrc/masked_product_sum.cu``; its source note gives its
bound (the bytes it reads: 12.0 MB, 3.6 us at 3.35 TB/s, at a q6 batch)
and design. Two editions of one template:

- ``filter_product_sum`` (engine edition): up to four float32/int32/date
  columns with optional validity, ``row_count`` and an optional selection
  mask, up to eight ``(column slot, op, bound)`` leaves in Spark's
  NaN-greatest order, and two float32 product slots. It returns the
  float64 sum of ``a * b`` (rounded to float32 first) over the rows that
  pass, and their int64 count. The engine launches it once per batch.
- ``masked_product_sum`` (K1-contract edition): q6's constants, IEEE
  comparisons and a float32 sum, exactly ``masked_product_sum_xla``, for
  any ``n``. It returns the sum and the count.

Each K1 call is one launch over a grid sized to the card that requests
every byte of the batch before it filters any: each thread issues its
16-byte loads at once. As K2 does, the last block to finish sums the
blocks' partials, counted with a ticket kept with the partials in one
workspace per (device, stream).

K3, ``csrc/radix_sort.cu``, replaces ``sort_pallas`` (``:156``), as an
LSD radix sort that skips every 8-bit digit in which all keys agree:

- ``sort_pairs`` (engine edition): ``(uint64 key, int32 payload)`` pairs
  of any length, ordered on ``(key, payload)`` with keys unsigned and
  payloads signed. Keys travel as ``int64`` tensors holding the uint64
  bits. The payload defaults to the row position, which makes the sort
  stable. ``sort_passes_torch`` names the digit slots it sorts by.
- ``sort_keys`` (K3-contract edition): float32 or int32 keys of any
  length in ``sort_xla``'s order (``jax.lax.sort``: NaNs last and equal,
  ``-0.0 == 0.0``); ``-0.0`` comes back as ``0.0`` and a NaN as the
  canonical NaN.

K4, ``csrc/gather.cu``, replaces ``gather_pallas`` (``:259``):

- ``gather_rows`` (engine edition): up to 16 fixed-width columns of 1, 2,
  4 or 8 bytes in one launch, ``out[i] = live[i] ? col[idx[i]] : 0`` and
  ``out_valid[i] = live[i] & valid[idx[i]]``, bit for bit.
- ``gather`` (K4-contract edition): ``gather_xla``, ``table[idx]``, for a
  4-byte table and any length.

K2, ``csrc/fused_filter_agg.cu``, replaces ``fused_filter_agg_pallas``
(``:225``):

- ``filter_product_group_sum`` (engine edition): K1's leaf spec over the
  same columns plus an int32 or int64 key, a base and a group count of
  at most ``FUSED_AGG_GROUPS``; per group (and one more slot for the null
  key) the float64 sum of ``a * b``, its non-null count and the count of
  passing rows, and the count of passing rows whose key lies outside the
  groups. The grouped aggregate launches it once per batch where the
  scan's statistics bound the key to 8 values.
- ``fused_filter_agg`` (K2-contract edition): ``fused_filter_agg_xla``,
  q6's constants, IEEE comparisons and float32 sums over the keys 0..7,
  for any length.

Each K2 call is one launch, finished as K1's is.

Each wrapper takes its plain PyTorch version (the ``*_torch`` functions)
only for tensors on the CPU; a CUDA tensor gets the kernel or an
exception. Each keeps a plain integer ``launches`` count, raised by one
where it launches its kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Leaf", "FilterProductSum", "Q6_SPEC", "OPS",
           "filter_product_sum", "filter_product_sum_torch",
           "masked_product_sum", "masked_product_sum_torch",
           "MAX_SLOTS", "MAX_LEAVES", "sort_pairs", "sort_pairs_torch",
           "sort_keys", "sort_keys_torch", "sort_passes_torch",
           "gather_rows",
           "gather_rows_torch", "gather", "gather_torch",
           "MAX_GATHER_COLS", "MAX_SORT_PAIRS", "FUSED_AGG_GROUPS",
           "filter_product_group_sum", "filter_product_group_sum_torch",
           "fused_filter_agg", "fused_filter_agg_torch"]

MAX_SLOTS = 4
MAX_LEAVES = 8
OPS = {"<": 0, "<=": 1, ">": 2, ">=": 3, "=": 4}
_COL_TYPES = {torch.float32: 0, torch.int32: 1}
_ENGINE, _CONTRACT = 0, 1


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One predicate leaf: ``column[slot] op bound``."""
    slot: int
    op: str
    bound: float


@dataclasses.dataclass(frozen=True)
class FilterProductSum:
    """The chain's shape: predicate leaves, then ``col[a_slot] *
    col[b_slot]`` summed."""
    leaves: Tuple[Leaf, ...]
    a_slot: int
    b_slot: int


# masked_product_sum_xla's mask over slots (quantity, price, discount,
# shipdate), summing price * discount
Q6_SPEC = FilterProductSum(
    leaves=(Leaf(3, ">=", 8766), Leaf(3, "<", 9131),
            Leaf(2, ">=", float(np.float32(0.05))),
            Leaf(2, "<=", float(np.float32(0.07))),
            Leaf(0, "<", 24.0)),
    a_slot=1, b_slot=2)


# --- plain PyTorch versions ------------------------------------------------

def _compare(x: torch.Tensor, op: str, bound: float,
             nan_greatest: bool) -> torch.Tensor:
    """``x op bound`` over float64 ``x``, in IEEE or Spark's order."""
    if not nan_greatest:
        return {"<": x < bound, "<=": x <= bound, ">": x > bound,
                ">=": x >= bound, "=": x == bound}[op]
    xn = torch.isnan(x)
    if math.isnan(bound):  # NaN is the greatest value and equals itself
        lt, gt, eq = ~xn, torch.zeros_like(xn), xn
    else:
        lt, gt, eq = ~xn & (x < bound), xn | (x > bound), x == bound
    return {"<": lt, "<=": lt | eq, ">": gt, ">=": gt | eq, "=": eq}[op]


def filter_product_sum_torch(cols: Sequence[torch.Tensor],
                             valids: Sequence[Optional[torch.Tensor]],
                             selection: Optional[torch.Tensor],
                             row_count: int, spec: FilterProductSum,
                             nan_greatest: bool = True,
                             acc: torch.dtype = torch.float64) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: ``(sum, count)``."""
    n = cols[0].shape[0]
    keep = torch.arange(n, device=cols[0].device) < row_count
    if selection is not None:
        keep &= selection
    for v in valids:
        if v is not None:
            keep &= v
    for leaf in spec.leaves:
        keep &= _compare(cols[leaf.slot].to(torch.float64), leaf.op,
                         leaf.bound, nan_greatest)
    prod = (cols[spec.a_slot] * cols[spec.b_slot]).to(acc)
    zero = torch.zeros((), dtype=acc, device=prod.device)
    return (torch.where(keep, prod, zero).sum(dtype=acc),
            keep.sum(dtype=torch.int64))


def masked_product_sum_torch(q, p, d, s) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """``masked_product_sum_xla`` in plain PyTorch: float32 sum, count."""
    return filter_product_sum_torch([q, p, d, s], [None] * 4, None,
                                    q.shape[0], Q6_SPEC,
                                    nan_greatest=False, acc=torch.float32)


# --- the kernel -----------------------------------------------------------

class _Leaf(ctypes.Structure):
    _fields_ = [("bound", ctypes.c_double), ("slot", ctypes.c_int32),
                ("op", ctypes.c_int32)]


class _Args(ctypes.Structure):
    """Mirror of ``FpsArgs`` in the CUDA source."""
    _fields_ = [("col", ctypes.c_void_p * MAX_SLOTS),
                ("valid", ctypes.c_void_p * MAX_SLOTS),
                ("sel", ctypes.c_void_p),
                ("row_count", ctypes.c_int64),
                ("col_type", ctypes.c_int32 * MAX_SLOTS),
                ("n_leaves", ctypes.c_int32),
                ("a_slot", ctypes.c_int32),
                ("b_slot", ctypes.c_int32),
                ("aligned", ctypes.c_int32),
                ("leaf", _Leaf * MAX_LEAVES)]


def _library():
    from ._build import load
    lib = load("masked_product_sum")
    if not getattr(lib, "_spark_ready", False):
        for fn in (lib.spark_fps_args_size, lib.spark_fps_max_blocks,
                   lib.spark_fps_block_rows, lib.spark_fps_ahead):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        lib.spark_fps_grid.argtypes = [ctypes.c_int, ctypes.c_longlong]
        lib.spark_fps_grid.restype = ctypes.c_int
        lib.spark_fps_launch.argtypes = [ctypes.c_void_p, ctypes.c_int] \
            + [ctypes.c_void_p] * 6
        lib.spark_fps_launch.restype = ctypes.c_int
        if lib.spark_fps_args_size() != ctypes.sizeof(_Args):
            raise RuntimeError(
                f"FpsArgs is {lib.spark_fps_args_size()} bytes in the CUDA "
                f"source but {ctypes.sizeof(_Args)} in ctypes")
        lib._spark_ready = True
    return lib


_workspaces = {}


def _stream_workspace(kind: str, device: torch.device, stream,
                      make) -> Tuple:
    """The workspace of one kernel (``kind``) on ``stream`` of ``device``,
    made once by ``make()`` on that stream: block partials and a ticket
    counter, made zero and reset to 0 by each launch's last block.
    Launches on one stream run in order; two streams never share a
    counter."""
    key = (kind, device.index, stream.cuda_stream)
    ws = _workspaces.get(key)
    if ws is None:
        with torch.cuda.stream(stream):
            ws = make()
        _workspaces[key] = ws
    return ws


def _check_inputs(cols, valids, selection, row_count, spec, device):
    if not 1 <= len(cols) <= MAX_SLOTS or len(valids) != len(cols):
        raise ValueError(f"need 1..{MAX_SLOTS} columns, each with a "
                         f"validity entry; got {len(cols)}/{len(valids)}")
    if len(spec.leaves) > MAX_LEAVES:
        raise ValueError(f"at most {MAX_LEAVES} leaves, got "
                         f"{len(spec.leaves)}")
    n = cols[0].shape[0]
    if not 0 <= row_count <= n or n >= 1 << 31:
        raise ValueError(f"row_count {row_count} outside capacity {n}")
    tensors = list(cols) + [v for v in valids if v is not None]
    if selection is not None:
        tensors.append(selection)
    for t in tensors:
        if t.device != device:
            raise ValueError(f"all inputs must be on {device}, one is on "
                             f"{t.device}")
        if t.dim() != 1 or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"inputs must be contiguous 1-D of length {n},"
                             f" got shape {tuple(t.shape)}")
    for c in cols:
        if c.dtype not in _COL_TYPES:
            raise ValueError(f"column dtype {c.dtype} is not float32 or "
                             "int32")
    for v in list(valids) + [selection]:
        if v is not None and v.dtype != torch.bool:
            raise ValueError(f"masks must be bool, got {v.dtype}")
    for s in (spec.a_slot, spec.b_slot):
        if not 0 <= s < len(cols) or cols[s].dtype != torch.float32:
            raise ValueError(f"product slot {s} must hold a float32 column")
    for leaf in spec.leaves:
        if not 0 <= leaf.slot < len(cols) or leaf.op not in OPS:
            raise ValueError(f"bad leaf {leaf}")


def _aligned(cols, masks) -> int:
    """1 where every column lies at 16 bytes and every mask at 4: the
    kernel's 16-byte and 4-byte loads; other inputs take its scalar
    loop."""
    return int(all(t.data_ptr() % 16 == 0 for t in cols)
               and all(t.data_ptr() % 4 == 0 for t in masks
                       if t is not None))


def _launch(edition: int, cols, valids, selection, row_count: int,
            spec: FilterProductSum, acc: torch.dtype):
    lib = _library()
    device = cols[0].device
    args = _Args()
    for k, c in enumerate(cols):
        args.col[k] = c.data_ptr()
        args.col_type[k] = _COL_TYPES[c.dtype]
        v = valids[k]
        args.valid[k] = None if v is None else v.data_ptr()
    args.sel = None if selection is None else selection.data_ptr()
    args.row_count = row_count
    args.n_leaves = len(spec.leaves)
    args.a_slot, args.b_slot = spec.a_slot, spec.b_slot
    for j, leaf in enumerate(spec.leaves):
        args.leaf[j] = _Leaf(float(leaf.bound), leaf.slot, OPS[leaf.op])
    args.aligned = _aligned(cols, list(valids) + [selection])
    stream = torch.cuda.current_stream(device)
    blocks = lib.spark_fps_max_blocks()
    work = _stream_workspace("k1", device, stream, lambda: (
        torch.empty(blocks, dtype=torch.float64, device=device),
        torch.empty(blocks, dtype=torch.int64, device=device),
        torch.zeros(1, dtype=torch.int32, device=device)))
    # the engine keeps the outputs as the batch's partial buffer
    out_sum = torch.empty((), dtype=acc, device=device)
    out_cnt = torch.empty((), dtype=torch.int64, device=device)
    err = lib.spark_fps_launch(
        ctypes.addressof(args), edition, *[t.data_ptr() for t in work], out_sum.data_ptr(),
        out_cnt.data_ptr(), stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"masked_product_sum kernel launch failed: "
                           f"cudaError {err}")
    return out_sum, out_cnt


def _on_cpu(tensors: List[torch.Tensor]) -> bool:
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"inputs on mixed or unsupported devices: {kinds}")


def filter_product_sum(cols: Sequence[torch.Tensor],
                       valids: Sequence[Optional[torch.Tensor]],
                       selection: Optional[torch.Tensor], row_count: int,
                       spec: FilterProductSum) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """Engine edition: float64 ``(sum, count)`` under Spark's float order.
    A CPU input takes the plain version; a CUDA input launches the
    kernel."""
    if _on_cpu(list(cols) + list(valids) + [selection]):
        return filter_product_sum_torch(cols, valids, selection, row_count,
                                        spec)
    _check_inputs(cols, valids, selection, row_count, spec, cols[0].device)
    out = _launch(_ENGINE, cols, valids, selection, row_count, spec,
                  torch.float64)
    filter_product_sum.launches += 1
    return out


filter_product_sum.launches = 0


def masked_product_sum(q, p, d, s) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1-contract edition: ``masked_product_sum_xla``'s float32 sum, and
    the count of rows in it, for any length."""
    cols = [q, p, d, s]
    if _on_cpu(cols):
        return masked_product_sum_torch(q, p, d, s)
    valids = [None] * 4
    if not (q.dtype == p.dtype == d.dtype == torch.float32
            and s.dtype == torch.int32):
        raise ValueError("masked_product_sum takes float32 q, p, d and "
                         "int32 s")
    _check_inputs(cols, valids, None, q.shape[0], Q6_SPEC, q.device)
    out = _launch(_CONTRACT, cols, valids, None, q.shape[0], Q6_SPEC,
                  torch.float32)
    masked_product_sum.launches += 1
    return out


masked_product_sum.launches = 0


# --- K3: the radix sort -----------------------------------------------------

MAX_SORT_PAIRS = 1 << 30
_I64_MIN = -(1 << 63)
_I32_MIN = -(1 << 31)
_PAY_DIGITS = 4
_KEY_DIGITS = 8
_BINS = 256


def _digit(keys: torch.Tensor, payload: torch.Tensor, slot: int) \
        -> torch.Tensor:
    """The 8-bit digit of digit slot ``slot`` as int64: slots 0..3 are the
    payload's digits (sign bit flipped, so unsigned order is signed
    order), 4..11 the key's, least significant first. torch has no uint64
    shifts on the CPU; an arithmetic shift then ``& 0xFF`` is exact for
    every digit."""
    if slot < _PAY_DIGITS:
        return ((payload.to(torch.int64) - _I32_MIN) >> (8 * slot)) & 0xFF
    return (keys >> (8 * (slot - _PAY_DIGITS))) & 0xFF


def _sort_slots(with_payload: bool) -> range:
    """The digit slots a sort passes over, in order: the payload's four
    digits when one is given, then the key's eight."""
    return range(0 if with_payload else _PAY_DIGITS,
                 _PAY_DIGITS + _KEY_DIGITS)


def sort_passes_torch(keys: torch.Tensor,
                      payload: Optional[torch.Tensor] = None) -> List[int]:
    """The digit slots the kernel sorts by, in order: those in which not
    all ``n`` pairs fall into one bin. Every other digit is constant, so
    its stable pass would be the identity and is skipped."""
    n = keys.shape[0]
    return [s for s in _sort_slots(payload is not None)
            if n and torch.bincount(_digit(keys, payload, s),
                                    minlength=_BINS).max().item() < n]


def sort_pairs_torch(keys: torch.Tensor,
                     payload: Optional[torch.Tensor] = None) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, by its passes: for each
    non-trivial digit slot, least significant first, a stable scatter to
    the digit's bucket offset (``bincount``) plus the pair's rank within
    its bucket (a stable argsort of the digit). Returns ``(sorted keys,
    payloads)``."""
    n = keys.shape[0]
    dev = keys.device
    k = keys
    p = torch.arange(n, dtype=torch.int32, device=dev) if payload is None \
        else payload
    for slot in sort_passes_torch(keys, payload):
        d = _digit(k, p, slot)
        counts = torch.bincount(d, minlength=_BINS)
        offsets = torch.cumsum(counts, 0) - counts
        order = torch.sort(d, stable=True).indices
        rank = torch.empty_like(order)
        rank[order] = torch.arange(n, device=dev) - offsets[d[order]]
        dst = offsets[d] + rank
        k_next, p_next = torch.empty_like(k), torch.empty_like(p)
        k_next[dst], p_next[dst] = k, p
        k, p = k_next, p_next
    return (k.clone() if k is keys else k,
            p.clone() if p is payload else p)


def _sort_library():
    from ._build import load
    lib = load("radix_sort")
    if not getattr(lib, "_spark_ready", False):
        lib.spark_sort_work_bytes.argtypes = [ctypes.c_int64]
        lib.spark_sort_work_bytes.restype = ctypes.c_int64
        lib.spark_sort_pairs.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p]
        lib.spark_sort_pairs.restype = ctypes.c_int
        lib._spark_ready = True
    return lib


def _check_sort_inputs(keys: torch.Tensor,
                       payload: Optional[torch.Tensor]) -> None:
    if keys.dtype != torch.int64 or keys.dim() != 1 \
            or not keys.is_contiguous():
        raise ValueError("sort keys must be a contiguous 1-D int64 tensor "
                         f"(uint64 bits), got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    if keys.shape[0] > MAX_SORT_PAIRS:
        raise ValueError(f"at most {MAX_SORT_PAIRS} pairs, got "
                         f"{keys.shape[0]}")
    if payload is not None:
        if payload.dtype != torch.int32 or payload.dim() != 1 \
                or payload.shape[0] != keys.shape[0] \
                or not payload.is_contiguous():
            raise ValueError("the payload must be a contiguous 1-D int32 "
                             "tensor as long as the keys")
        if payload.device != keys.device:
            raise ValueError(f"keys on {keys.device}, payload on "
                             f"{payload.device}")


def _sort_launch(keys: torch.Tensor, payload: Optional[torch.Tensor]) \
        -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Launch the sort; None when there is nothing to sort. The output,
    the alternate buffer the passes ping-pong through and the workspace
    (histograms, plan, tile status words) come from the caching
    allocator."""
    n = keys.shape[0]
    if n == 0:
        return None
    lib = _sort_library()
    dev = keys.device
    keys_out = torch.empty(n, dtype=torch.int64, device=dev)
    pay_out = torch.empty(n, dtype=torch.int32, device=dev)
    keys_alt = torch.empty(n, dtype=torch.int64, device=dev)
    pay_alt = torch.empty(n, dtype=torch.int32, device=dev)
    work = torch.empty(lib.spark_sort_work_bytes(n), dtype=torch.uint8,
                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.spark_sort_pairs(
        keys.data_ptr(), None if payload is None else payload.data_ptr(),
        n, keys_out.data_ptr(), pay_out.data_ptr(), keys_alt.data_ptr(),
        pay_alt.data_ptr(), work.data_ptr(), work.numel(), stream)
    if err != 0:
        raise RuntimeError(f"radix_sort kernel launch failed: "
                           f"cudaError {err}")
    return keys_out, pay_out


def sort_pairs(keys: torch.Tensor, payload: Optional[torch.Tensor] = None) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """Engine edition: sort ``(key, payload)`` pairs, keys unsigned; the
    payload defaults to the position. A CPU input takes the plain
    version; a CUDA input launches the kernel."""
    if _on_cpu([keys, payload]):
        return sort_pairs_torch(keys, payload)
    _check_sort_inputs(keys, payload)
    out = _sort_launch(keys, payload)
    if out is None:  # empty: nothing to launch
        return keys.clone(), torch.empty(0, dtype=torch.int32,
                                         device=keys.device)
    sort_pairs.launches += 1
    return out


sort_pairs.launches = 0


def _orderable_words(keys: torch.Tensor) -> torch.Tensor:
    """float32 / int32 keys -> int64 words whose unsigned order is
    ``jax.lax.sort``'s order (floats canonicalised first)."""
    if keys.dtype == torch.float32:
        k = torch.where(keys == 0, torch.zeros_like(keys), keys)
        k = torch.where(torch.isnan(k), torch.full_like(k, math.nan), k)
        bits = k.view(torch.int32)
        o = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    elif keys.dtype == torch.int32:
        o = keys
    else:
        raise ValueError(f"sort_keys takes float32 or int32 keys, got "
                         f"{keys.dtype}")
    return (o ^ _I32_MIN).to(torch.int64) & 0xFFFFFFFF


def _from_orderable_words(words: torch.Tensor,
                          dtype: torch.dtype) -> torch.Tensor:
    o = (words ^ (1 << 31)).to(torch.int32)
    if dtype == torch.int32:
        return o
    return torch.where(o < 0, o ^ 0x7FFFFFFF, o).view(torch.float32)


def sort_keys_torch(keys: torch.Tensor) -> torch.Tensor:
    """``sort_xla`` in plain PyTorch, by the kernel's passes."""
    if keys.dim() != 1:
        raise ValueError("sort_keys takes a 1-D tensor")
    words, _ = sort_pairs_torch(_orderable_words(keys))
    return _from_orderable_words(words, keys.dtype)


def sort_keys(keys: torch.Tensor) -> torch.Tensor:
    """K3-contract edition: ``sort_xla(keys)`` for float32 or int32 keys
    of any length."""
    if _on_cpu([keys]):
        return sort_keys_torch(keys)
    if keys.dim() != 1:
        raise ValueError("sort_keys takes a 1-D tensor")
    words = _orderable_words(keys).contiguous()
    out = _sort_launch(words, None)
    if out is None:
        return keys.clone()
    sort_keys.launches += 1
    return _from_orderable_words(out[0], keys.dtype)


sort_keys.launches = 0


# --- K4: the row gather -----------------------------------------------------

MAX_GATHER_COLS = 16


class _GatherArgs(ctypes.Structure):
    """Mirror of ``GatherArgs`` in the CUDA source."""
    _fields_ = [("src", ctypes.c_void_p * MAX_GATHER_COLS),
                ("dst", ctypes.c_void_p * MAX_GATHER_COLS),
                ("src_valid", ctypes.c_void_p * MAX_GATHER_COLS),
                ("dst_valid", ctypes.c_void_p * MAX_GATHER_COLS),
                ("width", ctypes.c_int32 * MAX_GATHER_COLS),
                ("n_cols", ctypes.c_int32),
                ("pad_", ctypes.c_int32),
                ("idx", ctypes.c_void_p),
                ("live", ctypes.c_void_p),
                ("n", ctypes.c_int64),
                ("table_rows", ctypes.c_int64)]


def _gather_library():
    from ._build import load
    lib = load("gather")
    if not getattr(lib, "_spark_ready", False):
        lib.spark_gather_args_size.argtypes = []
        lib.spark_gather_args_size.restype = ctypes.c_int
        lib.spark_gather_max_cols.argtypes = []
        lib.spark_gather_max_cols.restype = ctypes.c_int
        lib.spark_gather_launch.argtypes = [ctypes.c_void_p,
                                            ctypes.c_void_p]
        lib.spark_gather_launch.restype = ctypes.c_int
        if lib.spark_gather_args_size() != ctypes.sizeof(_GatherArgs) \
                or lib.spark_gather_max_cols() != MAX_GATHER_COLS:
            raise RuntimeError(
                f"GatherArgs is {lib.spark_gather_args_size()} bytes in "
                f"the CUDA source but {ctypes.sizeof(_GatherArgs)} in "
                "ctypes")
        lib._spark_ready = True
    return lib


def _gather_live(live: Optional[torch.Tensor], n: int, table_rows: int,
                 device) -> Optional[torch.Tensor]:
    """The live mask both versions use: an empty table has no row to
    gather, so every output row is dead."""
    if table_rows == 0 and n:
        return torch.zeros(n, dtype=torch.bool, device=device)
    return live


def gather_rows_torch(cols: Sequence[torch.Tensor],
                      valids: Sequence[Optional[torch.Tensor]],
                      idx: torch.Tensor,
                      live: Optional[torch.Tensor] = None) \
        -> Tuple[List[torch.Tensor], List[Optional[torch.Tensor]]]:
    """The kernel's function in plain PyTorch (indexing): ``(outputs,
    output validities)``; a validity is None where both the source's
    and ``live`` are None."""
    table_rows = cols[0].shape[0]
    live = _gather_live(live, idx.shape[0], table_rows, idx.device)
    j = idx.long().clamp(0, max(table_rows - 1, 0))
    outs, out_valids = [], []
    for c, v in zip(cols, valids):
        g = c[j] if table_rows else torch.zeros(idx.shape[0], dtype=c.dtype,
                                                device=c.device)
        if live is not None:
            g = torch.where(live, g, torch.zeros_like(g))
        outs.append(g)
        if v is None:
            out_valids.append(live)
        else:
            ov = v[j] if table_rows else torch.zeros_like(g, dtype=torch.bool)
            out_valids.append(ov if live is None else ov & live)
    return outs, out_valids


def _check_gather_inputs(cols, valids, idx, live) -> None:
    if not cols or len(valids) != len(cols):
        raise ValueError(f"need at least one column, each with a validity "
                         f"entry; got {len(cols)}/{len(valids)}")
    device = idx.device
    table_rows = cols[0].shape[0]
    if idx.dtype != torch.int32 or idx.dim() != 1 \
            or not idx.is_contiguous():
        raise ValueError("indices must be a contiguous 1-D int32 tensor")
    n = idx.shape[0]
    for t in list(cols) + list(valids) + [live]:
        if t is not None and t.device != device:
            raise ValueError(f"all inputs must be on {device}, one is on "
                             f"{t.device}")
    for c in cols:
        if c.dim() != 1 or c.shape[0] != table_rows \
                or not c.is_contiguous() \
                or c.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"columns must be contiguous 1-D of length "
                             f"{table_rows} with 1, 2, 4 or 8 byte "
                             f"elements, got {c.dtype} {tuple(c.shape)}")
    for v in valids:
        if v is not None and (v.dtype != torch.bool or v.dim() != 1
                              or v.shape[0] != table_rows
                              or not v.is_contiguous()):
            raise ValueError("validities must be contiguous bool tensors "
                             "as long as the columns")
    if live is not None and (live.dtype != torch.bool or live.dim() != 1
                             or live.shape[0] != n
                             or not live.is_contiguous()):
        raise ValueError("live must be a contiguous bool tensor as long as "
                         "the indices")


def _gather_launch(cols, valids, idx, live, counter) \
        -> Tuple[List[torch.Tensor], List[Optional[torch.Tensor]]]:
    n = idx.shape[0]
    device = idx.device
    table_rows = cols[0].shape[0]
    live = _gather_live(live, n, table_rows, device)
    outs = [torch.empty(n, dtype=c.dtype, device=device) for c in cols]
    out_valids = [live if v is None else
                  torch.empty(n, dtype=torch.bool, device=device)
                  for v in valids]
    if n == 0:
        return outs, out_valids
    lib = _gather_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    for lo in range(0, len(cols), MAX_GATHER_COLS):
        args = _GatherArgs()
        for k, c in enumerate(cols[lo:lo + MAX_GATHER_COLS]):
            v = valids[lo + k]
            args.src[k] = c.data_ptr() if table_rows else None
            args.dst[k] = outs[lo + k].data_ptr()
            args.width[k] = c.element_size()
            if v is not None:
                args.src_valid[k] = v.data_ptr() if table_rows else None
                args.dst_valid[k] = out_valids[lo + k].data_ptr()
        args.n_cols = len(cols[lo:lo + MAX_GATHER_COLS])
        args.idx = idx.data_ptr()
        args.live = None if live is None else live.data_ptr()
        args.n = n
        args.table_rows = table_rows
        err = lib.spark_gather_launch(ctypes.addressof(args), stream)
        if err != 0:
            raise RuntimeError(f"gather kernel launch failed: cudaError "
                               f"{err}")
        counter.launches += 1
    return outs, out_valids


def gather_rows(cols: Sequence[torch.Tensor],
                valids: Sequence[Optional[torch.Tensor]],
                idx: torch.Tensor, live: Optional[torch.Tensor] = None) \
        -> Tuple[List[torch.Tensor], List[Optional[torch.Tensor]]]:
    """Engine edition: gather every column (and its validity) by ``idx``
    in one launch, zero where ``live`` is False. A CPU input takes the
    plain version; a CUDA input launches the kernel."""
    if _on_cpu(list(cols) + list(valids) + [idx, live]):
        return gather_rows_torch(cols, valids, idx, live)
    _check_gather_inputs(cols, valids, idx, live)
    return _gather_launch(list(cols), list(valids), idx, live, gather_rows)


gather_rows.launches = 0


def gather_torch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``gather_xla`` in plain PyTorch."""
    return gather_rows_torch([table], [None], idx)[0][0]


def gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K4-contract edition: ``gather_xla(table, idx)`` for a table of a
    4-byte type and int32 indices of any length."""
    if _on_cpu([table, idx]):
        return gather_torch(table, idx)
    if table.element_size() != 4:
        raise ValueError(f"gather takes a table of a 4-byte type, got "
                         f"{table.dtype}")
    _check_gather_inputs([table], [None], idx, None)
    return _gather_launch([table], [None], idx, None, gather)[0][0]


gather.launches = 0


# --- K2: filter -> product -> sum per group ---------------------------------

FUSED_AGG_GROUPS = 8
_GROUP_SLOTS = FUSED_AGG_GROUPS + 1  # and the null key's slot
_KEY_TYPES = {torch.int32: 0, torch.int64: 1}


def fused_filter_agg_torch(key, q, p, d, s) -> torch.Tensor:
    """``fused_filter_agg_xla`` in plain PyTorch: q6's mask in IEEE order,
    ``p * d`` where it holds, summed in float32 per key ``g`` in 0..7."""
    keep = torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
    cols = [q, p, d, s]
    for leaf in Q6_SPEC.leaves:
        keep &= _compare(cols[leaf.slot].to(torch.float64), leaf.op,
                         leaf.bound, nan_greatest=False)
    vals = torch.where(keep, p * d, torch.zeros((), dtype=torch.float32,
                                                device=q.device))
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    return torch.stack([torch.where(key == g, vals, zero).sum(
        dtype=torch.float32) for g in range(FUSED_AGG_GROUPS)])


def filter_product_group_sum_torch(
        cols: Sequence[torch.Tensor], valids: Sequence[Optional[torch.Tensor]],
        selection: Optional[torch.Tensor], row_count: int,
        spec: FilterProductSum, key: torch.Tensor,
        key_valid: Optional[torch.Tensor], base: int, groups: int) \
        -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The engine edition's function in plain PyTorch: per slot (the
    groups ``base .. base + groups - 1``, then the null key) the float64
    sum of ``a * b`` over the passing rows whose product is non-null,
    their count, and the count of passing rows; and the count of passing
    rows whose key is outside the groups."""
    n = cols[0].shape[0]
    dev = cols[0].device
    keep = torch.arange(n, device=dev) < row_count
    if selection is not None:
        keep &= selection
    for leaf in spec.leaves:
        v = valids[leaf.slot]
        if v is not None:
            keep &= v
        keep &= _compare(cols[leaf.slot].to(torch.float64), leaf.op,
                         leaf.bound, nan_greatest=True)
    prod_ok = torch.ones(n, dtype=torch.bool, device=dev)
    for slot in (spec.a_slot, spec.b_slot):
        if valids[slot] is not None:
            prod_ok &= valids[slot]
    prod = (cols[spec.a_slot] * cols[spec.b_slot]).to(torch.float64)
    g = key.to(torch.int64) - base
    in_range = (g >= 0) & (g < groups)
    null_key = torch.zeros(n, dtype=torch.bool, device=dev) \
        if key_valid is None else ~key_valid
    slot = torch.where(null_key, torch.full_like(g, groups),
                       torch.where(in_range, g, torch.full_like(g, -1)))
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    sums, nonnull, rows = [], [], []
    for q in range(groups + 1):
        m = keep & (slot == q)
        sums.append(torch.where(m & prod_ok, prod, zero).sum())
        nonnull.append((m & prod_ok).sum(dtype=torch.int64))
        rows.append(m.sum(dtype=torch.int64))
    oor = (keep & (slot < 0)).sum(dtype=torch.int64)
    return torch.stack(sums), torch.stack(nonnull), torch.stack(rows), oor


class _FfaArgs(ctypes.Structure):
    """Mirror of ``FfaArgs`` in the CUDA source."""
    _fields_ = [("col", ctypes.c_void_p * MAX_SLOTS),
                ("valid", ctypes.c_void_p * MAX_SLOTS),
                ("sel", ctypes.c_void_p),
                ("key", ctypes.c_void_p),
                ("key_valid", ctypes.c_void_p),
                ("row_count", ctypes.c_int64),
                ("base", ctypes.c_int64),
                ("col_type", ctypes.c_int32 * MAX_SLOTS),
                ("key_type", ctypes.c_int32),
                ("groups", ctypes.c_int32),
                ("n_leaves", ctypes.c_int32),
                ("a_slot", ctypes.c_int32),
                ("b_slot", ctypes.c_int32),
                ("aligned", ctypes.c_int32),
                ("leaf", _Leaf * MAX_LEAVES)]


def _ffa_library():
    from ._build import load
    lib = load("fused_filter_agg")
    if not getattr(lib, "_spark_ready", False):
        for fn in (lib.spark_ffa_args_size, lib.spark_ffa_max_blocks,
                   lib.spark_ffa_group_slots, lib.spark_ffa_counts):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        lib.spark_ffa_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8
        lib.spark_ffa_launch.restype = ctypes.c_int
        if lib.spark_ffa_args_size() != ctypes.sizeof(_FfaArgs) \
                or lib.spark_ffa_group_slots() != _GROUP_SLOTS \
                or lib.spark_ffa_counts() != _FFA_COUNTS:
            raise RuntimeError(
                f"FfaArgs is {lib.spark_ffa_args_size()} bytes in the CUDA "
                f"source but {ctypes.sizeof(_FfaArgs)} in ctypes")
        lib._spark_ready = True
    return lib


_FFA_COUNTS = 2 * _GROUP_SLOTS + 1  # non-null, rows, outside


def _check_key(key, key_valid, n, groups, device):
    if key.dtype not in _KEY_TYPES or key.dim() != 1 \
            or key.shape[0] != n or not key.is_contiguous() \
            or key.device != device:
        raise ValueError(f"the key must be a contiguous 1-D int32 or int64 "
                         f"tensor of length {n} on {device}")
    if key_valid is not None and (
            key_valid.dtype != torch.bool or key_valid.shape != key.shape
            or not key_valid.is_contiguous()
            or key_valid.device != device):
        raise ValueError("the key's validity must be a contiguous bool "
                         "tensor as long as the key")
    if not 1 <= groups <= FUSED_AGG_GROUPS:
        raise ValueError(f"groups must be 1..{FUSED_AGG_GROUPS}, got "
                         f"{groups}")


def _ffa_launch(edition: int, cols, valids, selection, row_count: int,
                spec: FilterProductSum, key, key_valid, base: int,
                groups: int, acc: torch.dtype):
    lib = _ffa_library()
    device = cols[0].device
    args = _FfaArgs()
    for k, c in enumerate(cols):
        args.col[k] = c.data_ptr()
        args.col_type[k] = _COL_TYPES[c.dtype]
        v = valids[k]
        args.valid[k] = None if v is None else v.data_ptr()
    args.sel = None if selection is None else selection.data_ptr()
    args.key = key.data_ptr()
    args.key_valid = None if key_valid is None else key_valid.data_ptr()
    args.key_type = _KEY_TYPES[key.dtype]
    args.row_count = row_count
    args.base = base
    args.groups = groups
    args.n_leaves = len(spec.leaves)
    args.a_slot, args.b_slot = spec.a_slot, spec.b_slot
    for j, leaf in enumerate(spec.leaves):
        args.leaf[j] = _Leaf(float(leaf.bound), leaf.slot, OPS[leaf.op])
    # the 4-row loop wants 16-byte columns and key, 4-byte masks
    wide = list(cols) + [key]
    masks = [t for t in list(valids) + [selection, key_valid]
             if t is not None]
    args.aligned = int(all(t.data_ptr() % 16 == 0 for t in wide)
                       and all(t.data_ptr() % 4 == 0 for t in masks))

    def empty(count, dtype):
        return torch.empty(count, dtype=dtype, device=device)

    outs = (empty(_GROUP_SLOTS, acc), empty(_GROUP_SLOTS, torch.int64),
            empty(_GROUP_SLOTS, torch.int64), empty((), torch.int64))
    stream = torch.cuda.current_stream(device)
    blocks = lib.spark_ffa_max_blocks()
    work = _stream_workspace("k2", device, stream, lambda: (
        torch.empty(blocks * _GROUP_SLOTS, dtype=torch.float64,
                    device=device),
        torch.empty(blocks * _FFA_COUNTS, dtype=torch.int64, device=device),
        torch.zeros(1, dtype=torch.int32, device=device)))
    err = lib.spark_ffa_launch(
        ctypes.addressof(args), edition, *[t.data_ptr() for t in work],
        *[t.data_ptr() for t in outs], stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_filter_agg kernel launch failed: "
                           f"cudaError {err}")
    return outs


def filter_product_group_sum(
        cols: Sequence[torch.Tensor], valids: Sequence[Optional[torch.Tensor]],
        selection: Optional[torch.Tensor], row_count: int,
        spec: FilterProductSum, key: torch.Tensor,
        key_valid: Optional[torch.Tensor], base: int, groups: int) \
        -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's engine edition: ``(sums float64[groups + 1], non-null counts,
    row counts, out-of-range count)`` as ``filter_product_group_sum_torch``
    defines them. A CPU input takes the plain version; a CUDA input
    launches the kernel."""
    if _on_cpu(list(cols) + list(valids) + [selection, key, key_valid]):
        return filter_product_group_sum_torch(
            cols, valids, selection, row_count, spec, key, key_valid, base,
            groups)
    _check_inputs(cols, valids, selection, row_count, spec, cols[0].device)
    _check_key(key, key_valid, cols[0].shape[0], groups, cols[0].device)
    sums, nonnull, rows, oor = _ffa_launch(
        _ENGINE, cols, valids, selection, row_count, spec, key, key_valid,
        base, groups, torch.float64)
    filter_product_group_sum.launches += 1
    k = groups + 1
    return sums[:k], nonnull[:k], rows[:k], oor


filter_product_group_sum.launches = 0


def fused_filter_agg(key, q, p, d, s) -> torch.Tensor:
    """K2-contract edition: ``fused_filter_agg_xla``'s float32 sums over
    the 8 groups, for an int32 key and any length."""
    cols = [q, p, d, s]
    if _on_cpu(cols + [key]):
        return fused_filter_agg_torch(key, q, p, d, s)
    if not (q.dtype == p.dtype == d.dtype == torch.float32
            and s.dtype == torch.int32 and key.dtype == torch.int32):
        raise ValueError("fused_filter_agg takes an int32 key, float32 q, "
                         "p, d and int32 s")
    _check_inputs(cols, [None] * 4, None, q.shape[0], Q6_SPEC, q.device)
    _check_key(key, None, q.shape[0], FUSED_AGG_GROUPS, q.device)
    sums = _ffa_launch(_CONTRACT, cols, [None] * 4, None, q.shape[0],
                       Q6_SPEC, key, None, 0, FUSED_AGG_GROUPS,
                       torch.float32)[0]
    fused_filter_agg.launches += 1
    return sums[:FUSED_AGG_GROUPS]


fused_filter_agg.launches = 0
