"""Conditional expressions: ``If``, ``CaseWhen``, ``Coalesce``,
``Least``, ``Greatest`` and ``NullIf``.

Counterpart of ``spark_rapids_tpu/expr/conditional.py``, the reference's
device path. SQL semantics: a null condition takes the next branch (the
ELSE in the end), a CASE without ELSE is null where no branch holds,
``coalesce`` takes the first non-null value, ``least``/``greatest``
skip nulls and order floats with NaN greatest, ``nullif(a, b)`` is null
where ``a = b``.

Where the reference selects pairwise (``_select_tpu``, ``:18``) and
copies a string result's bytes at every step (``_copy_ragged``,
``:40``), the port first picks each row's branch (an index a row), then
builds the result once: a fixed-width lane by ``torch.where``, a string
by gathering each row's start and length from its branch and copying
the bytes from the branches' concatenated chars
(``ops/strings.assemble_strings``). Nothing is read back: the result's
char capacity is a host-known bound, the smaller of the branches' char
capacities summed and, where every branch is a string literal (or a
CASE of them), the batch's capacity times the longest literal.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .. import datatypes as dt
from ..columnar.column import GpuColumnVector, is_string_like
from ..ops.strings import assemble_strings
from .base import Expression, Literal

__all__ = ["If", "CaseWhen", "Coalesce", "Least", "Greatest", "NullIf",
           "row_length_bound"]


def row_length_bound(e: Expression) -> Optional[int]:
    """The longest string a row of ``e`` can hold, when the plan alone
    tells it: a literal's length, or the longest of a conditional's
    values. None otherwise."""
    if isinstance(e, Literal):
        raw = e.string_bytes
        return 0 if raw is None else len(raw)
    if isinstance(e, (If, CaseWhen, Coalesce, NullIf)):
        bounds = [row_length_bound(v) for v in e.values()]
        return None if None in bounds else max(bounds, default=0)
    return None


def _true(col: GpuColumnVector) -> torch.Tensor:
    """Rows where a boolean column is true and not null."""
    return col.data if col.validity is None else col.data & col.validity


def _pick(cols: Sequence[GpuColumnVector], choice: torch.Tensor,
          t: dt.DataType, bound: Optional[int]) -> GpuColumnVector:
    """Row i of the result is row i of ``cols[choice[i]]``."""
    last = len(cols) - 1

    def chain(lanes):
        out = lanes[last]
        for k in reversed(range(last)):
            pick = choice == k
            # a wide decimal's lane is two words a row
            pick = pick.view(-1, *[1] * (lanes[k].dim() - 1))
            out = torch.where(pick, lanes[k], out)
        return out

    valid = None
    if any(c.validity is not None for c in cols):
        valid = chain([c.valid_mask() for c in cols])
    if not is_string_like(t):
        return GpuColumnVector(t, chain([c.data for c in cols]), valid)
    starts, base = [], 0
    for c in cols:
        starts.append(c.offsets[:-1] + base)
        base += c.chars.shape[0]
    lens = chain([c.lengths() for c in cols])
    capacity = base
    if bound is not None:
        capacity = min(capacity, choice.shape[0] * bound)
    pool = GpuColumnVector(t, None, None, cols[0].offsets,
                           torch.cat([c.chars for c in cols]))
    return assemble_strings(pool, chain(starts).contiguous(),
                            lens.contiguous(), valid, capacity)


def _same_types(what: str, values: Sequence[Expression]) -> None:
    types = {v.dtype for v in values}
    if len(types) > 1:
        raise TypeError(f"{what} values differ in type: "
                        f"{sorted(t.simple_string() for t in types)} "
                        "(insert casts first)")


class _Conditional(Expression):
    def values(self) -> List[Expression]:
        raise NotImplementedError

    @property
    def dtype(self):
        return self.values()[0].dtype


class If(_Conditional):
    def __init__(self, pred, then, els):
        self.children = (pred, then, els)

    def values(self):
        return list(self.children[1:])

    def validate(self):
        if self.children[0].dtype != dt.BOOL:
            raise TypeError("IF needs a boolean condition")
        _same_types("IF", self.values())

    def eval_gpu(self, batch, ctx):
        p = self.children[0].eval_gpu(batch, ctx)
        cols = [v.eval_gpu(batch, ctx) for v in self.values()]
        choice = torch.where(_true(p), 0, 1)
        return _pick(cols, choice, self.dtype, row_length_bound(self))


class CaseWhen(_Conditional):
    """``CASE WHEN c1 THEN v1 [WHEN c2 THEN v2 ...] [ELSE e] END``."""

    def __init__(self, branches, else_value=None):
        kids = []
        for c, v in branches:
            kids.extend([c, v])
        self.n_branches = len(branches)
        self.has_else = else_value is not None
        if self.has_else:
            kids.append(else_value)
        self.children = tuple(kids)

    def _conds(self):
        return [self.children[2 * i] for i in range(self.n_branches)]

    def values(self):
        vals = [self.children[2 * i + 1] for i in range(self.n_branches)]
        return vals + ([self.children[-1]] if self.has_else else [])

    def validate(self):
        if any(c.dtype != dt.BOOL for c in self._conds()):
            raise TypeError("CASE WHEN conditions must be boolean")
        _same_types("CASE", self.values())

    def eval_gpu(self, batch, ctx):
        cols = [v.eval_gpu(batch, ctx) for v in self.values()]
        if not self.has_else:
            cols.append(GpuColumnVector.nulls(self.dtype, batch.capacity,
                                              batch.device))
        choice = torch.full((batch.capacity,), self.n_branches,
                            dtype=torch.int64, device=batch.device)
        for k in reversed(range(self.n_branches)):
            p = self._conds()[k].eval_gpu(batch, ctx)
            choice = torch.where(_true(p), k, choice)
        return _pick(cols, choice, self.dtype, row_length_bound(self))


class Coalesce(_Conditional):
    def __init__(self, *exprs):
        if not exprs:
            raise TypeError("coalesce needs an argument")
        self.children = tuple(exprs)

    def values(self):
        return list(self.children)

    def validate(self):
        _same_types("coalesce", self.values())

    def eval_gpu(self, batch, ctx):
        cols = [v.eval_gpu(batch, ctx) for v in self.children]
        last = len(cols) - 1
        choice = torch.full((batch.capacity,), last, dtype=torch.int64,
                            device=batch.device)
        for k in reversed(range(last)):
            choice = torch.where(cols[k].valid_mask(), k, choice)
        return _pick(cols, choice, self.dtype, row_length_bound(self))


class _MinMaxN(_Conditional):
    """least/greatest: nulls skipped, null only when every value is;
    NaN greatest (Spark's float order)."""
    is_greatest = False

    def __init__(self, *exprs):
        self.children = tuple(exprs)

    def values(self):
        return list(self.children)

    def validate(self):
        _same_types(type(self).__name__.lower(), self.values())
        t = self.dtype
        # a Decimal64 orders as its unscaled lane once the analyzer has
        # given every argument one type
        if not (dt.is_integral(t) or dt.is_floating(t)
                or isinstance(t, (dt.DateType, dt.TimestampType))
                or (isinstance(t, dt.DecimalType)
                    and not dt.is_wide_decimal(t))):
            raise NotImplementedError(
                f"{type(self).__name__.lower()} over {t.simple_string()} "
                "is not ported yet (ROADMAP item 13)")

    def eval_gpu(self, batch, ctx):
        cols = [e.eval_gpu(batch, ctx) for e in self.children]
        acc_d, acc_v = cols[0].data, cols[0].valid_mask()
        for c in cols[1:]:
            if dt.is_floating(self.dtype):
                inf = torch.full_like(acc_d, float("inf"))
                a_key = torch.where(torch.isnan(acc_d), inf, acc_d)
                c_key = torch.where(torch.isnan(c.data), inf, c.data)
            else:
                a_key, c_key = acc_d, c.data
            take_c = c_key > a_key if self.is_greatest else c_key < a_key
            cv = c.valid_mask()
            acc_d = torch.where(acc_v & cv & take_c, c.data,
                                torch.where(acc_v, acc_d, c.data))
            acc_v = acc_v | cv
        return GpuColumnVector(self.dtype, acc_d, acc_v)


class Least(_MinMaxN):
    is_greatest = False


class Greatest(_MinMaxN):
    is_greatest = True


class NullIf(_Conditional):
    def __init__(self, left, right):
        self.children = (left, right)

    def values(self):
        return [self.children[0]]

    def validate(self):
        _same_types("nullif", self.children)

    def eval_gpu(self, batch, ctx):
        from .predicates import EqualTo
        eq = EqualTo(*self.children).eval_gpu(batch, ctx)
        c = self.children[0].eval_gpu(batch, ctx)
        return c.with_validity(c.valid_mask() & ~_true(eq))
