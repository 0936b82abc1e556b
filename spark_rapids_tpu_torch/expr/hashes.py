"""Hash expressions: Spark's ``hash()`` (Murmur3, seed 42) and
``xxhash64()`` (XXH64, seed 42).

Counterpart of ``spark_rapids_tpu/expr/hashes.py``. Each folds its
children's values into one running seed in order (``ops/hash.py``); a
null value leaves the seed unchanged, so the result is never null. A
nested child is refused at ``validate``, as in the reference.
``Murmur3Hash`` runs on ``hash_columns``, the hash partitioning's code;
``XxHash64`` on ``xxhash64_columns``, whose string columns launch K7
(``csrc/xxhash64.cu``), one launch a string column a batch. On the CPU
both run the same torch code on CPU tensors (the plain versions).
"""
from __future__ import annotations

import torch

from .. import datatypes as dt
from ..columnar.column import GpuColumnVector
from .base import Expression

__all__ = ["Murmur3Hash", "XxHash64"]


class _HashExpr(Expression):
    def __init__(self, *children: Expression):
        if not children:
            raise ValueError(f"{self.pretty_name()} needs >= 1 argument")
        self.children = tuple(children)

    @property
    def nullable(self):
        return False

    def validate(self):
        for c in self.children:
            if dt.is_nested(c.dtype):
                raise TypeError(
                    f"{self.pretty_name()} over nested type "
                    f"{c.dtype.simple_string()} not supported")

    def _hash(self, cols):
        raise NotImplementedError

    def eval_gpu(self, batch, ctx):
        cols = [c.eval_gpu(batch, ctx) for c in self.children]
        h = self._hash(cols)
        return GpuColumnVector(self.dtype, h, torch.ones(
            h.shape[0], dtype=torch.bool, device=h.device))


class Murmur3Hash(_HashExpr):
    """hash(cols...) -> int32."""

    @property
    def dtype(self):
        return dt.INT32

    def _hash(self, cols):
        from ..ops.hash import hash_columns
        return hash_columns(cols)


class XxHash64(_HashExpr):
    """xxhash64(cols...) -> int64."""

    @property
    def dtype(self):
        return dt.INT64

    def _hash(self, cols):
        from ..ops.hash import xxhash64_columns
        return xxhash64_columns(cols)
