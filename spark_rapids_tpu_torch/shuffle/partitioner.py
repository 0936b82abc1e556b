"""Shuffle partitioning strategies.

Counterpart of ``spark_rapids_tpu/shuffle/partitioner.py:31-95``
(``Partitioning``, ``SinglePartitioning``, ``HashPartitioning``): each
strategy gives every row a partition id on the device. Hash
partitioning is Spark's ``pmod(murmur3(keys...), n)``, bit for bit the
reference's (``ops/hash.py``), so rows land in the same partitions as on
the JAX engine and on CPU Spark. Round-robin and range partitioning wait
(ROADMAP item 10).
"""
from __future__ import annotations

from typing import Sequence

import torch

from .. import datatypes as dt
from ..columnar.batch import GpuBatch
from ..expr.base import Expression
from ..ops.hash import hash_columns, pmod

__all__ = ["Partitioning", "SinglePartitioning", "HashPartitioning"]


class Partitioning:
    """Base: maps each row to a partition id in ``[0, num_partitions)``."""

    def __init__(self, num_partitions: int):
        if num_partitions < 1:
            raise ValueError(f"{num_partitions} partitions")
        self.num_partitions = num_partitions

    def bind(self, schema: dt.Schema) -> "Partitioning":
        return self

    def partition_ids(self, batch: GpuBatch, ectx) -> torch.Tensor:
        """int32 ``(capacity,)`` partition ids; padding rows get some id,
        which the batch's live mask ignores."""
        raise NotImplementedError


class SinglePartitioning(Partitioning):
    def __init__(self):
        super().__init__(1)

    def partition_ids(self, batch, ectx):
        return torch.zeros(batch.capacity, dtype=torch.int32,
                           device=batch.device)


class HashPartitioning(Partitioning):
    """Spark's murmur3 hash partitioning: ``pmod(hash(keys...), n)``."""

    def __init__(self, key_exprs: Sequence[Expression],
                 num_partitions: int):
        super().__init__(num_partitions)
        self.key_exprs = list(key_exprs)

    def bind(self, schema: dt.Schema) -> "HashPartitioning":
        from ..exec.basic import bind_all
        return HashPartitioning(bind_all(self.key_exprs, schema),
                                self.num_partitions)

    def partition_ids(self, batch, ectx):
        cols = [e.eval_gpu(batch, ectx) for e in self.key_exprs]
        return pmod(hash_columns(cols), self.num_partitions)

    def __repr__(self):
        return (f"HashPartitioning({', '.join(map(repr, self.key_exprs))}; "
                f"n={self.num_partitions})")
