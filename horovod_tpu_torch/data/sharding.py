"""Deterministic per-rank data sharding (DistributedSampler analogue):
the port's own copy of ``horovod_tpu.data.sharding``, which is
framework-neutral numpy (the port imports nothing of the JAX package).
Rank and size default to :mod:`horovod_tpu_torch.common.basics`' world.

Semantics follow torch's ``DistributedSampler`` as used by the
reference's examples: each epoch, a seeded global permutation is split
into ``size`` disjoint strided slices; the dataset is padded by
repeating leading samples so every rank sees the same number of batches
(collectives would otherwise deadlock on ragged epochs — the same
reason torch's sampler pads).
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


def _resolve(rank: Optional[int], size: Optional[int]):
    if rank is None or size is None:
        from horovod_tpu_torch.common import basics

        if basics.is_initialized():
            rank = basics.rank() if rank is None else rank
            size = basics.size() if size is None else size
        else:
            rank = 0 if rank is None else rank
            size = 1 if size is None else size
    return rank, size


def shard_indices(
    n: int,
    epoch: int = 0,
    rank: Optional[int] = None,
    size: Optional[int] = None,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = False,
) -> np.ndarray:
    """This rank's sample indices for ``epoch`` over a dataset of ``n``.

    All ranks use the same seeded permutation (seed + epoch), so the
    union over ranks covers the dataset exactly once (up to pad/drop).
    With ``drop_remainder`` the tail that does not divide ``size`` is
    dropped; otherwise leading samples repeat as padding.
    """
    rank, size = _resolve(rank, size)
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} out of range for size {size}")
    order = (
        np.random.RandomState(seed + epoch).permutation(n)
        if shuffle
        else np.arange(n)
    )
    if drop_remainder:
        usable = (n // size) * size
        order = order[:usable]
    elif n % size:
        # Cyclic repeat up to the next multiple of size — handles any
        # pad length, including n < size (torch's sampler repeats the
        # same way so every rank gets ceil(n/size) samples).
        order = np.resize(order, ((n + size - 1) // size) * size)
    return order[rank::size]


class DistributedSampler:
    """Object form of :func:`shard_indices`, API-compatible with the
    torch sampler the reference's examples used: iterate for indices,
    ``set_epoch`` to reshuffle."""

    def __init__(self, n: int, rank: Optional[int] = None,
                 size: Optional[int] = None, shuffle: bool = True,
                 seed: int = 0, drop_remainder: bool = False):
        self.n = int(n)
        self.rank, self.size = _resolve(rank, size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __iter__(self) -> Iterator[int]:
        return iter(
            shard_indices(self.n, self.epoch, self.rank, self.size,
                          self.shuffle, self.seed, self.drop_remainder)
        )

    def __len__(self) -> int:
        if self.drop_remainder:
            return self.n // self.size
        return -(-self.n // self.size)


def iterate_sharded(
    arrays: dict,
    batch_size: int,
    epoch: int = 0,
    rank: Optional[int] = None,
    size: Optional[int] = None,
    shuffle: bool = True,
    seed: int = 0,
):
    """Yield this rank's ``batch_size`` batches (dict of numpy slices)
    for one epoch over same-length arrays. Batches that do not fill are
    dropped (static shapes: a ragged final batch would capture the
    window's step again)."""
    lengths = {k: len(v) for k, v in arrays.items()}
    if len(set(lengths.values())) != 1:
        raise ValueError(f"array lengths differ: {lengths}")
    n = next(iter(lengths.values()))
    idx = shard_indices(n, epoch, rank, size, shuffle, seed)
    for start in range(0, len(idx) - batch_size + 1, batch_size):
        sel = idx[start : start + batch_size]
        yield {k: v[sel] for k, v in arrays.items()}
