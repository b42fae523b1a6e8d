"""One pytree leaf order for the whole port: the JAX package's.

``jax.tree_util`` visits a plain dict's keys sorted; torch's pytree keeps
insertion order. Everything of the port that lays leaves out in an order
another process or package must agree on flattens through
:func:`flatten`: the gradient bucket plan
(:mod:`~horovod_tpu_torch.distributed.optimizer`), the checkpoint's
shard files (:mod:`~horovod_tpu_torch.checkpoint`) and the elastic
snapshots (:mod:`~horovod_tpu_torch.elastic.snapshot`). So a checkpoint
written by either package reads in the other.
"""

from __future__ import annotations

from torch.utils._pytree import tree_flatten


def _canonical(tree):
    """``tree`` with every plain dict rebuilt in sorted key order (lists,
    tuples and named tuples rebuilt around their canonical items)."""
    if type(tree) is dict:
        return {k: _canonical(tree[k]) for k in sorted(tree)}
    if type(tree) in (list, tuple):
        return type(tree)(_canonical(v) for v in tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_canonical(v) for v in tree))
    return tree


def flatten(tree):
    """``tree_flatten`` in the JAX package's leaf order: a plain dict's
    keys sorted. Unflattening the spec gives dicts with sorted keys, as
    JAX does."""
    return tree_flatten(_canonical(tree))
