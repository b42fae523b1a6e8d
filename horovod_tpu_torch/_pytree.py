"""One pytree leaf order for the whole port: the JAX package's.

``jax.tree_util`` visits a plain dict's keys sorted; torch's pytree keeps
insertion order. Everything of the port that lays leaves out in an order
another process or package must agree on flattens through
:func:`flatten`: the gradient bucket plan
(:mod:`~horovod_tpu_torch.distributed.optimizer`), the checkpoint's
shard files (:mod:`~horovod_tpu_torch.checkpoint`) and the elastic
snapshots (:mod:`~horovod_tpu_torch.elastic.snapshot`). So a checkpoint
written by either package reads in the other.

A dict subclass that the JAX package registers as a pytree with sorted
keys (``horovod_tpu.models.TrainState``) has its port counterpart
registered through :func:`register_sorted_dict`: torch's pytree then
flattens it in sorted key order too (an unregistered dict subclass would
be one leaf), and :func:`flatten` sorts the dicts inside it.
"""

from __future__ import annotations

from torch.utils._pytree import register_pytree_node, tree_flatten

#: Dict subclasses registered by :func:`register_sorted_dict`.
_SORTED_DICTS: set = set()


def register_sorted_dict(cls) -> None:
    """Register the dict subclass ``cls`` with torch's pytree as the JAX
    package registers its own: children in sorted key order, the sorted
    keys as the context, unflattened as ``cls(zip(keys, values))``."""
    register_pytree_node(
        cls, lambda d: ([d[k] for k in sorted(d)], sorted(d)),
        lambda values, keys: cls(zip(keys, values)),
        serialized_type_name=f"{cls.__module__}.{cls.__qualname__}")
    _SORTED_DICTS.add(cls)


def _canonical(tree):
    """``tree`` with every plain dict (and every registered dict
    subclass) rebuilt in sorted key order (lists, tuples and named tuples
    rebuilt around their canonical items)."""
    if type(tree) is dict or type(tree) in _SORTED_DICTS:
        return type(tree)((k, _canonical(tree[k])) for k in sorted(tree))
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
