"""ZeRO-1 optimizer-state sharding over the data-parallel ranks: the port
of ``horovod_tpu.jax.zero`` in PyTorch's shape.

:func:`sharded_distributed_optimizer` wraps a torch optimizer. The
trainable parameters are grouped by dtype, and each group is one flat
vector padded to a multiple of the data axis's size ``n`` (the whole
world, or the bound mesh's data axis with ``axis_name``). Each rank owns the
``(pad / n,)`` slice of every group, as a leaf tensor of its own, and the
wrapped optimizer's class is built over those leaves with the wrapped
optimizer's hyperparameters, so the optimizer state (Adam's moments) is
``1 / n`` of the replicated one on every rank. ``step()`` runs, per dtype
group, in the JAX function's order:

1. flatten the gradients (zeros for a parameter without one);
2. compress (the wire of the reduce-scatter);
3. ``reduce_scatter_tensor`` (sum): this rank's slice of the summed
   gradient;
4. decompress;
5. divide by ``n`` (an average, with more than one rank);
6. run the wrapped optimizer on the slices;
7. ``all_gather_into_tensor`` the updated slices and copy them back into
   the parameters.

Torch optimizers write parameters, where optax returns updates: the
gathered slices are the new parameter values, where the JAX function
gathers updates and adds them, so the two round differently (a few ulp).
With one rank the update is a flat-vector local one, equal to the
unwrapped optimizer, and in a world of one the two collectives still run
(the port's convention, as in ``fusion``); a one-rank data axis of a
bound mesh runs none, as an axis of size one does across ``parallel/``.
The wrapped optimizer must be elementwise (SGD, Adam, AdamW, ...): a
transform that mixes parameters would see only its rank's slice. Its
state is rank-local, so it is never broadcast.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import InvalidArgumentError
from horovod_tpu_torch.distributed.compression import Compression
from horovod_tpu_torch.distributed.fusion import (_dtype_name,
                                                  release_grad_hooks)


def _group_by_dtype(params) -> Dict[str, List[int]]:
    """Parameter indices grouped by dtype name, in first-appearance order
    and input order within a group."""
    groups: Dict[str, List[int]] = {}
    for i, p in enumerate(params):
        groups.setdefault(_dtype_name(p.dtype), []).append(i)
    return groups


def _pad_to(total: int, n: int) -> int:
    return ((total + n - 1) // n) * n


def _data_axis(axis_name: Optional[str]):
    """``(group, size, index)`` ZeRO shards over: with a bound
    :class:`~horovod_tpu_torch.parallel.logical.LogicalMesh`, its data
    axis (``module_axis("data", axis_name)``) through
    :func:`~horovod_tpu_torch.parallel._collectives.axis_group` (group
    ``None`` for a one-rank axis); with none, the whole world, which is
    the flat data axis a ``LogicalMesh``-less JAX mesh names (the job's
    group under ``init(comm=)``)."""
    from horovod_tpu_torch.parallel._collectives import axis_group
    from horovod_tpu_torch.parallel.logical import (DATA_AXIS,
                                                    current_logical_mesh)

    if current_logical_mesh() is None:
        if axis_name not in (None, DATA_AXIS):
            raise InvalidArgumentError(
                f"sharded_distributed_optimizer(axis_name={axis_name!r}) "
                "needs a bound LogicalMesh that defines the axis")
        group = basics.job_group()
        return (dist.group.WORLD if group is None else group,
                basics.size(), basics.rank())
    return axis_group(axis_name, role="data")


class ZeroOptimizer:
    """The optimizer :func:`sharded_distributed_optimizer` returns:
    ``zero_grad()``, ``step()``, and the wrapped class's ``param_groups``
    and rank-local ``state`` over this rank's slices."""

    def __init__(self, optimizer: torch.optim.Optimizer, average: bool,
                 compression, axis_name: Optional[str] = None):
        basics.config()                   # raises before hvd.init()
        hyper = [{k: v for k, v in g.items() if k != "params"}
                 for g in optimizer.param_groups]
        if any(h != hyper[0] for h in hyper[1:]):
            raise ValueError(
                "sharded_distributed_optimizer runs one update over flat "
                "vectors, so every param group must share its "
                "hyperparameters; the groups differ")
        self._params = [p for g in optimizer.param_groups
                        for p in g["params"] if p.requires_grad]
        release_grad_hooks(self._params)
        self._average = average
        self._compression = compression or Compression.none
        self._group, self._n, self._rank = _data_axis(axis_name)
        self._groups = _group_by_dtype(self._params)
        self.pads = {key: _pad_to(sum(self._params[i].numel() for i in idxs),
                                  self._n)
                     for key, idxs in self._groups.items()}
        self._leaves = {}
        for key, idxs in self._groups.items():
            p0 = self._params[idxs[0]]
            self._leaves[key] = torch.zeros(self.pads[key] // self._n,
                                            dtype=p0.dtype, device=p0.device)
            self._load_shard(key)
        self.inner = type(optimizer)(
            [{"params": list(self._leaves.values()), **hyper[0]}])

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def _load_shard(self, key: str) -> None:
        """Copy this rank's slice of the group's parameters into its leaf
        (the JAX update reads the current parameters' slice each step)."""
        leaf = self._leaves[key]
        lo = self._rank * leaf.numel()
        hi = lo + leaf.numel()
        off = 0
        with torch.no_grad():
            for i in self._groups[key]:
                p = self._params[i]
                a, b = max(lo, off), min(hi, off + p.numel())
                if a < b:
                    leaf[a - lo:b - lo].copy_(p.reshape(-1)[a - off:b - off])
                off += p.numel()

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self._params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()
        self.inner.zero_grad(set_to_none)

    def step(self) -> None:
        """Reduce-scatter the gradients, update this rank's slices, and
        all-gather the new parameters."""
        n = self._n
        flats = {}
        for key, idxs in self._groups.items():
            params = [self._params[i] for i in idxs]
            flat = torch.cat([(p.grad if p.grad is not None
                               else torch.zeros_like(p)).reshape(-1)
                              for p in params])
            flat = F.pad(flat, (0, self.pads[key] - flat.numel()))
            wire, ctx = self._compression.compress(flat)
            if self._group is None:       # a one-rank axis of the mesh
                shard = wire.clone()
            else:
                shard = torch.empty(self.pads[key] // n, dtype=wire.dtype,
                                    device=wire.device)
                dist.reduce_scatter_tensor(shard, wire,
                                           op=dist.ReduceOp.SUM,
                                           group=self._group)
            g = self._compression.decompress(shard, ctx)
            if self._average and n > 1:
                g = g / n
            self._load_shard(key)
            self._leaves[key].grad = g
            flats[key] = flat
        issued = len(flats) if self._group is not None else 0
        sharded_distributed_optimizer.collectives += issued
        self.inner.step()
        with torch.no_grad():
            for key, flat in flats.items():
                if self._group is None:
                    flat.copy_(self._leaves[key])
                else:
                    dist.all_gather_into_tensor(flat, self._leaves[key],
                                                group=self._group)
                off = 0
                for i in self._groups[key]:
                    p = self._params[i]
                    p.copy_(flat[off:off + p.numel()].view_as(p))
                    off += p.numel()
        sharded_distributed_optimizer.collectives += issued


def sharded_distributed_optimizer(optimizer: torch.optim.Optimizer,
                                  average: bool = True,
                                  axis_name: Optional[str] = None,
                                  compression=None) -> ZeroOptimizer:
    """Wrap ``optimizer`` with ZeRO-1 sharding over the ranks (the module
    docstring). ``axis_name`` is the data axis to shard and reduce over:
    under a bound ``LogicalMesh`` its data axis by default (``dp`` in a
    ``dp=2,sp=4`` mesh, so ZeRO composes with sequence parallelism: the
    ranks of one data shard's sequence group average nothing, the
    ``reduce_grads(sp=)`` sum is theirs); with no mesh bound, the whole
    world. It is resolved when the optimizer is built. ``compression``
    (e.g. ``Compression.fp16``) applies to the
    reduce-scatter wire; the all-gather carries the parameters' dtype.
    Raises ``ValueError`` when the optimizer's param groups have different
    hyperparameters. Each collective adds one to
    ``sharded_distributed_optimizer.collectives``: two per dtype group a
    step."""
    return ZeroOptimizer(optimizer, average, compression, axis_name)


sharded_distributed_optimizer.collectives = 0


def shard_info(optimizer: ZeroOptimizer) -> Dict[str, Tuple[int, int]]:
    """``{dtype name: (padded global length, length on each rank)}``,
    over the data axis the optimizer shards over."""
    return {key: (pad, pad // optimizer._n)
            for key, pad in optimizer.pads.items()}
