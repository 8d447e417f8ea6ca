"""The process group a join runs over, and its collectives.

Stands in for ``tpu_radix_join/parallel/mesh.py`` (``make_mesh``) and the
collectives the JAX pipeline calls inside ``shard_map``: ``psum`` and
``pmax`` (``all_reduce``), ``all_gather``, the dense block ``all_to_all``
(``window.block_all_to_all``) and ``axis_index`` (``rank``).

  * :class:`OneRankWorld` — the one-GPU join: rank 0 of 1, every collective
    an identity, no process group.
  * :class:`DistWorld` — a ``torch.distributed`` process group of N ranks,
    one GPU each (NCCL), or host CPUs (gloo) when the caller asked for
    ``device="cpu"``.  ``parallel/multihost.initialize`` starts the group.

Lanes are int32 tensors of uint32 bits, and neither NCCL nor gloo has a
uint32: sums travel as int64 (the callers widen), lanes travel as their
bits.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

#: reduction ops of :meth:`DistWorld.all_reduce`
_OPS = ("sum", "max")


def _check_block(x: torch.Tensor, size: int, block: int) -> None:
    if x.shape[0] != size * block:
        raise ValueError(
            f"all_to_all: leading axis of {x.shape[0]} must equal "
            f"size * block = {size} * {block}")


class OneRankWorld:
    """The world of a one-GPU join: rank 0 of 1."""

    size = 1
    rank = 0

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (``psum``) or max (``pmax``) over ranks."""
        if op not in _OPS:
            raise ValueError(f"all_reduce op must be one of {_OPS}, not {op!r}")
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[size, *x.shape]: every rank's ``x`` in rank order."""
        return x.unsqueeze(0)

    def all_to_all(self, x: torch.Tensor, block: int) -> torch.Tensor:
        """Deliver block j of ``x``'s leading [size * block] axis to rank j
        (``block_all_to_all``, fused mode)."""
        _check_block(x, self.size, block)
        return x


class DistWorld:
    """A join's world over a ``torch.distributed`` process group.

    ``counts`` tallies the collectives issued per kind (``all_reduce``,
    ``all_gather``, ``all_to_all``), so a run can show which ones its path
    went through.  Every rank must issue the same collectives in the same
    order: a caller decides on the host only from values that were
    all-reduced."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError(
                "no torch.distributed process group: start one with "
                "tpu_radix_join_torch.parallel.multihost.initialize")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        self.counts: Dict[str, int] = {"all_reduce": 0, "all_gather": 0,
                                       "all_to_all": 0}

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (``psum``) or max (``pmax``) over ranks, out of place."""
        if op not in _OPS:
            raise ValueError(f"all_reduce op must be one of {_OPS}, not {op!r}")
        out = x.clone()
        dist.all_reduce(out, dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=self.group)
        self.counts["all_reduce"] += 1
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[size, *x.shape]: every rank's ``x`` in rank order (the list form
        of ``all_gather``, which every backend and torch version takes)."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        self.counts["all_gather"] += 1
        return torch.stack(parts)

    def all_to_all(self, x: torch.Tensor, block: int) -> torch.Tensor:
        """Deliver block j of ``x``'s leading [size * block] axis to rank j;
        rank i's block lands at [i * block, (i + 1) * block) of every
        receiver's output (``all_to_all_single`` with equal splits)."""
        _check_block(x, self.size, block)
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        self.counts["all_to_all"] += 1
        return out


def make_world(num_nodes: int, group=None):
    """The world of ``num_nodes`` ranks: a :class:`OneRankWorld` for one
    rank and no group, else a :class:`DistWorld` over ``group`` (a
    ``torch.distributed`` process group, or ``torch.distributed.group.WORLD``
    for the default one), whose size must be ``num_nodes``."""
    if group is None:
        if num_nodes != 1:
            raise ValueError(
                f"num_nodes={num_nodes} needs a torch.distributed process "
                f"group of {num_nodes} ranks: start one with "
                "tpu_radix_join_torch.parallel.multihost.initialize and pass "
                "it as group=")
        return OneRankWorld()
    world = DistWorld(group)
    if world.size != num_nodes:
        raise ValueError(f"num_nodes={num_nodes} but the process group has "
                         f"{world.size} ranks")
    return world
