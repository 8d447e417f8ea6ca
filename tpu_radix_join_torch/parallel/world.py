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
    With ``num_hosts = H > 1`` the ranks form a host-major ``[H, N / H]``
    grid (``parallel/mesh.py:110`` ``make_hierarchical_mesh``) and the
    block exchange takes two stages, within each host and then across the
    hosts (:func:`hierarchical_block_all_to_all`); ``all_reduce`` and
    ``all_gather`` stay on the whole group, as ``psum`` over the ``(dcn,
    ici)`` pair does.

Lanes are int32 tensors of uint32 bits, and neither NCCL nor gloo has a
uint32: sums travel as int64 (the callers widen), lanes travel as their
bits.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

#: reduction ops of :meth:`DistWorld.all_reduce`
_OPS = ("sum", "max")


#: (group, num_hosts) -> (group, intra-host subgroup, cross-host subgroup)
#: of this rank, made once a process group (:func:`_subgroups`)
_SUBGROUPS: Dict[Tuple[int, int], tuple] = {}


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

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` (a picklable host value)."""
        return obj

    def gather_objects(self, obj) -> list:
        """Every rank's ``obj`` in rank order."""
        return [obj]


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of ``x``'s leading axis to rank j of ``group``, rank i's
    chunk landing at chunk i (``all_to_all_single``, equal splits)."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def hierarchical_block_all_to_all(x: torch.Tensor, num_nodes: int,
                                  block: int, intra_group, cross_group,
                                  num_hosts: int) -> torch.Tensor:
    """Two-stage block exchange over a host-major ``[num_hosts, per_host]``
    grid (JAX ``window.hierarchical_block_all_to_all``, ``window.py:
    135-170``): destination flat id ``d = host(d) * per_host + local(d)``.

    Stage 1, within the host (``intra_group``, ranked by local index):
    the rank at local index ``l`` collects everything its host's ranks send
    to local index ``l`` of any host.  Stage 2, across the hosts
    (``cross_group``, same-local-index peers ranked by host): each host's
    aggregated row goes to its host peer once.  ``all_to_all_single``
    splits dim 0 only, so stage 1 moves the local axis to the front and
    back.  The received blocks are stacked by source flat id, as the flat
    route stacks them."""
    rest = x.shape[1:]
    per_host = num_nodes // num_hosts
    v = x.reshape((num_hosts, per_host, block) + rest)
    # [L_dest, H_dest, block] -> [L_src, H_dest, block]
    v = _all_to_all(v.transpose(0, 1).contiguous(), intra_group)
    # [H_dest, L_src, block] -> [H_src, L_src, block]
    v = _all_to_all(v.transpose(0, 1).contiguous(), cross_group)
    return v.reshape((num_nodes * block,) + rest)


def _subgroups(group, num_hosts: int):
    """(intra-host subgroup, cross-host subgroup) of this rank: host ``h``
    holds the group's ranks ``[h * L, (h + 1) * L)`` (``L = size /
    num_hosts``), and cross-host group ``l`` the ranks ``l, L + l, ...``.
    ``new_group`` is collective over the default group, so every rank makes
    all ``num_hosts + L`` groups in one order; they are made once a
    process group and ``num_hosts``."""
    key = (id(group), num_hosts)
    cached = _SUBGROUPS.get(key)
    if cached is not None and cached[0] is group:
        return cached[1:]
    # new_group ranks its members in ascending global rank, which is
    # their host-major order for a group whose own ranks ascend with them
    ranks = dist.get_process_group_ranks(
        group if group is not None else dist.group.WORLD)
    me = dist.get_rank(group)
    per_host = len(ranks) // num_hosts
    intra = cross = None
    for h in range(num_hosts):
        g = dist.new_group(ranks[h * per_host:(h + 1) * per_host])
        if me // per_host == h:
            intra = g
    for lo in range(per_host):
        g = dist.new_group(ranks[lo::per_host])
        if me % per_host == lo:
            cross = g
    _SUBGROUPS[key] = (group, intra, cross)
    return intra, cross


def clear_subgroups() -> None:
    """Forget the subgroups made for the hierarchical route (the process
    group they belong to is gone)."""
    _SUBGROUPS.clear()


class DistWorld:
    """A join's world over a ``torch.distributed`` process group.

    ``counts`` tallies the collectives issued per kind (``all_reduce``,
    ``all_gather``, ``all_to_all``; a hierarchical exchange counts once),
    so a run can show which ones its path went through.  Every rank must
    issue the same collectives in the same order: a caller decides on the
    host only from values that were all-reduced.  ``num_hosts > 1`` routes
    every block exchange through :func:`hierarchical_block_all_to_all`."""

    def __init__(self, group=None, num_hosts: int = 1):
        if not dist.is_initialized():
            raise RuntimeError(
                "no torch.distributed process group: start one with "
                "tpu_radix_join_torch.parallel.multihost.initialize")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        if num_hosts < 1 or self.size % num_hosts:
            raise ValueError(f"{self.size} ranks do not divide over "
                             f"{num_hosts} hosts")
        self.num_hosts = num_hosts
        self._hier = (_subgroups(group, num_hosts) if num_hosts > 1
                      else None)
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
        receiver's output (``all_to_all_single`` with equal splits, or the
        two stages of the hierarchical route)."""
        _check_block(x, self.size, block)
        x = x.contiguous()
        if self._hier is not None:
            out = hierarchical_block_all_to_all(x, self.size, block,
                                                *self._hier, self.num_hosts)
        else:
            out = _all_to_all(x, self.group)
        self.counts["all_to_all"] += 1
        return out


    def broadcast_object(self, obj):
        """Rank 0's ``obj`` (a picklable host value) on every rank: the
        host decisions every rank must share (a deadline's clock, a stall's
        cap) come from one rank.  Not counted in ``counts``."""
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self._global_rank(0),
                                   group=self.group)
        return box[0]

    def gather_objects(self, obj) -> list:
        """Every rank's ``obj`` (picklable host values) in rank order.  Not
        counted in ``counts``."""
        if self.size == 1:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def _global_rank(self, rank: int) -> int:
        if self.group is None or self.group is dist.group.WORLD:
            return rank
        return dist.get_global_rank(self.group, rank)


def make_world(num_nodes: int, group=None, num_hosts: int = 1):
    """The world of ``num_nodes`` ranks: a :class:`OneRankWorld` for one
    rank and no group, else a :class:`DistWorld` over ``group`` (a
    ``torch.distributed`` process group, or ``torch.distributed.group.WORLD``
    for the default one), whose size must be ``num_nodes``; with
    ``num_hosts > 1`` its exchanges take the hierarchical route."""
    if num_hosts < 1 or num_nodes % num_hosts:
        raise ValueError("num_nodes must divide evenly over num_hosts")
    if group is None:
        if num_nodes != 1:
            raise ValueError(
                f"num_nodes={num_nodes} needs a torch.distributed process "
                f"group of {num_nodes} ranks: start one with "
                "tpu_radix_join_torch.parallel.multihost.initialize and pass "
                "it as group=")
        return OneRankWorld()
    if dist.is_initialized() and dist.get_world_size(group) != num_nodes:
        raise ValueError(f"num_nodes={num_nodes} but the process group has "
                         f"{dist.get_world_size(group)} ranks")
    return DistWorld(group, num_hosts)
