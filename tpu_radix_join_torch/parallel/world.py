"""The process group a join runs over, and its collectives.

Stands in for ``tpu_radix_join/parallel/mesh.py`` and the collectives the
JAX pipeline calls inside ``shard_map``: ``psum`` (``all_reduce``), the
dense block ``all_to_all`` (``window.block_all_to_all``) and
``axis_index`` (``rank``).  This slice knows a one-rank world only, where
each collective is an identity; a larger world raises until the
distributed slice (ROADMAP.md A7) brings ``torch.distributed``.
"""

from __future__ import annotations

import torch


class OneRankWorld:
    """The world of a one-GPU join: rank 0 of 1."""

    size = 1
    rank = 0

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over ranks (``psum``)."""
        return x

    def all_to_all(self, x: torch.Tensor, block: int) -> torch.Tensor:
        """Deliver block j of ``x``'s leading [size * block] axis to rank j
        (``block_all_to_all``, fused mode)."""
        if x.shape[0] != self.size * block:
            raise ValueError(
                f"all_to_all: leading axis of {x.shape[0]} must equal "
                f"size * block = {self.size} * {block}")
        return x


def make_world(num_nodes: int) -> OneRankWorld:
    """The world of ``num_nodes`` ranks."""
    if num_nodes != 1:
        raise NotImplementedError(
            f"a {num_nodes}-rank world is not ported to PyTorch yet "
            "(ROADMAP.md A7)")
    return OneRankWorld()
