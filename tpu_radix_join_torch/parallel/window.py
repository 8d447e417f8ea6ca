"""The exchange data plane: fixed-capacity blocks and a block all_to_all.

Counterpart of ``tpu_radix_join/parallel/window.py`` with ``codec="off"``
and ``mode="fused"``: every rank scatters its tuples into one
statically-sized block per destination (``ops/radix.scatter_to_blocks``,
K4), one all_to_all of each lane delivers block j to rank j, and the
per-sender valid counts ride a second, tiny all_to_all (``window.py:
235-272``).  Over a ``DistWorld`` each is one ``all_to_all_single``, or
the two stages of the hierarchical route when the world spans several
hosts (``world.hierarchical_block_all_to_all``); the receive buffers are
``size * capacity`` slots, rank i's block at ``[i * capacity, (i + 1) *
capacity)`` padded with the side's sentinel either way.  The packed codec
and the staged exchange wait for ROADMAP.md A13.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from tpu_radix_join_torch.data.tuples import TupleBatch, widen
from tpu_radix_join_torch.ops.radix import scatter_to_blocks


class ExchangeResult(NamedTuple):
    batch: TupleBatch            # received tuples, [size * capacity] lanes
    recv_counts: torch.Tensor    # int64 [size]: valid tuples from each sender
    send_overflow: torch.Tensor  # 0-d int64: local tuples dropped for capacity


class Window:
    """Per-relation exchange plane; ``capacity`` is the static
    per-(sender, destination) block size (Window.cpp:168-177 sizes it
    exactly; here it is sized ahead and overflow is reported)."""

    def __init__(self, world, capacity: int, side: str):
        """``world``: a ``OneRankWorld`` or ``DistWorld``
        (parallel/world.py)."""
        self.world = world
        self.capacity = capacity
        self.side = side

    def exchange(self, batch: TupleBatch, dest: torch.Tensor,
                 valid: Optional[torch.Tensor] = None) -> ExchangeResult:
        """Scatter into destination blocks and all_to_all them; ``dest`` is
        the int32 destination rank per tuple (= assignment[pid])."""
        n, c = self.world.size, self.capacity
        blocks, counts, overflow = scatter_to_blocks(batch, dest, n, c,
                                                     self.side, valid=valid)
        # every lane goes through the all_to_all, the hi key lane included:
        # a batch rebuilt without it would join truncated keys
        received = TupleBatch(*(None if lane is None
                                else self.world.all_to_all(lane, c)
                                for lane in blocks))
        sent_counts = torch.clamp(widen(counts), max=c)
        return ExchangeResult(received, self.world.all_to_all(sent_counts, 1),
                              overflow)

    def diagnostics(self, result: ExchangeResult, global_hist: torch.Tensor,
                    assignment: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(overflow tuples, conservation bad) as 0-d device tensors: the
        tuples senders dropped for capacity (retryable), and whether this
        rank received other than the global histogram of its assigned
        partitions (Window.cpp:180-191) — asserted only when nothing
        overflowed, since overflow already voids the equality."""
        mine = widen(assignment) == self.world.rank
        expected = torch.where(mine, widen(global_hist), 0).sum()
        lost = self.world.all_reduce(result.send_overflow)
        bad = (result.recv_counts.sum() != expected) & (lost == 0)
        return lost, bad

    def assert_all_tuples_written(self, result: ExchangeResult,
                                  global_hist: torch.Tensor,
                                  assignment: torch.Tensor) -> torch.Tensor:
        """Conservation and zero overflow (SURVEY.md §4.3), 0-d bool."""
        lost, bad = self.diagnostics(result, global_hist, assignment)
        return (lost == 0) & ~bad
