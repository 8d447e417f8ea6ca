"""The exchange data plane: fixed-capacity blocks and a block all_to_all.

Counterpart of ``tpu_radix_join/parallel/window.py``: every rank scatters
its tuples into one statically-sized block per destination, and one
all_to_all delivers block j to rank j.  Over a ``DistWorld`` each exchange
is one ``all_to_all_single``, or the two stages of the hierarchical route
when the world spans several hosts (``world.hierarchical_block_all_to_all``);
the receive buffers are ``size * capacity`` slots, rank i's block at
``[i * capacity, (i + 1) * capacity)`` padded with the side's sentinel.

Two levers reshape the wire, as in the JAX package:

  * ``mode="staged:<k>"`` (:func:`block_all_to_all`) exchanges the block
    buffer in k column groups, one collective each, so only about 1/k of
    it is in flight; the received order equals the fused route's.
  * ``codec="pack"`` bit-packs each block to the key and rid bounds
    (``data/tuples.pack_blocks``) after a grouped scatter (K4,
    ``ops/radix.scatter_to_blocks_grouped``) and unpacks it on receipt;
    the block header carries the per-partition counts, so the count
    all_to_all of the raw exchange is not issued.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from tpu_radix_join_torch.data.tuples import (TupleBatch, WireSpec,
                                              make_wire_spec, pack_blocks,
                                              unpack_blocks, widen)
from tpu_radix_join_torch.ops.radix import (scatter_to_blocks,
                                            scatter_to_blocks_grouped)


def parse_exchange_mode(mode, block: int) -> int:
    """The stage count k >= 1 of an exchange mode (``parse_exchange_mode``,
    ``window.py:44-71``): "fused" or 1 is one collective, "staged:<k>" or
    k is k column groups, "auto" stages 4 ways once a block holds 4096
    slots.  k never exceeds the block."""
    if isinstance(mode, int):
        k = mode
    elif mode == "fused":
        k = 1
    elif mode == "auto":
        k = 4 if block >= 4096 else 1
    elif isinstance(mode, str) and mode.startswith("staged:"):
        try:
            k = int(mode.split(":", 1)[1])
        except ValueError:
            raise ValueError(
                f"exchange mode {mode!r}: the stage count after 'staged:' "
                f"must be an integer") from None
    else:
        raise ValueError(
            f"exchange mode must be 'fused', 'staged:<k>', 'auto', or an "
            f"int stage count, got {mode!r}")
    if k < 1:
        raise ValueError(f"exchange stage count must be >= 1, got {k}")
    return min(k, block) if block else k


def block_all_to_all(world, x: torch.Tensor, block: int,
                     mode="fused") -> torch.Tensor:
    """Deliver block j of ``x``'s leading [size * block] axis to rank j
    (``block_all_to_all``, ``window.py:74-119``), in ``mode``'s stages:
    k column groups of sizes ``divmod(block, k)``, each copied out once
    (``all_to_all_single`` takes contiguous buffers), exchanged by one
    ``world.all_to_all`` (hierarchical when the world spans hosts) and
    written back at its columns of the output.  The collectives run in
    program order on one stream, which sequences them as JAX's
    ``optimization_barrier`` does; only one group's copy is in flight."""
    n = world.size
    stages = parse_exchange_mode(mode, block)
    if stages == 1:
        return world.all_to_all(x, block)
    if x.shape[0] != n * block:
        raise ValueError(
            f"block_all_to_all: leading axis of {x.shape[0]} must equal "
            f"size * block = {n} * {block}")
    rest = x.shape[1:]
    v = x.view((n, block) + rest)
    out = torch.empty_like(x).view((n, block) + rest)
    base, extra = divmod(block, stages)
    off = 0
    for i in range(stages):
        g = base + (1 if i < extra else 0)
        part = v[:, off:off + g].contiguous().view((n * g,) + rest)
        out[:, off:off + g] = world.all_to_all(part, g).view((n, g) + rest)
        off += g
    return out.view(x.shape)


class ExchangeResult(NamedTuple):
    batch: TupleBatch            # received tuples, [size * capacity] lanes
    recv_counts: torch.Tensor    # int64 [size]: valid tuples from each sender
    send_overflow: torch.Tensor  # 0-d int64: local tuples dropped for capacity


class Window:
    """Per-relation exchange plane; ``capacity`` is the static
    per-(sender, destination) block size (Window.cpp:168-177 sizes it
    exactly; here it is sized ahead and overflow is reported).

    ``codec="pack"`` ships the bit-packed words of :meth:`wire_spec`'s
    geometry, with ``fanout_bits`` dropped from every key and restored from
    the headers; ``key_bound`` and ``rid_bound`` are exclusive bounds
    (None: the full lane).  ``mode`` is the staged-exchange knob of every
    collective the window issues for lanes or words."""

    def __init__(self, world, capacity: int, side: str, codec: str = "off",
                 mode="fused", fanout_bits: int = 0,
                 key_bound: Optional[int] = None,
                 rid_bound: Optional[int] = None,
                 partition_impl: str = "auto"):
        """``world``: a ``OneRankWorld`` or ``DistWorld``
        (parallel/world.py); ``partition_impl`` is the scatter's arm
        (``ops/radix``)."""
        if codec not in ("off", "pack"):
            raise ValueError(
                f"window codec must be 'off' or 'pack', got {codec!r} "
                f"('auto' must be resolved by the caller)")
        self.world = world
        self.capacity = capacity
        self.side = side
        self.codec = codec
        self.mode = mode
        self.fanout_bits = fanout_bits
        self.key_bound = key_bound
        self.rid_bound = rid_bound
        self.partition_impl = partition_impl

    def wire_spec(self, wide: bool) -> WireSpec:
        """The packed-wire geometry of this window's bounds."""
        return make_wire_spec(self.capacity, self.fanout_bits, wide=wide,
                              key_bound=self.key_bound,
                              rid_bound=self.rid_bound)

    def exchange(self, batch: TupleBatch, dest: torch.Tensor,
                 valid: Optional[torch.Tensor] = None,
                 pid: Optional[torch.Tensor] = None) -> ExchangeResult:
        """Scatter into destination blocks and all_to_all them; ``dest`` is
        the int32 destination rank per tuple (= assignment[pid]); ``pid``,
        the partition id per tuple, is what the packed codec groups by."""
        n, c = self.world.size, self.capacity
        if self.codec == "pack":
            if pid is None:
                raise ValueError(
                    "codec='pack' needs the per-tuple partition ids: the "
                    "wire drops the fanout bits and restores them from "
                    "partition membership — pass pid= to exchange()")
            spec = self.wire_spec(wide=batch.key_hi is not None)
            blocks, _, group_counts, overflow = scatter_to_blocks_grouped(
                batch, dest, pid, n, spec.num_sub, c, self.side, valid=valid,
                impl=self.partition_impl)
            words = block_all_to_all(self.world,
                                     pack_blocks(spec, blocks, group_counts),
                                     spec.block_words, self.mode)
            received, counts = unpack_blocks(spec, words, self.side)
            return ExchangeResult(received, widen(counts), overflow)
        blocks, counts, overflow = scatter_to_blocks(
            batch, dest, n, c, self.side, valid=valid,
            impl=self.partition_impl)
        # every lane goes through the all_to_all, the hi key lane included:
        # a batch rebuilt without it would join truncated keys
        received = TupleBatch(*(None if lane is None
                                else block_all_to_all(self.world, lane, c,
                                                      self.mode)
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
