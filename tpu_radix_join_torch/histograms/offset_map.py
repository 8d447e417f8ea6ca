"""Write offsets of the shuffle: the OffsetMap.

Counterpart of ``tpu_radix_join/histograms/offset_map.py:31-67``
(``Offsets``, ``compute_offsets``), the analog of hpcjoin's
``OffsetMap.cpp:59-93``:

  * base — for each owner rank, its assigned partitions laid out in
    partition-id order; ``base[p]`` is the global count of the owner's
    earlier partitions (OffsetMap.cpp:59-73);
  * relative — this rank's exclusive prefix of the local histograms over
    the ranks below it: ``MPI_Exscan`` becomes an ``all_gather`` of the
    local histograms and a masked sum (OffsetMap.cpp:75-85);
  * absolute = base + relative (OffsetMap.cpp:87-93).

The block exchange (parallel/window.py) needs no write offsets to avoid
races; the join's ``debug_checks`` hold their invariant ``relative + local
<= global``.  Every array is an int32 lane of uint32 values, computed in
int64 and wrapped as the JAX package's uint32 arithmetic wraps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_radix_join_torch.data.tuples import narrow, widen


class Offsets(NamedTuple):
    base: torch.Tensor             # [P]    start in the owner's storage
    relative: torch.Tensor         # [P]    exclusive prefix over ranks
    absolute: torch.Tensor         # [P]    base + relative
    all_local_hists: torch.Tensor  # [N, P] the gathered local histograms


def compute_offsets(local_hist: torch.Tensor, global_hist: torch.Tensor,
                    assignment: torch.Tensor, world) -> Offsets:
    """The offsets of this rank of ``world`` (parallel/world.py), from its
    local histogram, the global one and the partition -> rank assignment.
    One ``all_gather`` of the local histograms."""
    num_p = global_hist.shape[0]
    p_idx = torch.arange(num_p, device=global_hist.device)
    owner = widen(assignment)
    same_owner = owner[None, :] == owner[:, None]                # [P, P]
    earlier = p_idx[None, :] < p_idx[:, None]                    # [P, P]
    base = torch.where(same_owner & earlier, widen(global_hist)[None, :],
                       0).sum(dim=1)
    all_hists = world.all_gather(local_hist)                     # [N, P]
    below = torch.arange(world.size, device=all_hists.device) < world.rank
    relative = torch.where(below[:, None], widen(all_hists), 0).sum(dim=0)
    return Offsets(base=narrow(base), relative=narrow(relative),
                   absolute=narrow(base + relative), all_local_hists=all_hists)
