"""Partition → owner-rank assignment.

Counterpart of ``tpu_radix_join/histograms/assignment_map.py``:

  * ``round_robin`` — ``p % numberOfNodes`` (AssignmentMap.cpp:41-43);
  * ``load_aware`` — greedy longest-processing-time over the combined R+S
    float32 weights: partitions in decreasing weight, each to the currently
    least-loaded rank.  Ties break as the JAX policy breaks them: a stable
    descending order (``argsort(-weight)``) and the first minimum
    (``argmin``).

Both are pure functions of the global histograms, so every rank computes
the same map.  Both stay on the histograms' device: the greedy walk is one
short step per partition, as JAX's scan is, and reads nothing back.
"""

from __future__ import annotations

import torch

from tpu_radix_join_torch.data.tuples import narrow, widen


def round_robin_assignment(num_partitions: int, num_nodes: int,
                           device="cpu") -> torch.Tensor:
    """int32 [P]: assignment[p] = p % num_nodes."""
    return (torch.arange(num_partitions, dtype=torch.int32, device=device)
            % num_nodes)


def load_aware_assignment(inner_global_hist: torch.Tensor,
                          outer_global_hist: torch.Tensor,
                          num_nodes: int) -> torch.Tensor:
    """int32 [P] greedy LPT assignment on the combined weights."""
    dev = inner_global_hist.device
    num_partitions = inner_global_hist.shape[0]
    if num_nodes == 1:
        return torch.zeros(num_partitions, dtype=torch.int32, device=dev)
    weight = (widen(inner_global_hist).to(torch.float32)
              + widen(outer_global_hist).to(torch.float32))
    order = torch.argsort(-weight, stable=True)
    heaviest_first = weight[order]
    loads = torch.zeros(num_nodes, dtype=torch.float32, device=dev)
    nodes = torch.empty(num_partitions, dtype=torch.int64, device=dev)
    for i in range(num_partitions):
        node = torch.argmin(loads).view(1)
        loads.index_add_(0, node, heaviest_first[i:i + 1])
        nodes[i:i + 1] = node
    assignment = torch.empty_like(nodes)
    assignment[order] = nodes
    return narrow(assignment)


def compute_partition_assignment(inner_global_hist: torch.Tensor,
                                 outer_global_hist: torch.Tensor,
                                 num_nodes: int,
                                 policy: str = "round_robin") -> torch.Tensor:
    """int32 [P] with values in [0, num_nodes), on the histograms' device."""
    num_partitions = inner_global_hist.shape[0]
    if policy == "round_robin":
        return round_robin_assignment(num_partitions, num_nodes,
                                      inner_global_hist.device)
    if policy == "load_aware":
        return load_aware_assignment(inner_global_hist, outer_global_hist,
                                     num_nodes)
    raise ValueError(f"unknown assignment policy {policy!r}")
