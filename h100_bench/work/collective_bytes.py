"""Bytes a data-parallel all-reduce must move over each card's links, and
the rate of those links: the bound of the gradient all-reduce.

A ring all-reduce of ``n_bytes`` over ``n`` ranks is a reduce-scatter and
an all-gather: each rank sends, and receives, ``n - 1`` chunks of
``n_bytes / n`` in each, ``2 (n - 1) / n x n_bytes`` in all (NCCL's "bus
bytes", from which its tests report bus bandwidth).  The rate is one
card's NVLink in one direction.
"""

from __future__ import annotations

#: NVLink 4 of an H100 SXM5: 18 links of 25 GB/s each way, 450 GB/s per
#: direction (900 GB/s both ways; NVIDIA H100 Tensor Core GPU data sheet).
NVLINK_BYTES_PER_S = 450e9


def bus_bytes(ranks: int, n_bytes: float) -> float:
    """Bytes each rank sends in a ring all-reduce of ``n_bytes`` over
    ``ranks`` ranks: ``2 (ranks - 1) / ranks x n_bytes``."""
    return 2.0 * (ranks - 1) / ranks * n_bytes


def all_reduce_bound_s(ranks: int, n_bytes: float,
                       link_bytes_per_s: float = NVLINK_BYTES_PER_S
                       ) -> float:
    """The all-reduce's seconds at the link's rate."""
    return bus_bytes(ranks, n_bytes) / link_bytes_per_s
