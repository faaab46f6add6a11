"""The yardstick of the collectives' roofline share: the bytes a ring
all-reduce moves over each link, and the link's peak.

A ring all-reduce of S bytes over n ranks sends 2 (n - 1) / n x S bytes out
of each rank and receives as many (a reduce-scatter and an all-gather, each
of n - 1 steps of S / n bytes), so its bus bandwidth, as NCCL's own tests
define it, is that traffic over the time. The peak is one H100 SXM's
NVLink 4 (NVIDIA's H100 data sheet: 18 links, 900 GB/s in both directions
together, 450 GB/s each way); on the card's machine ``nvidia-smi topo -m``
shows NV18 between every pair of the four cards, and a ring uses each
card's links in one direction each way round.
"""

from __future__ import annotations

NVLINK_BYTES_PER_S = 450e9      # one H100 SXM, NVLink 4 (NV18), each way


def ring_allreduce_link_bytes(nbytes: float, ranks: int) -> float:
    """Bytes each rank sends (and receives) in a ring all-reduce of
    ``nbytes`` over ``ranks`` ranks: 2 (n - 1) / n of the buffer."""
    if ranks <= 1:
        return 0.0
    return 2.0 * (ranks - 1) / ranks * nbytes


def ring_allreduce_bound_s(nbytes: float, ranks: int) -> float:
    """Least seconds of that all-reduce at the link's peak."""
    return ring_allreduce_link_bytes(nbytes, ranks) / NVLINK_BYTES_PER_S
