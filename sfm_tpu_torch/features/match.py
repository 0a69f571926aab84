"""Descriptor matching: the contract of the reference's matcher family as
one masked argmin over Hamming distances.

Best match by Hamming distance subject to (i) a motion-radius window around
the source point (or an explicit per-source window centre), (ii) the Lowe
ratio test, (iii) an absolute distance cap, and (iv) keep-best-per-target
dedup (the lowest (distance, source row) wins each target).

Every call goes through ``match_pallas.match_features_pallas`` (kernel
K1): the JAX package's XLA matcher and its Pallas kernel are exact-equal,
so one entry serves both (the CUDA kernel on the card, its plain version
on the CPU).  ``match_pairs`` compacts a ``MatchResult`` into pair
lists."""

from __future__ import annotations

from typing import NamedTuple

import torch

INF = 1e9


class MatchResult(NamedTuple):
    """Fixed-shape match output, one row per source feature."""
    idx: torch.Tensor      # [N] int32 target index, -1 if unmatched
    dist: torch.Tensor     # [N] float32 Hamming distance (INF if unmatched)
    mask: torch.Tensor     # [N] bool


def match_pairs(result: MatchResult, cap: int):
    """Compact a MatchResult into fixed-size (idx0, idx1, valid) pair
    tensors [min(cap, N)]: the matched sources first, in source order; at
    most ``cap`` pairs survive (idx0 / idx1 -1 past the last)."""
    n = result.mask.shape[0]
    rows = torch.arange(n, device=result.mask.device)
    order = torch.where(result.mask, rows, n)
    perm = torch.sort(order, stable=True).indices[:cap]
    valid = result.mask[perm]
    idx0 = torch.where(valid, perm, -1).to(torch.int32)
    idx1 = torch.where(valid, result.idx[perm], -1)
    return idx0, idx1, valid
