"""Descriptor matching: the contract of the reference's matcher family as
one masked argmin over Hamming distances.

Best match by Hamming distance subject to (i) a motion-radius window around
the source point (or an explicit per-source window centre), (ii) the Lowe
ratio test, (iii) an absolute distance cap, and (iv) keep-best-per-target
dedup (the lowest (distance, source row) wins each target).

Every call goes through ``match_pallas.match_features_pallas`` (kernel
K1): the JAX package's XLA matcher and its Pallas kernel are exact-equal,
so one entry serves both (the CUDA kernel on the card, its plain version
on the CPU)."""

from __future__ import annotations

from typing import NamedTuple

import torch

INF = 1e9


class MatchResult(NamedTuple):
    """Fixed-shape match output, one row per source feature."""
    idx: torch.Tensor      # [N] int32 target index, -1 if unmatched
    dist: torch.Tensor     # [N] float32 Hamming distance (INF if unmatched)
    mask: torch.Tensor     # [N] bool
