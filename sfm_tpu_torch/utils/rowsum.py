"""Sums of source rows into target rows in a fixed order.

``index_add_`` on the card sums with atomics: the order in which a target's
rows meet, and so the last bits of a float sum, vary from run to run.
``RowSum`` sorts the target indices once (a stable sort: a target's rows
keep their order) and sums each target's rows with ``torch.segment_reduce``,
which uses no atomics, so the same inputs give the same bits on every run.
On the CPU the rows are summed one after another in their order, as
``index_add_`` sums them into zeros: the result equals ``index_add_``'s bit
for bit.  Build one per index (per BA problem), call it per sum."""

from __future__ import annotations

import torch


class RowSum:
    """``RowSum(index, n)(src)`` == ``src.new_zeros((n, ...)).index_add_(0,
    index, src)`` with a fixed summation order.  ``index`` [M] holds target
    rows in [0, n)."""

    def __init__(self, index: torch.Tensor, n_rows: int):
        keys, self.order = torch.sort(index.to(torch.int64), stable=True)
        bounds = torch.searchsorted(
            keys, torch.arange(n_rows + 1, device=keys.device))
        self.lengths = bounds[1:] - bounds[:-1]

    def __call__(self, src: torch.Tensor) -> torch.Tensor:
        return torch.segment_reduce(src[self.order], "sum",
                                    lengths=self.lengths, unsafe=True)


def add_rows(base: torch.Tensor, index: torch.Tensor,
             src: torch.Tensor) -> torch.Tensor:
    """``base.index_add(0, index, src)`` with a fixed summation order: each
    target starts from its row of ``base``, then adds its rows of ``src``
    in their order (on the CPU, ``index_add``'s order)."""
    n = base.shape[0]
    rows = torch.arange(n, dtype=torch.int64, device=base.device)
    return RowSum(torch.cat([rows, index.to(torch.int64)]), n)(
        torch.cat([base, src.to(base.dtype)]))
