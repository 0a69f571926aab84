"""Packed binary descriptor utilities.

Descriptors are [N, desc_bits // 32] int32 tensors holding the same bits as
the JAX package's uint32 words (bit b of word w is descriptor bit
w * 32 + b, LSB first).  PyTorch's uint32 supports few operations; the
kernels read the words as unsigned."""

from __future__ import annotations

import torch


def unpack_bits(packed: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[..., W] int32 -> [..., W*32] in {0, 1} (LSB-first)."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 32).to(dtype)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., B] bool / {0,1} -> [..., B//32] int32 (LSB-first)."""
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 32, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(b.to(torch.int64) << shifts, dim=-1)
    # reinterpret the unsigned 32-bit word as int32 (two's complement)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)
