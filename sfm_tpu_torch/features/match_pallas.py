"""K1: the fused Hamming matcher (``csrc/match.cu``) and its plain version.

The CUDA kernel replaces the Pallas TPU kernel
``sfm_tpu/features/match_pallas.py::_matcher_kernel``.  Per source row it
returns the best target index (lowest on ties), the best and second-best
masked distances, and per target the minimum key ``(dist << 32) | row``
over the sources that pass the distance cap and ratio test and pick that
target.  ``match_features_pallas`` turns these into a ``MatchResult``.

Dispatch: a CPU tensor runs ``hamming_match_plain``; a CUDA tensor
launches the kernel or raises."""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from .bits import unpack_bits
from .match import INF, MatchResult

_KEY_NONE = torch.iinfo(torch.int64).max


def hamming_match_plain(desc_s, ctr_s, valid_s, desc_t, xy_t, valid_t,
                        min_r2: float, max_r2: float, max_d: float,
                        ratio: float):
    """Batched plain version.  desc_s [B, Ns, W] int32, ctr_s [B, Ns, 2]
    window centres, valid_s [B, Ns] bool; targets likewise with Nt rows.
    Returns (idx int32 [B, Ns], best f32 [B, Ns], second f32 [B, Ns],
    keys int64 [B, Nt])."""
    a = unpack_bits(desc_s)
    b = unpack_bits(desc_t)
    # |a| + |b| - 2 a.b on {0,1} bitplanes: exact in f32 (sums < 2^24)
    inner = torch.bmm(a, b.transpose(1, 2))
    D = a.sum(-1)[:, :, None] + b.sum(-1)[:, None, :] - 2.0 * inner
    dx = ctr_s[:, :, None, 0] - xy_t[:, None, :, 0]
    dy = ctr_s[:, :, None, 1] - xy_t[:, None, :, 1]
    d2 = dx * dx + dy * dy
    feasible = ((d2 >= min_r2) & (d2 <= max_r2)
                & valid_s[:, :, None] & valid_t[:, None, :])
    Dm = torch.where(feasible, D, torch.full_like(D, INF))
    idx = torch.argmin(Dm, dim=-1)                     # first minimum
    best = torch.gather(Dm, -1, idx[..., None])[..., 0]
    second = Dm.scatter(-1, idx[..., None], INF).amin(-1)
    ok = (best <= max_d) & (best < ratio * second) & valid_s
    rows = torch.arange(desc_s.shape[1], device=desc_s.device)
    key = torch.where(ok, (best.to(torch.int64) << 32) | rows, _KEY_NONE)
    keys = torch.full((desc_t.shape[0], desc_t.shape[1]), _KEY_NONE,
                      dtype=torch.int64, device=desc_s.device)
    keys = keys.scatter_reduce(1, idx, key, reduce="amin")
    return idx.to(torch.int32), best, second, keys


def hamming_match_kernel(desc_s, ctr_s, valid_s, desc_t, xy_t, valid_t,
                         min_r2: float, max_r2: float, max_d: float,
                         ratio: float):
    """The CUDA kernel (same contract as ``hamming_match_plain``)."""
    B, Ns = desc_s.shape[:2]
    Nt = desc_t.shape[1]
    if B < 1 or Ns < 1 or Nt < 1:
        raise ValueError(f"hamming_match: empty batch {B} x {Ns} x {Nt}")
    native.require_cuda("desc_s", desc_s, torch.int32, (B, Ns, 16))
    native.require_cuda("ctr_s", ctr_s, torch.float32, (B, Ns, 2))
    native.require_cuda("valid_s", valid_s, torch.bool, (B, Ns))
    native.require_cuda("desc_t", desc_t, torch.int32, (B, Nt, 16))
    native.require_cuda("xy_t", xy_t, torch.float32, (B, Nt, 2))
    native.require_cuda("valid_t", valid_t, torch.bool, (B, Nt))
    dev = desc_s.device
    for name, t in (("ctr_s", ctr_s), ("valid_s", valid_s),
                    ("desc_t", desc_t), ("xy_t", xy_t),
                    ("valid_t", valid_t)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, desc_s on {dev}")
    idx = torch.empty((B, Ns), dtype=torch.int32, device=dev)
    best = torch.empty((B, Ns), dtype=torch.float32, device=dev)
    second = torch.empty((B, Ns), dtype=torch.float32, device=dev)
    keys = torch.empty((B, Nt), dtype=torch.int64, device=dev)
    lib = native.library()
    rc = lib.sfm_hamming_match(
        desc_s.data_ptr(), ctr_s.data_ptr(), valid_s.data_ptr(),
        desc_t.data_ptr(), xy_t.data_ptr(), valid_t.data_ptr(),
        B, Ns, Nt, min_r2, max_r2, max_d, ratio,
        idx.data_ptr(), best.data_ptr(), second.data_ptr(), keys.data_ptr(),
        native.stream_handle(dev))
    native.check(rc, "hamming_match")
    native.LAUNCHES["hamming_match"] += 1
    return idx, best, second, keys


def hamming_match(desc_s, ctr_s, valid_s, desc_t, xy_t, valid_t,
                  min_r2, max_r2, max_d, ratio):
    """K1 dispatch: the kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    if desc_s.is_cuda:
        return hamming_match_kernel(desc_s, ctr_s, valid_s, desc_t, xy_t,
                                    valid_t, min_r2, max_r2, max_d, ratio)
    if desc_s.device.type != "cpu":
        raise ValueError(f"hamming_match: unsupported device {desc_s.device}")
    return hamming_match_plain(desc_s, ctr_s, valid_s, desc_t, xy_t,
                               valid_t, min_r2, max_r2, max_d, ratio)


def _f32(x: float) -> float:
    return float(np.float32(x))


def match_features_pallas(desc0, xy0, valid0, desc1, xy1, valid1, *,
                          min_radius=0.0, max_radius=1e9, max_distance=90.0,
                          ratio=0.8, window_center0=None) -> MatchResult:
    """Match sources 0 -> targets 1 through K1.  Inputs are [N, ...] or
    batched [B, N, ...] (the counterpart of the JAX package's vmapped
    calls: one launch for the whole batch)."""
    batched = desc0.dim() == 3
    if not batched:
        desc0, xy0, valid0, desc1, xy1, valid1 = (
            t[None] for t in (desc0, xy0, valid0, desc1, xy1, valid1))
        if window_center0 is not None:
            window_center0 = window_center0[None]
    centers = xy0 if window_center0 is None else window_center0
    # thresholds rounded to f32 once, as the reference's f32 compares do
    min_r2 = _f32(min_radius * min_radius)
    max_r2 = _f32(max_radius * max_radius)
    max_d = _f32(max_distance)
    ratio = _f32(ratio)
    idx, best, second, keys = hamming_match(
        desc0.contiguous(), centers.contiguous().float(),
        valid0.contiguous(), desc1.contiguous(), xy1.contiguous().float(),
        valid1.contiguous(), min_r2, max_r2, max_d, ratio)
    ok = (best <= max_d) & (best < ratio * second) & valid0
    rows = torch.arange(desc0.shape[1], device=desc0.device)
    key = (best.to(torch.int64) << 32) | rows
    ok = ok & (key == torch.gather(keys, 1, idx.to(torch.int64)))
    res = MatchResult(idx=torch.where(ok, idx, -1),
                      dist=torch.where(ok, best, torch.full_like(best, INF)),
                      mask=ok)
    if not batched:
        res = MatchResult(*(t[0] for t in res))
    return res
