"""K1: the fused Hamming matcher (``csrc/match.cu``) and its plain version.

The CUDA kernel replaces the Pallas TPU kernel
``sfm_tpu/features/match_pallas.py::_matcher_kernel``.  Per source row it
finds the best target index (lowest on ties), the best and second-best
masked distances, and per target the minimum key ``(dist << 32) | row``
over the sources that pass the distance cap and ratio test and pick that
target; the epilogue turns these into a ``MatchResult``.

``hamming_match_plain`` / ``hamming_match_kernel`` return the raw
(idx, best, second, keys); ``match_epilogue_plain`` is the epilogue, and
``match_result_plain`` / ``match_result_kernel`` the whole function
(idx, dist, mask), which ``match_features_pallas`` calls through the
dispatch ``hamming_match``: a CPU tensor runs the plain version; a CUDA
tensor launches the kernel or raises.  On the card a call is three device
ops: the key table set to all ones (a memset), the match pass, whose rows
that pass the distance cap and the ratio test take their target's
minimum key by atomicMin, and the epilogue, one thread a row.

The match pass takes one of two routes, which ``k1_route`` picks from
the call's shape: ``cells`` for a window of at most ``WINDOW_MAX_RADIUS``
px over many pairs, where each source tests only the targets in the cells
its window touches (``window_geometry`` and ``window_cells`` mirror the
kernel's cell rule in float64, for the tests), and ``dense_int`` (XOR +
popc) for the rest.  Both give the same bits."""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import native
from .bits import unpack_bits
from .match import INF, MatchResult

_KEY_NONE = torch.iinfo(torch.int64).max

# the cells route takes windows up to this radius (px) and this many
# targets (its shared memory: 16 B a target)
WINDOW_MAX_RADIUS = 64.0
MAX_SMEM_TARGETS = 2048
# the cells route takes calls of more pairs than this
CELLS_MIN_PAIRS = 2 ** 22
# a window at least this wide (px) admits every target of any image
# (relocalization passes 1e9); the dense route then skips its masks
WINDOWLESS_RADIUS = 1e6
# the cells' side is the window radius times this (the margin over the
# f32 rounding of d2), and at least _MIN_REACH px
_REACH_SCALE = 1.0 + 2.0 ** -16
_MIN_REACH = 2.0 ** -10
_CELL_CLAMP = 2.0 ** 40
_CENTRE_MARGIN = 2.0 ** -40
# threads a call of the cells route aims for (lanes per source row =
# this / sources)
_CELLS_THREADS = 2 ** 14


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


def match_epilogue_plain(idx, best, second, keys, valid_s, max_d: float,
                         ratio: float):
    """The plain epilogue: a source matches when it passes the distance cap
    and the ratio test and holds its target's key.  Returns (idx int32
    with -1 where unmatched, dist f32 with 1e9 there, mask bool)."""
    ok = (best <= max_d) & (best < ratio * second) & valid_s
    rows = torch.arange(best.shape[1], device=best.device)
    key = (best.to(torch.int64) << 32) | rows
    ok = ok & (key == torch.gather(keys, 1, idx.to(torch.int64)))
    return (torch.where(ok, idx, -1),
            torch.where(ok, best, torch.full_like(best, INF)), ok)


def match_result_plain(desc_s, ctr_s, valid_s, desc_t, xy_t, valid_t,
                       min_r2: float, max_r2: float, max_d: float,
                       ratio: float):
    """The whole matcher, plain: (idx, dist, mask) as the kernel gives."""
    idx, best, second, keys = hamming_match_plain(
        desc_s, ctr_s, valid_s, desc_t, xy_t, valid_t, min_r2, max_r2,
        max_d, ratio)
    return match_epilogue_plain(idx, best, second, keys, valid_s, max_d,
                                ratio)


def window_geometry(max_r2: float):
    """(reach, 1 / cell side) of the cells route for a window max_r2: a
    pair whose f32 d2 <= max_r2 lies within ``reach`` on each axis (the
    f32 rounding of dx, dx * dx and the sum moves it by < 2^-21 of the
    radius; the reach adds 2^-16)."""
    reach = max(math.sqrt(max_r2) * _REACH_SCALE, _MIN_REACH)
    return reach, 1.0 / reach


def cell_of(x, inv_cell: float) -> np.ndarray:
    """The kernel's cell of coordinates x (float64 arithmetic)."""
    c = np.clip(np.asarray(x, np.float64) * inv_cell, -_CELL_CLAMP,
                _CELL_CLAMP)
    return np.floor(c).astype(np.int64)


def window_cells(c, reach: float, inv_cell: float):
    """The first and last cell a source centre coordinate c (f32 values)
    visits on its axis, as the kernel computes them."""
    c = np.asarray(c, np.float32).astype(np.float64)
    m = reach + np.abs(c) * _CENTRE_MARGIN
    return cell_of(c - m, inv_cell), cell_of(c + m, inv_cell)


def k1_route(max_r2: float, B: int, Ns: int, Nt: int) -> str:
    """The match pass's route for a window max_r2 (f32) over B x Ns x Nt
    pairs: cells for a window of at most WINDOW_MAX_RADIUS px over more
    than CELLS_MIN_PAIRS pairs (re-observation), where binning the targets
    pays for itself; the dense integer route for the rest.  On the H100
    this picks the faster route at every K1 call site of the FLAGSHIP scan
    (chip_smoke.py times both on the scan's own calls)."""
    if (Nt <= MAX_SMEM_TARGETS and math.isfinite(max_r2)
            and max_r2 <= WINDOW_MAX_RADIUS ** 2
            and B * Ns * Nt > CELLS_MIN_PAIRS):
        return "cells"
    return "dense_int"


def _route_mode(route: str, B: int, Ns: int, max_r2: float) -> int:
    """The route's launch parameter: in the cells route the lanes per
    source row (log2), a power of two from 2 to 32 giving about
    _CELLS_THREADS threads for the whole call (measured best on the H100);
    in the dense integer route 1 when the window may exclude targets, 0
    when it is wider than any image (radius >= WINDOWLESS_RADIUS), which
    skips the per-row feasibility masks."""
    if route == "dense_int":
        return int(max_r2 < WINDOWLESS_RADIUS ** 2)
    lanes = 2
    while lanes < 32 and lanes * 2 * B * Ns <= _CELLS_THREADS:
        lanes *= 2
    return lanes.bit_length() - 1


def _operand(name, t, dtype, B, inner, align):
    """(tensor, batch stride in elements) of a [B, *inner] CUDA operand.
    An expanded batch axis keeps its stride 0; an operand whose rows are
    not contiguous or not ``align``-byte aligned is copied."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != (B, *inner):
        raise ValueError(f"{name}: expected shape {(B, *inner)}, got "
                         f"{tuple(t.shape)}")
    row_strides = tuple(math.prod(inner[i + 1:]) for i in range(len(inner)))
    if (tuple(t.stride()[1:]) != row_strides or t.data_ptr() % align
            or t.stride(0) * t.element_size() % align):
        t = t.clone(memory_format=torch.contiguous_format)
    return t, t.stride(0)


def _launch(args, raw: bool):
    desc_s, ctr_s, valid_s, desc_t, xy_t, valid_t, min_r2, max_r2, max_d, \
        ratio = args
    B, Ns = desc_s.shape[:2]
    Nt = desc_t.shape[1]
    if B < 1 or Ns < 1 or Nt < 1:
        raise ValueError(f"hamming_match: empty batch {B} x {Ns} x {Nt}")
    dev = desc_s.device
    ops = [_operand("desc_s", desc_s, torch.int32, B, (Ns, 16), 16),
           _operand("ctr_s", ctr_s, torch.float32, B, (Ns, 2), 8),
           _operand("valid_s", valid_s, torch.bool, B, (Ns,), 1),
           _operand("desc_t", desc_t, torch.int32, B, (Nt, 16), 16),
           _operand("xy_t", xy_t, torch.float32, B, (Nt, 2), 8),
           _operand("valid_t", valid_t, torch.bool, B, (Nt,), 1)]
    for name, (t, _) in zip(("ctr_s", "valid_s", "desc_t", "xy_t",
                             "valid_t"), ops[1:]):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, desc_s on {dev}")
    route = k1_route(max_r2, B, Ns, Nt)
    reach, inv_cell = window_geometry(max_r2) if route == "cells" \
        else (0.0, 0.0)
    e = dict(device=dev)
    idx = torch.empty((B, Ns), dtype=torch.int32, **e)
    best = torch.empty((B, Ns), dtype=torch.float32, **e)
    second = torch.empty((B, Ns), dtype=torch.float32, **e)
    keys = torch.empty((B, Nt), dtype=torch.int64, **e)
    res = () if raw else (torch.empty((B, Ns), dtype=torch.int32, **e),
                          torch.empty((B, Ns), dtype=torch.float32, **e),
                          torch.empty((B, Ns), dtype=torch.bool, **e))
    flat = [x for t, bs in ops for x in (t.data_ptr(), bs)]
    lib = native.library()
    stream = native.stream_handle(dev)
    rc = lib.sfm_hamming_match(
        *flat, B, Ns, Nt, min_r2, max_r2, max_d, ratio,
        int(route == "cells"), _route_mode(route, B, Ns, max_r2), reach,
        inv_cell, idx.data_ptr(),
        best.data_ptr(), second.data_ptr(), keys.data_ptr(),
        *([None] * 3 if raw else [t.data_ptr() for t in res]),
        stream)
    native.check(rc, "hamming_match")
    native.count_launch("hamming_match", stream)
    return (idx, best, second, keys) if raw else res


def hamming_match_kernel(desc_s, ctr_s, valid_s, desc_t, xy_t, valid_t,
                         min_r2: float, max_r2: float, max_d: float,
                         ratio: float):
    """The CUDA kernel (same contract as ``hamming_match_plain``)."""
    return _launch((desc_s, ctr_s, valid_s, desc_t, xy_t, valid_t, min_r2,
                    max_r2, max_d, ratio), raw=True)


def match_result_kernel(desc_s, ctr_s, valid_s, desc_t, xy_t, valid_t,
                        min_r2: float, max_r2: float, max_d: float,
                        ratio: float):
    """The CUDA kernel (same contract as ``match_result_plain``)."""
    return _launch((desc_s, ctr_s, valid_s, desc_t, xy_t, valid_t, min_r2,
                    max_r2, max_d, ratio), raw=False)


def hamming_match(desc_s, ctr_s, valid_s, desc_t, xy_t, valid_t,
                  min_r2, max_r2, max_d, ratio):
    """K1 dispatch: (idx, dist, mask) from the kernel for a CUDA tensor,
    from the plain version for a CPU tensor."""
    if desc_s.is_cuda:
        return match_result_kernel(desc_s, ctr_s, valid_s, desc_t, xy_t,
                                   valid_t, min_r2, max_r2, max_d, ratio)
    if desc_s.device.type != "cpu":
        raise ValueError(f"hamming_match: unsupported device {desc_s.device}")
    return match_result_plain(desc_s, ctr_s, valid_s, desc_t, xy_t,
                              valid_t, min_r2, max_r2, max_d, ratio)


def _f32(x: float) -> float:
    return float(np.float32(x))


def match_features_pallas(desc0, xy0, valid0, desc1, xy1, valid1, *,
                          min_radius=0.0, max_radius=1e9, max_distance=90.0,
                          ratio=0.8, window_center0=None) -> MatchResult:
    """Match sources 0 -> targets 1 through K1.  Inputs are [N, ...] or
    batched [B, N, ...] (the counterpart of the JAX package's vmapped
    calls: one match pass for the whole batch; an expanded operand is
    passed with batch stride 0, not copied)."""
    batched = desc0.dim() == 3
    if not batched:
        desc0, xy0, valid0, desc1, xy1, valid1 = (
            t[None] for t in (desc0, xy0, valid0, desc1, xy1, valid1))
        if window_center0 is not None:
            window_center0 = window_center0[None]
    centers = xy0 if window_center0 is None else window_center0
    # thresholds rounded to f32 once, as the reference's f32 compares do
    res = MatchResult(*hamming_match(
        desc0, centers.float(), valid0, desc1, xy1.float(), valid1,
        _f32(min_radius * min_radius), _f32(max_radius * max_radius),
        _f32(max_distance), _f32(ratio)))
    if not batched:
        res = MatchResult(*(t[0] for t in res))
    return res
