"""Pyramidal Lucas-Kanade optical flow and the association of flow
endpoints to detected features.

``lk_flow`` tracks points coarse-to-fine through a 3-level pyramid with a
21x21 window and a fixed number of iterations per level.  All points go
through each iteration at once: one gather of [N, 22, 22] windows (the
window plus a one-pixel margin for the bilinear shift) per image and
iteration.  A window starts where the JAX package's ``lax.dynamic_slice``
starts it: a negative start counts from the far end of the axis, and the
start is then clamped so that the window lies inside the (full-size,
zero-padded) pyramid level.  Nothing is padded.

``associate_flow_to_features``: each flow endpoint takes the nearest
detected feature within ``max_dist``; a feature reached by several
endpoints keeps the closest (the lowest row on a tie)."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .detect import _down2

WIN = 21                     # LK window
_R = WIN // 2


class FlowResult(NamedTuple):
    xy: torch.Tensor       # [N, 2] tracked positions in the target frame
    valid: torch.Tensor    # [N] bool convergence status
    err: torch.Tensor      # [N] mean absolute residual


def build_pyramid(img: torch.Tensor, levels: int) -> torch.Tensor:
    """Grey image [H, W] -> [levels, H, W]; level l is the 2^l-downsampled
    image in the top-left corner, zeros elsewhere."""
    H, W = img.shape
    out = [img]
    cur = img
    for _ in range(levels - 1):
        cur = _down2(cur)
        out.append(F.pad(cur, (0, W - cur.shape[1], 0, H - cur.shape[0])))
    return torch.stack(out)


def _start(fl: torch.Tensor, dim: int) -> torch.Tensor:
    """The window start of ``lax.dynamic_slice`` for the int32 corner
    floor - R: float -> int32 saturates (NaN becomes 0) and the
    subtraction wraps as int32 does; a negative start then counts from the
    end of the axis, as a negative index does; last, the start is clamped
    so that the window lies inside the axis."""
    v = torch.nan_to_num(fl, nan=0.0).clamp(-2.0 ** 40, 2.0 ** 40)
    v = v.to(torch.int64).clamp(-2 ** 31, 2 ** 31 - 1) - _R
    v = torch.where(v < -2 ** 31, v + 2 ** 32, v)
    v = torch.where(v < 0, v + dim, v)
    return torch.clamp(v, 0, dim - WIN - 1)


def _windows(img: torch.Tensor, c: torch.Tensor):
    """[N, WIN+1, WIN+1] windows of img [H, W] at the start ``_start``
    gives for floor(c) - R, and the fractional parts."""
    H, W = img.shape
    fl = torch.floor(c)
    x0 = _start(fl[:, 0], W)
    y0 = _start(fl[:, 1], H)
    ar = torch.arange(WIN + 1, device=img.device)
    rows = (y0[:, None] + ar)[:, :, None]
    cols = (x0[:, None] + ar)[:, None, :]
    frac = c - fl
    return img[rows, cols], frac[:, 0, None, None], frac[:, 1, None, None]


def _shift(raw, fx, fy):
    top = (1 - fx) * raw[:, :-1, :-1] + fx * raw[:, :-1, 1:]
    bot = (1 - fx) * raw[:, 1:, :-1] + fx * raw[:, 1:, 1:]
    return (1 - fy) * top + fy * bot


def _sum(x):
    return x.sum((1, 2))


def lk_flow(img0: torch.Tensor, img1: torch.Tensor, pts: torch.Tensor,
            valid: torch.Tensor, *, levels: int = 3, iters: int = 10
            ) -> FlowResult:
    """Track pts [N, 2] from img0 into img1 (both [H, W] float32)."""
    pyr0 = build_pyramid(img0, levels)
    pyr1 = build_pyramid(img1, levels)
    H, W = img0.shape
    g = pts / (2.0 ** levels)
    last_ok = torch.ones_like(valid)
    for lvl in range(levels - 1, -1, -1):
        p_l = pts / (2.0 ** lvl)
        g = g * 2.0
        T = _shift(*_windows(pyr0[lvl], p_l))                  # template
        gx = 0.5 * (torch.roll(T, -1, 2) - torch.roll(T, 1, 2))
        gy = 0.5 * (torch.roll(T, -1, 1) - torch.roll(T, 1, 1))
        a, b, c = _sum(gx * gx), _sum(gx * gy), _sum(gy * gy)
        det = a * c - b * b
        inv_ok = det > 1e-4
        den = torch.clamp(det, min=1e-4)
        cur = g
        for _ in range(iters):
            diff = _shift(*_windows(pyr1[lvl], cur)) - T
            g1, g2 = _sum(diff * gx), _sum(diff * gy)
            cur = cur - torch.stack([(c * g1 - b * g2) / den,
                                     (a * g2 - b * g1) / den], -1)
        g = torch.where(inv_ok[:, None], cur, g)
        last_ok = inv_ok
    # the final residual at level 0
    T = _shift(*_windows(pyr0[0], pts))
    err = torch.abs(_shift(*_windows(pyr1[0], g)) - T).mean((1, 2))
    in_img = ((g[:, 0] >= _R + 1) & (g[:, 0] < W - _R - 1)
              & (g[:, 1] >= _R + 1) & (g[:, 1] < H - _R - 1))
    return FlowResult(xy=g, valid=valid & last_ok & in_img & (err < 30.0),
                      err=err)


def associate_flow_to_features(flow_xy: torch.Tensor,
                               flow_valid: torch.Tensor,
                               feat_xy: torch.Tensor,
                               feat_valid: torch.Tensor,
                               max_dist: float = 1.0):
    """For each flow endpoint the nearest valid feature within max_dist,
    deduplicated per feature.  Returns (idx [N] into the features or -1,
    mask [N])."""
    d2 = torch.sum((flow_xy[:, None, :] - feat_xy[None, :, :]) ** 2, -1)
    feasible = flow_valid[:, None] & feat_valid[None, :]
    d2 = torch.where(feasible, d2, 1e18)
    best = torch.argmin(d2, dim=1)                    # first minimum
    bd = d2.gather(1, best[:, None])[:, 0]
    ok = bd <= max_dist * max_dist
    M, n = feat_xy.shape[0], flow_xy.shape[0]
    sel = torch.where(ok, bd, 1e18)
    per_tgt = torch.full((M,), 1e18, device=d2.device).scatter_reduce(
        0, best, sel, "amin")
    rows = torch.arange(n, device=d2.device)
    closest = sel <= per_tgt[best]
    src = torch.where(ok & closest, rows, n)
    tie = torch.full((M,), n, device=d2.device).scatter_reduce(
        0, best, src, "amin")
    ok = ok & closest & (rows == tie[best])
    return torch.where(ok, best, -1).to(torch.int32), ok
