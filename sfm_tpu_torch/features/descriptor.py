"""Oriented 512-bit binary descriptor.

BRISK-style intensity comparisons on a fixed polar sampling pattern,
steered by the intensity-centroid orientation, sampled on the keypoint's
pyramid level:
 1. a 33 x 33 subpixel patch per keypoint from the smoothed canvas
    (kernel K5, ``patches_pallas``);
 2. orientation = intensity centroid of the patch (two moment masks);
 3. the patch resampled onto a polar grid (16 rings x 32 angles) with one
    fixed bilinear matmul; steering is a circular shift of the angle axis
    by the quantised orientation (a gather);
 4. bits = signs of fixed sample-pair differences (one matmul).
The tables come from the same numpy code as the JAX package's and are
bit-equal to them."""

from __future__ import annotations

import math

import numpy as np
import torch

from .bits import pack_bits
from .detect import Keypoints, canvas_layout
from .patches_pallas import PATCH, PATCH_RADIUS, extract_patches_pallas

N_PHI = 32
N_RAD = 16


def _make_pairs(bits: int, n_samples: int, seed: int = 17) -> np.ndarray:
    """[bits, 2] comparison-pair indices into the polar sample set."""
    rng = np.random.default_rng(seed)
    ii = rng.integers(0, n_samples, bits)
    jj = rng.integers(0, n_samples, bits)
    jj = np.where(jj == ii, (jj + 1) % n_samples, jj)
    return np.stack([ii, jj], 1).astype(np.int32)


def _bilinear_weight_rows(pts: np.ndarray) -> np.ndarray:
    """pts [M, 2] (x, y) offsets from the patch centre -> bilinear weight
    matrix [M, PATCH * PATCH]."""
    M = pts.shape[0]
    W = np.zeros((M, PATCH, PATCH), np.float32)
    x = pts[:, 0] + PATCH_RADIUS
    y = pts[:, 1] + PATCH_RADIUS
    x0 = np.clip(np.floor(x).astype(int), 0, PATCH - 2)
    y0 = np.clip(np.floor(y).astype(int), 0, PATCH - 2)
    fx = x - x0
    fy = y - y0
    idx = np.arange(M)
    W[idx, y0, x0] = (1 - fy) * (1 - fx)
    W[idx, y0, x0 + 1] = (1 - fy) * fx
    W[idx, y0 + 1, x0] = fy * (1 - fx)
    W[idx, y0 + 1, x0 + 1] = fy * fx
    return W.reshape(M, PATCH * PATCH)


_CACHE = {}


def tables(bits: int):
    """(Wpol [N_RAD*N_PHI, PATCH^2] polar bilinear sampling, Dsel [bits,
    N_RAD*N_PHI] +/-1 pair differences, mx, my orientation moment masks),
    as numpy arrays."""
    if bits in _CACHE:
        return _CACHE[bits]
    radii = np.geomspace(1.5, PATCH_RADIUS - 1.5, N_RAD)
    ang = 2.0 * np.pi * np.arange(N_PHI) / N_PHI
    xs = radii[:, None] * np.cos(ang)[None, :]
    ys = radii[:, None] * np.sin(ang)[None, :]
    pts = np.stack([xs.reshape(-1), ys.reshape(-1)], 1).astype(np.float32)
    Wpol = _bilinear_weight_rows(pts)
    S = N_RAD * N_PHI
    pairs = _make_pairs(bits, S)
    Dsel = np.zeros((bits, S), np.float32)
    Dsel[np.arange(bits), pairs[:, 0]] += 1.0
    Dsel[np.arange(bits), pairs[:, 1]] -= 1.0
    ys2, xs2 = np.mgrid[-PATCH_RADIUS:PATCH_RADIUS + 1,
                        -PATCH_RADIUS:PATCH_RADIUS + 1]
    disc = (xs2 ** 2 + ys2 ** 2 <= 7 ** 2).astype(np.float32)
    mx = (xs2 * disc).reshape(-1).astype(np.float32)
    my = (ys2 * disc).reshape(-1).astype(np.float32)
    _CACHE[bits] = (Wpol, Dsel, mx, my)
    return _CACHE[bits]


_DEVICE_TABLES = {}


def _device_tables(bits: int, device):
    key = (bits, str(device))
    if key not in _DEVICE_TABLES:
        _DEVICE_TABLES[key] = tuple(torch.as_tensor(t, device=device)
                                    for t in tables(bits))
    return _DEVICE_TABLES[key]


def smooth(img: torch.Tensor, k: int = 5) -> torch.Tensor:
    """k x k box blur with edge replication, separable: columns then rows,
    summed centre-out as the JAX package does."""
    r = k // 2
    H, W = img.shape
    dev = img.device
    xs = torch.arange(W, device=dev)
    ys = torch.arange(H, device=dev)
    acc = img
    for d in range(1, r + 1):
        acc = (acc + img.index_select(1, torch.clamp(xs - d, 0, W - 1))
               + img.index_select(1, torch.clamp(xs + d, 0, W - 1)))
    out = acc
    for d in range(1, r + 1):
        out = (out + acc.index_select(0, torch.clamp(ys - d, 0, H - 1))
               + acc.index_select(0, torch.clamp(ys + d, 0, H - 1)))
    return out / (k * k)


def bits_from_patches(patches: torch.Tensor, desc_bits: int) -> torch.Tensor:
    """Orientation-steered comparison bits from centred patches
    [N, PATCH, PATCH] -> packed descriptors [N, desc_bits // 32] int32."""
    N = patches.shape[0]
    Wpol, Dsel, mx, my = _device_tables(desc_bits, patches.device)
    flat = patches.reshape(N, -1)
    theta = torch.atan2(flat @ my, flat @ mx)
    shift = torch.remainder(
        torch.round(theta / (2.0 * math.pi / N_PHI)).to(torch.int64), N_PHI)
    pol = (flat @ Wpol.T).reshape(N, N_RAD, N_PHI)
    # canonical orientation: ring angle psi samples source angle
    # (psi + shift) mod N_PHI
    psi = torch.arange(N_PHI, device=patches.device)
    src = torch.remainder(psi[None, :] + shift[:, None], N_PHI)   # [N, N_PHI]
    pol_c = torch.gather(pol, 2, src[:, None, :].expand(N, N_RAD, N_PHI))
    vals = pol_c.reshape(N, -1) @ Dsel.T
    return pack_bits(vals > 0)


def patch_inputs(canvas: torch.Tensor, kps: Keypoints, levels: int,
                 image_width: int):
    """K5's inputs: the smoothed canvas and every keypoint's patch centre
    (cx, cy) in canvas coordinates on its level band (the detection border
    keeps valid keypoints' patches inside one band)."""
    lay = canvas_layout(canvas.shape[0], image_width, levels)
    assert lay.width == canvas.shape[1], "canvas/layout mismatch"
    scale = torch.exp2(kps.level.to(torch.float32))
    level_xy = (kps.xy - 0.5 * (scale[:, None] - 1.0)) / scale[:, None]
    offs = torch.as_tensor(np.array(lay.offsets, np.float32),
                           device=canvas.device)
    cx = level_xy[:, 0] + offs[kps.level.to(torch.int64)]
    return smooth(canvas), cx.contiguous(), level_xy[:, 1].contiguous()


def describe_canvas(canvas: torch.Tensor, kps: Keypoints, levels: int,
                    image_width: int, desc_bits: int = 512) -> torch.Tensor:
    """Packed descriptors from the pyramid canvas: one smoothing pass, then
    K5 samples every keypoint's patch."""
    patches = extract_patches_pallas(
        *patch_inputs(canvas, kps, levels, image_width))
    return bits_from_patches(patches, desc_bits)
