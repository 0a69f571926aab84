"""K5: the subpixel patch sampler (``csrc/patches.cu``) and its plain
version.

The CUDA kernel replaces the Pallas TPU kernel
``sfm_tpu/features/patches_pallas.py::_extract_kernel`` and, on the main
path, the selection-matmul sampler ``descriptor._patches_matmul`` (a TPU
workaround for the missing gather).  Both compute the same values: per
keypoint the 33 x 33 patch centred at (cx, cy) of the smoothed canvas, a
4-tap bilinear lerp (x first, then y), taps outside the canvas read 0.
A batch of canvases [B, Hc, Wc] with keypoints [B, N] is one launch.

Dispatch: a CPU tensor runs ``extract_patches_plain``; a CUDA tensor
launches the kernel or raises."""

from __future__ import annotations

import torch

from .. import native

PATCH_RADIUS = 16
PATCH = 2 * PATCH_RADIUS + 1


def extract_patches_plain(canvas_s: torch.Tensor, cx: torch.Tensor,
                          cy: torch.Tensor) -> torch.Tensor:
    """canvas_s [Hc, Wc] f32, cx, cy [N] f32 -> patches [N, 33, 33]; or a
    batch: canvas_s [B, Hc, Wc], cx, cy [B, N] -> [B, N, 33, 33], each
    scan's keypoints sampling its own canvas (taps outside that canvas
    read 0)."""
    Hc, Wc = canvas_s.shape[-2:]
    lead = cx.shape[:-1]
    fcx, fcy = torch.floor(cx), torch.floor(cy)
    x0 = fcx.to(torch.int64) - PATCH_RADIUS
    y0 = fcy.to(torch.int64) - PATCH_RADIUS
    fx = (cx - fcx)[..., None, None]
    fy = (cy - fcy)[..., None, None]
    rr = torch.arange(PATCH + 1, device=canvas_s.device)
    xs = x0[..., None] + rr                                 # [..., N, 34]
    ys = y0[..., None] + rr
    inside = (((ys >= 0) & (ys < Hc))[..., :, None]
              & ((xs >= 0) & (xs < Wc))[..., None, :])      # [..., N, 34, 34]
    flat = (ys.clamp(0, Hc - 1)[..., :, None] * Wc
            + xs.clamp(0, Wc - 1)[..., None, :])
    win = torch.gather(canvas_s.reshape(*lead, Hc * Wc), -1,
                       flat.reshape(*lead, -1)).reshape(flat.shape)
    win = torch.where(inside, win, torch.zeros_like(win))
    gx, gy = 1.0 - fx, 1.0 - fy
    top = gx * win[..., :-1, :-1] + fx * win[..., :-1, 1:]
    bot = gx * win[..., 1:, :-1] + fx * win[..., 1:, 1:]
    return gy * top + fy * bot


def extract_patches_kernel(canvas_s: torch.Tensor, cx: torch.Tensor,
                           cy: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel (same contract as ``extract_patches_plain``): one
    launch for the whole batch."""
    batched = canvas_s.dim() == 3
    native.require_cuda("canvas_s", canvas_s, torch.float32,
                        (None,) * (3 if batched else 2))
    B = canvas_s.shape[0] if batched else 1
    N = cx.shape[-1]
    lead = (B,) if batched else ()
    native.require_cuda("cx", cx, torch.float32, (*lead, N))
    native.require_cuda("cy", cy, torch.float32, (*lead, N))
    dev = canvas_s.device
    if cx.device != dev or cy.device != dev:
        raise ValueError("extract_patches: inputs on different devices")
    Hc, Wc = canvas_s.shape[-2:]
    out = torch.empty((*lead, N, PATCH, PATCH), dtype=torch.float32,
                      device=dev)
    if B * N == 0:
        return out
    lib = native.library()
    stream = native.stream_handle(dev)
    rc = lib.sfm_extract_patches(canvas_s.data_ptr(), B, Hc, Wc,
                                 cx.data_ptr(), cy.data_ptr(), N,
                                 out.data_ptr(), stream)
    native.check(rc, "extract_patches")
    native.count_launch("patch_sampler", stream)
    return out


def extract_patches_pallas(canvas_s: torch.Tensor, cx: torch.Tensor,
                           cy: torch.Tensor) -> torch.Tensor:
    """K5 dispatch: the kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    if canvas_s.is_cuda:
        return extract_patches_kernel(canvas_s, cx, cy)
    if canvas_s.device.type != "cpu":
        raise ValueError(f"extract_patches: unsupported device "
                         f"{canvas_s.device}")
    return extract_patches_plain(canvas_s, cx, cy)
