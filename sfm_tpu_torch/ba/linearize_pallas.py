"""K2: the BA linearizer (``csrc/linearize.cu``), its plain version, and
``damped_vinv``.

The CUDA kernel replaces the Pallas TPU kernel
``sfm_tpu/ba/linearize_pallas.py::_linearize_kernel`` (wrapped there by
``fused_blocks``).  One call over the landmark-major table [L, kmax] (a
landmark pass, then a camera pass through the table's camera-major index,
``large.camera_slots``) returns what an LM iteration of the large solver
needs:

    W [L, kmax, 6, 3]   A^T B per slot (the layout K3 reads)
    V [L, 3, 3], g_lm [L, 3]
    U [C, 6, 6], g_cam [C, 6], cost []

with A and B scaled by w * cam_free and w * lm_free, w = w_obs * the Huber
IRLS weight, and cost = sum w |r|^2 over the kept slots.  That cost is not
the dense solver's rho-cost (``residuals.robust_cost``); the large solver
accepts or rejects LM steps on this one, as the JAX package does.

The TPU-side formulation is not ported: no tile packing (``build_lin_tables``,
``pack_lm_tiles``), no camera windows (``window_gather`` /
``window_combine``), no one-hot MXU gathers or bf16 splits.

Dispatch: a CPU tensor runs ``ba_linearize_plain``; a CUDA tensor launches
the kernel or raises."""

from __future__ import annotations

import torch

from .. import native
from .residuals import Observations, huber_weights, residuals_and_jacobians


def ba_linearize_plain(K, R, tvec, xyz, lm_free_f, cam_free_f, lm_cam, lm_uv,
                       lm_w, huber_delta: float = 0.0):
    """K [3, 3], R [C, 3, 3], tvec [C, 3], xyz [L, 3], lm_free_f [L],
    cam_free_f [C] (f32 0/1), table lm_cam [L, kmax] int32, lm_uv
    [L, kmax, 2], lm_w [L, kmax].  Returns (W, V, g_lm, U, g_cam, cost)."""
    C = R.shape[0]
    L, kmax = lm_cam.shape
    cam = lm_cam.reshape(-1).to(torch.int64).clamp(0, C - 1)
    lm = torch.arange(L, device=xyz.device).repeat_interleave(kmax)
    obs = Observations(cam, lm, lm_uv.reshape(-1, 2), lm_w.reshape(-1))
    r, A, B = residuals_and_jacobians(K, R, tvec, xyz, obs)
    w = obs.w * huber_weights(r, huber_delta)
    A = A * (w * cam_free_f[cam])[:, None, None]
    B = B * (w * lm_free_f[lm])[:, None, None]
    rw = r * w[:, None]
    At, Bt = A.transpose(1, 2), B.transpose(1, 2)
    W = (At @ B).reshape(L, kmax, 6, 3)
    V = (Bt @ B).reshape(L, kmax, 3, 3).sum(1)
    g_lm = -(Bt @ rw[:, :, None]).reshape(L, kmax, 3).sum(1)
    U = xyz.new_zeros((C, 6, 6)).index_add_(0, cam, At @ A)
    g_cam = xyz.new_zeros((C, 6)).index_add_(
        0, cam, -(At @ rw[:, :, None])[..., 0])
    cost = torch.sum(w * torch.sum(r * r, -1))
    return W, V, g_lm, U, g_cam, cost


def ba_linearize_kernel(K, R, tvec, xyz, lm_free_f, cam_free_f, lm_cam,
                        lm_uv, lm_w, huber_delta: float = 0.0, slots=None):
    """The CUDA kernel (same contract as ``ba_linearize_plain``), for any
    camera count and kmax <= 256.  ``slots``: the table's
    ``large.camera_slots``, built here when not given."""
    C = R.shape[0]
    L, kmax = lm_cam.shape
    if C < 1:
        raise ValueError(f"ba_linearize: empty problem C={C}")
    native.check_kmax(kmax)
    if slots is None:
        from .large import camera_slots
        slots = camera_slots(lm_cam, lm_w, C)
    for name, t, dt, shape in (
            ("K", K, torch.float32, (3, 3)),
            ("R", R, torch.float32, (C, 3, 3)),
            ("tvec", tvec, torch.float32, (C, 3)),
            ("xyz", xyz, torch.float32, (L, 3)),
            ("lm_free_f", lm_free_f, torch.float32, (L,)),
            ("cam_free_f", cam_free_f, torch.float32, (C,)),
            ("lm_cam", lm_cam, torch.int32, (L, kmax)),
            ("lm_uv", lm_uv, torch.float32, (L, kmax, 2)),
            ("lm_w", lm_w, torch.float32, (L, kmax)),
            ("offsets", slots.offsets, torch.int32, (C + 1,)),
            ("slots", slots.slots, torch.int32, (L * kmax,))):
        native.require_cuda(name, t, dt, shape)
        if t.device != xyz.device:
            raise ValueError(f"{name} is on {t.device}, xyz on {xyz.device}")
    if lm_uv.data_ptr() % 8:
        raise ValueError("lm_uv: the kernel reads (u, v) as 8-byte pairs")
    dev = xyz.device
    f32 = dict(dtype=torch.float32, device=dev)
    W = torch.empty((L, kmax, 6, 3), **f32)
    V = torch.empty((L, 3, 3), **f32)
    g_lm = torch.empty((L, 3), **f32)
    U = torch.empty((C, 6, 6), **f32)
    g_cam = torch.empty((C, 6), **f32)
    cost = torch.empty((C,), **f32)     # per camera
    stream = native.stream_handle(dev)
    rc = native.library().sfm_ba_linearize(
        K.data_ptr(), R.data_ptr(), tvec.data_ptr(), cam_free_f.data_ptr(),
        xyz.data_ptr(), lm_free_f.data_ptr(), lm_cam.data_ptr(),
        lm_uv.data_ptr(), lm_w.data_ptr(), slots.offsets.data_ptr(),
        slots.slots.data_ptr(), L, kmax, C, float(huber_delta), W.data_ptr(),
        V.data_ptr(), g_lm.data_ptr(), U.data_ptr(), g_cam.data_ptr(),
        cost.data_ptr(), stream)
    native.check(rc, "ba_linearize")
    native.count_launch("ba_linearize", stream)
    return W, V, g_lm, U, g_cam, cost.sum()


def ba_linearize(K, R, tvec, xyz, lm_free_f, cam_free_f, lm_cam, lm_uv, lm_w,
                 huber_delta: float = 0.0, slots=None):
    """K2 dispatch: the kernel for a CUDA tensor, the plain version for a
    CPU tensor (which does not read ``slots``)."""
    if xyz.is_cuda:
        return ba_linearize_kernel(K, R, tvec, xyz, lm_free_f, cam_free_f,
                                   lm_cam, lm_uv, lm_w, huber_delta, slots)
    if xyz.device.type != "cpu":
        raise ValueError(f"ba_linearize: unsupported device {xyz.device}")
    return ba_linearize_plain(K, R, tvec, xyz, lm_free_f, cam_free_f, lm_cam,
                              lm_uv, lm_w, huber_delta)


def damped_vinv(V: torch.Tensor, lam) -> torch.Tensor:
    """(damp(V, lam))^-1 [L, 3, 3] for symmetric V [L, 3, 3], in closed
    form: the math of the JAX package's ``damped_vinv_tiled`` (the fused
    route's landmark inverse) in the port's layout.  Its determinant floor
    is 1e-20, not ``inv3_sym``'s 1e-12: dead landmarks (V == 0) invert the
    1e-6 damping floor to 1e6 I and later multiply zero W and g blocks."""
    d = 1 + lam
    a = V[:, 0, 0] * d + 1e-6
    b, c = V[:, 0, 1], V[:, 0, 2]
    e = V[:, 1, 1] * d + 1e-6
    f = V[:, 1, 2]
    i = V[:, 2, 2] * d + 1e-6
    A_ = e * i - f * f
    B_ = c * f - b * i
    C_ = b * f - c * e
    E_ = a * i - c * c
    F_ = b * c - a * f
    I_ = a * e - b * b
    det = a * A_ + b * B_ + c * C_
    det = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20),
                      det)
    inv = torch.stack([A_, B_, C_, B_, E_, F_, C_, F_, I_], -1) \
        * (1.0 / det)[:, None]
    return inv.reshape(-1, 3, 3)
