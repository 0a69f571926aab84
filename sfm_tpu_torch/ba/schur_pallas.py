"""K3: the implicit-Schur coupling apply (``csrc/schur.cu``) in three modes,
their plain versions, and ``SchurOperator``.

The CUDA kernel replaces the Pallas TPU kernels of
``sfm_tpu/ba/schur_pallas.py``:

    schur_apply_fused (``_fused_kernel``, K3):  t = g + sum_k W^T x[cam],
                                                z = Vinv t, y = sum W z
    schur_gather      (``_gather_kernel``, K4a): z only
    schur_scatter     (``_scatter_kernel``, K4b): y = sum W z for given z

on the port's layouts: lm_cam [L, kmax] int32, W [L, kmax, 6, 3] (as K2
writes it), Vinv [L, 3, 3], g and z [L, 3], x and y [C, 6].  Empty slots
carry zero W blocks, so nothing is masked.  ``g`` or ``x`` may be None
(read as zeros).  The kernel sums per camera through the table's
camera-major index (``large.camera_slots``), in a fixed order: any camera
count, the same bits from run to run.  The TPU formulation is not ported:
no tile packing, no ``SchurPlan`` camera windows, no one-hot MXU operands
or bf16 rounding of x (the port computes in f32).

Dispatch: a CPU tensor runs the plain version (which takes no index); a
CUDA tensor launches the kernel or raises."""

from __future__ import annotations

import torch

from .. import native

_MODES = {"full": (0, "schur_apply"), "gather": (1, "schur_gather"),
          "scatter": (2, "schur_scatter")}


def _cams(lm_cam, C):
    return lm_cam.to(torch.int64).clamp(0, C - 1)


def _gather_plain(lm_cam, W, Vinv, g, x):
    L = W.shape[0]
    t = W.new_zeros((L, 3)) if g is None else g
    if x is not None:
        t = t + torch.einsum("lkab,lka->lb", W, x[_cams(lm_cam, x.shape[0])])
    return (Vinv @ t[:, :, None])[..., 0]


def _scatter_plain(lm_cam, W, z, n_cams):
    q = torch.einsum("lkab,lb->lka", W, z)
    return z.new_zeros((n_cams, 6)).index_add_(
        0, _cams(lm_cam, n_cams).reshape(-1), q.reshape(-1, 6))


def schur_apply_fused_plain(lm_cam, W, Vinv, g, x, n_cams):
    """(z [L, 3], y [n_cams, 6]): the full apply."""
    z = _gather_plain(lm_cam, W, Vinv, g, x)
    return z, _scatter_plain(lm_cam, W, z, n_cams)


def schur_gather_plain(lm_cam, W, Vinv, g, x):
    """z [L, 3] = Vinv (g + sum_k W^T x[cam])."""
    return _gather_plain(lm_cam, W, Vinv, g, x)


def schur_scatter_plain(lm_cam, W, z, n_cams):
    """y [n_cams, 6] = sum over slots of W z, per camera."""
    return _scatter_plain(lm_cam, W, z, n_cams)


def schur_kernel(mode: str, lm_cam, W, Vinv=None, g=None, x=None, z=None,
                 n_cams: int = None, slots=None):
    """The CUDA kernel in ``mode`` "full" -> (z, y), "gather" -> z or
    "scatter" -> y, for any camera count and kmax <= 256.  ``slots``: the
    table's ``large.camera_slots`` (read by the modes that write y), built
    here over every slot when not given (an empty slot's zero W block adds
    nothing)."""
    code, counter = _MODES[mode]
    L, kmax = lm_cam.shape
    C = x.shape[0] if x is not None and mode != "scatter" else n_cams
    if mode == "gather" and x is None:
        C = 1   # z = Vinv g: no camera vector is read or written
    if C is None or C < 1:
        raise ValueError(f"schur_{mode}: empty problem C={C}")
    native.check_kmax(kmax)
    if mode != "gather" and slots is None:
        from .large import camera_slots
        slots = camera_slots(lm_cam, None, C)
    args = [("lm_cam", lm_cam, torch.int32, (L, kmax)),
            ("W", W, torch.float32, (L, kmax, 6, 3))]
    if mode == "scatter":
        args.append(("z", z, torch.float32, (L, 3)))
    else:
        args.append(("Vinv", Vinv, torch.float32, (L, 3, 3)))
        if g is not None:
            args.append(("g", g, torch.float32, (L, 3)))
        if x is not None:
            args.append(("x", x, torch.float32, (C, 6)))
    if mode != "gather":
        args += [("offsets", slots.offsets, torch.int32, (C + 1,)),
                 ("slots", slots.slots, torch.int32, (L * kmax,))]
    dev = W.device
    for name, t, dt, shape in args:
        native.require_cuda(name, t, dt, shape)
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, W on {dev}")
    f32 = dict(dtype=torch.float32, device=dev)
    z_out = torch.empty((L, 3), **f32) if mode != "scatter" else None
    y = torch.empty((C, 6), **f32) if mode != "gather" else None
    q = torch.empty((L * kmax, 6), **f32) if y is not None else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    if mode == "scatter":
        Vinv = g = x = None
    offsets, order = (None, None) if mode == "gather" else slots
    stream = native.stream_handle(dev)
    rc = native.library().sfm_schur_apply(
        code, ptr(lm_cam), ptr(W), ptr(Vinv), ptr(g), ptr(x), ptr(z),
        ptr(offsets), ptr(order), L, kmax, C, ptr(z_out), ptr(q), ptr(y),
        stream)
    native.check(rc, f"schur_{mode}")
    native.count_launch(counter, stream)
    return {"full": (z_out, y), "gather": z_out, "scatter": y}[mode]


def _on_cpu(what: str, t: torch.Tensor) -> bool:
    if t.is_cuda:
        return False
    if t.device.type != "cpu":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return True


def schur_apply_fused(lm_cam, W, Vinv, g=None, x=None, n_cams: int = None,
                      slots=None):
    """K3 dispatch, full mode: (z [L, 3], y [C, 6]); C = x.shape[0], or
    ``n_cams`` when x is None.  The plain version does not read
    ``slots``."""
    n_cams = x.shape[0] if x is not None else n_cams
    if _on_cpu("schur_apply_fused", W):
        return schur_apply_fused_plain(lm_cam, W, Vinv, g, x, n_cams)
    return schur_kernel("full", lm_cam, W, Vinv, g, x, n_cams=n_cams,
                        slots=slots)


def schur_gather(lm_cam, W, Vinv, g=None, x=None):
    """K3 dispatch, gather mode (the K4a function): z [L, 3]."""
    if _on_cpu("schur_gather", W):
        return schur_gather_plain(lm_cam, W, Vinv, g, x)
    return schur_kernel("gather", lm_cam, W, Vinv, g, x)


def schur_scatter(lm_cam, W, z, n_cams: int, slots=None):
    """K3 dispatch, scatter mode (the K4b function): y [n_cams, 6]."""
    if _on_cpu("schur_scatter", W):
        return schur_scatter_plain(lm_cam, W, z, n_cams)
    return schur_kernel("scatter", lm_cam, W, z=z, n_cams=n_cams,
                        slots=slots)


class SchurOperator:
    """One linearisation's coupling W, table lm_cam and damped landmark
    inverses Vinv, serving the solver's three uses through K3 on
    camera-major [C, 6] vectors.  ``slots``: the table's
    ``large.camera_slots`` (built per apply when None)."""

    def __init__(self, W: torch.Tensor, lm_cam: torch.Tensor,
                 Vinv: torch.Tensor, slots=None):
        self.W, self.lm_cam, self.Vinv, self.slots = W, lm_cam, Vinv, slots

    def w_vinv_wt_x(self, x: torch.Tensor) -> torch.Tensor:
        """y [C, 6] = W Vinv W^T x (the coupling term of S x)."""
        return schur_apply_fused(self.lm_cam, self.W, self.Vinv, None, x,
                                 slots=self.slots)[1]

    def w_vinv_g(self, g_lm: torch.Tensor, n_cams: int) -> torch.Tensor:
        """y [C, 6] = W Vinv g_lm (the rhs coupling term)."""
        return schur_apply_fused(self.lm_cam, self.W, self.Vinv, g_lm, None,
                                 n_cams=n_cams, slots=self.slots)[1]

    def back_substitute(self, g_lm: torch.Tensor, d_cam: torch.Tensor
                        ) -> torch.Tensor:
        """d_lm [L, 3] = Vinv (g_lm - W^T d_cam), through the gather mode."""
        return schur_gather(self.lm_cam, self.W, self.Vinv, g_lm, -d_cam)
