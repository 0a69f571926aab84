"""Large-scale bundle adjustment: implicit-Schur LM with block-Jacobi
preconditioned conjugate gradients (``ba_solver="large"``).

The dense solver (core.py) materialises the camera-landmark coupling as
[C, L, 6, 3]; here the reduced camera system S = U - W V^-1 W^T is never
formed.  CG applies S through the landmark-major observation table
[L, kmax]: K2 (``linearize_pallas.py``) linearises the whole problem in one
pass over it, and K3 (``schur_pallas.py``) applies the coupling for the CG
matvec and the rhs, and back-substitutes the landmarks (its gather mode).
This is the JAX package's fused route (``run_large_ba`` with
``pallas_matvec`` and ``fused_linearize``), minus its TPU formulation: no
SchurPlan windows, tile packing, one-hot contractions or bf16 operands.

The camera-major half of the dual tables is built by ``build_tables`` and
``build_tables_device`` for parity with the JAX package.  The solver reads
the landmark-major half, plus ``camera_slots``: a camera-major index of its
live slots, built once per solve, through which the kernels sum per
camera."""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..geometry.rotations import exp_so3
from ..utils.profiling import count, span, to_host
from ..utils.rowsum import RowSum
from . import pcg_graph
from .core import BAStats, _damp, _inv
from .linearize_pallas import ba_linearize, damped_vinv
from .residuals import Observations, apply_pose_update
from .schur_pallas import SchurOperator


class ObsTables(NamedTuple):
    """Dual-layout observation tables.  Empty slots have w == 0 and camera
    (landmark) index 0.  The camera-major half is None where only the
    landmark-major tables were built."""
    lm_cam: torch.Tensor                  # [L, kmax] int32 camera index
    lm_uv: torch.Tensor                   # [L, kmax, 2]
    lm_w: torch.Tensor                    # [L, kmax]
    cam_lm: Optional[torch.Tensor] = None  # [C, nmax] int32 landmark index
    cam_uv: Optional[torch.Tensor] = None  # [C, nmax, 2]
    cam_w: Optional[torch.Tensor] = None   # [C, nmax]


def build_tables(obs: Observations, n_cams: int, n_lms: int, nmax: int,
                 kmax: int) -> ObsTables:
    """Host-side: bucket a COO observation list into both table layouts in
    list order.  An observation that overflows either table is dropped
    from both."""
    cam_idx = np.asarray(obs.cam_idx)
    lm_idx = np.asarray(obs.lm_idx)
    uv = np.asarray(obs.uv)
    w = np.asarray(obs.w)
    lm_cam = np.zeros((n_lms, kmax), np.int32)
    lm_uv = np.zeros((n_lms, kmax, 2), np.float32)
    lm_w = np.zeros((n_lms, kmax), np.float32)
    cam_lm = np.zeros((n_cams, nmax), np.int32)
    cam_uv = np.zeros((n_cams, nmax, 2), np.float32)
    cam_w = np.zeros((n_cams, nmax), np.float32)
    fill_l = np.zeros(n_lms, np.int32)
    fill_c = np.zeros(n_cams, np.int32)
    for o in np.nonzero(w > 0)[0]:
        l, c = lm_idx[o], cam_idx[o]
        if fill_l[l] >= kmax or fill_c[c] >= nmax:
            continue
        lm_cam[l, fill_l[l]] = c
        lm_uv[l, fill_l[l]] = uv[o]
        lm_w[l, fill_l[l]] = w[o]
        fill_l[l] += 1
        cam_lm[c, fill_c[c]] = l
        cam_uv[c, fill_c[c]] = uv[o]
        cam_w[c, fill_c[c]] = w[o]
        fill_c[c] += 1
    return ObsTables(*map(torch.from_numpy, (lm_cam, lm_uv, lm_w, cam_lm,
                                             cam_uv, cam_w)))


def _rank_in_group(idx, live, n):
    """Per-observation slot = rank within its equal-index group, in list
    order (dead observations rank in the group of index n): a stable sort,
    then the run starts by a running max."""
    key = torch.where(live, idx, n).to(torch.int64)
    order = torch.sort(key, stable=True).indices
    s = key[order]
    iota = torch.arange(key.shape[0], device=key.device)
    newrun = torch.ones_like(live)
    newrun[1:] = s[1:] != s[:-1]
    start = torch.cummax(torch.where(newrun, iota, 0), 0).values
    rank = torch.empty_like(iota)
    rank[order] = iota - start
    return rank


def _table(n_rows, n_slots, rows, slots, vals):
    """[n_rows, n_slots, ...] zeros with vals written at (rows, slots);
    entries with rows == n_rows are dropped."""
    out = vals.new_zeros((n_rows * n_slots + 1,) + tuple(vals.shape[1:]))
    flat = torch.where(rows < n_rows, rows * n_slots + slots,
                       n_rows * n_slots)
    out[flat] = vals
    return out[:-1].reshape((n_rows, n_slots) + tuple(vals.shape[1:]))


def build_tables_device(obs: Observations, n_cams: int, n_lms: int,
                        nmax: int, kmax: int):
    """Both table layouts from the COO list, on the list's device.  Slots
    are ranks within each landmark's (camera's) run of live observations;
    an observation overflowing either table is dropped from both.  Without
    overflow the tables equal ``build_tables``'s.  Returns (tables,
    n_dropped)."""
    live = obs.w > 0
    slot_l = _rank_in_group(obs.lm_idx, live, n_lms)
    slot_c = _rank_in_group(obs.cam_idx, live, n_cams)
    keep = live & (slot_l < kmax) & (slot_c < nmax)
    l_idx = torch.where(keep, obs.lm_idx, n_lms)
    c_idx = torch.where(keep, obs.cam_idx, n_cams)
    cam32, lm32 = obs.cam_idx.to(torch.int32), obs.lm_idx.to(torch.int32)
    tables = ObsTables(
        _table(n_lms, kmax, l_idx, slot_l, cam32),
        _table(n_lms, kmax, l_idx, slot_l, obs.uv),
        _table(n_lms, kmax, l_idx, slot_l, obs.w),
        _table(n_cams, nmax, c_idx, slot_c, lm32),
        _table(n_cams, nmax, c_idx, slot_c, obs.uv),
        _table(n_cams, nmax, c_idx, slot_c, obs.w))
    return tables, (live.sum() - keep.sum()).to(torch.int32)


def build_lm_tables_device(obs: Observations, n_lms: int, kmax: int):
    """The landmark-major tables only (what the solver reads).  An
    observation is kept when its slot is < kmax; there is no camera-side
    capacity.  Returns (lm_cam, lm_uv, lm_w, n_dropped)."""
    live = obs.w > 0
    slot_l = _rank_in_group(obs.lm_idx, live, n_lms)
    keep = live & (slot_l < kmax)
    l_idx = torch.where(keep, obs.lm_idx, n_lms)
    return (_table(n_lms, kmax, l_idx, slot_l, obs.cam_idx.to(torch.int32)),
            _table(n_lms, kmax, l_idx, slot_l, obs.uv),
            _table(n_lms, kmax, l_idx, slot_l, obs.w),
            (live.sum() - keep.sum()).to(torch.int32))


class CameraSlots(NamedTuple):
    """The camera-major CSR of a landmark-major table's live slots
    s = l * kmax + k (w != 0; every slot when no weights are given).
    Camera c owns
    ``slots[offsets[c]:offsets[c + 1]]``, in ascending s; the empty slots
    follow ``offsets[C]`` (so ``slots`` has a fixed size: no host read)."""
    offsets: torch.Tensor  # [C + 1] int32
    slots: torch.Tensor    # [L * kmax] int32


def camera_slots(lm_cam: torch.Tensor, lm_w: Optional[torch.Tensor],
                 n_cams: int) -> CameraSlots:
    """``CameraSlots`` of the table lm_cam [L, kmax] (camera indices
    clamped into range, as the kernels read them) with weights lm_w
    [L, kmax] (None: every slot is live), on the table's device: a stable
    sort by camera, no host read."""
    key = lm_cam.reshape(-1).to(torch.int64).clamp(0, n_cams - 1)
    if lm_w is not None:
        key = torch.where(lm_w.reshape(-1) != 0, key, n_cams)
    sorted_key, order = torch.sort(key, stable=True)
    offsets = torch.searchsorted(
        sorted_key, torch.arange(n_cams + 1, device=key.device))
    return CameraSlots(offsets.to(torch.int32), order.to(torch.int32))


def _pcg(matvec, M_inv, rhs, iterations: int):
    """Block-Jacobi PCG with a fixed trip count and no host read; x0 = 0,
    so r0 = rhs."""
    def precond(v):
        return (M_inv @ v[:, :, None])[..., 0]

    x = torch.zeros_like(rhs)
    r = rhs
    z = precond(r)
    p = z
    for _ in range(iterations):
        Ap = matvec(p)
        rz = torch.sum(r * z)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-12)
        x = x + alpha * p
        r = r - alpha * Ap
        z_new = precond(r)
        beta = torch.sum(r * z_new) / torch.clamp(rz, min=1e-12)
        p = z_new + beta * p
        z = z_new
    return x


def _schur_coupling_diag(W, Vinv, cam_sum: RowSum) -> torch.Tensor:
    """[C, 6, 6]: sum_j W_cj Vinv_j W_cj^T per camera c, from W [L, kmax,
    6, 3] and Vinv [L, 3, 3]: each slot's product, summed per camera by
    ``cam_sum`` (a ``RowSum`` over the table's slots)."""
    P = (W @ Vinv[:, None]) @ W.transpose(-1, -2)
    return cam_sum(P.reshape(-1, 6, 6))


def _local(*ts):
    """The per-camera sums of an unsharded problem are already whole."""
    return ts


def _schur_pcg(Ud, M_inv, rhs, W, vinv, lm_cam, offsets, slots, *,
               iterations: int, reduce=_local):
    """``_pcg`` on the reduced camera system S x = Ud x - W Vinv W^T x, its
    coupling through K3 and summed over shards by ``reduce``: a function
    of tensors alone, as ``pcg_graph.run`` captures it."""
    op = SchurOperator(W, lm_cam, vinv, CameraSlots(offsets, slots))

    def matvec(x):
        return (Ud @ x[:, :, None])[..., 0] - reduce(op.w_vinv_wt_x(x))[0]

    return _pcg(matvec, M_inv, rhs, iterations)


def _pcg_key(Ud, W, iterations: int) -> tuple:
    """What a captured ``_schur_pcg`` is fixed to: device, dtype, (C, L,
    kmax) and the trip count."""
    return (Ud.device, Ud.dtype, Ud.shape[0], *W.shape[:2], iterations)


def _pcg_graph_wanted(device: torch.device, reduce) -> bool:
    """The PCG runs as a captured graph on the card for an unsharded
    problem; a sharded one's all-reduce, and the CPU, run it eagerly."""
    return device.type == "cuda" and reduce is _local


def _large_lm(K, rvec, tvec, xyz, lm_cam, lm_uv, lm_w, cam_free_f, lm_free_f,
              *, iterations: int, cg_iterations: int, lam0: float,
              lam_up: float, lam_down: float, huber_delta: float, tol: float,
              reduce=_local, precond: str = "jacobi_u"):
    """The LM and PCG loop of ``run_large_ba`` on a landmark-major table.
    ``reduce(*ts) -> ts`` sums per-camera partial sums over the shards of a
    landmark-sharded problem (``parallel.dist_large_ba``): K2's U, g_cam and
    cost, and K3's [C, 6] products; the identity on a whole problem.  Every
    shard then holds the same camera terms and solves the camera system
    itself.  One host read per iteration, after the cost is reduced, so
    every shard reads the same accept flag.  ``precond``: the PCG's
    block-Jacobi blocks, "jacobi_u" (the damped U blocks) or "schur_diag"
    (the exact diagonal blocks of the Schur complement).  On the card, an
    unsharded problem's PCG is the replay of a CUDA graph
    (``pcg_graph``)."""
    with span("ba.solve"):
        C = rvec.shape[0]
        graphed = _pcg_graph_wanted(xyz.device, reduce)
        lm_cam = lm_cam.to(torch.int32).contiguous()
        lm_uv = lm_uv.contiguous()
        lm_w = lm_w.contiguous()
        K = K.contiguous()
        eye6 = torch.eye(6, dtype=xyz.dtype, device=xyz.device)
        cslots = camera_slots(lm_cam, lm_w, C)
        if precond == "schur_diag":
            # per-camera sums of the slots' products in cslots' fixed
            # order, so that reruns on the card repeat bit for bit
            cam_sum = RowSum.from_csr(cslots.offsets, cslots.slots)

        def linearize(rvec, tvec, xyz):
            with span("ba.linearize"):
                W, V, g_lm, U, g_cam, cost = ba_linearize(
                    K, exp_so3(rvec).contiguous(), tvec.contiguous(),
                    xyz.contiguous(), lm_free_f, cam_free_f, lm_cam, lm_uv,
                    lm_w, huber_delta, slots=cslots)
                U, g_cam, cost = reduce(U, g_cam, cost)
            return (W, V, g_lm, U, g_cam), cost

        blocks, cost = linearize(rvec, tvec, xyz)
        cost0 = cost
        lam, accepted = lam0, 0
        for _ in range(iterations):
            W, V, g_lm, U, g_cam = blocks
            with span("ba.pcg"):
                Ud = _damp(U, lam)
                vinv = damped_vinv(V, lam)
                op = SchurOperator(W, lm_cam, vinv, cslots)
                rhs = g_cam - reduce(op.w_vinv_g(g_lm, C))[0]
                if precond == "schur_diag":
                    # block-Jacobi on the exact diagonal of S = damp(U) -
                    # W V^-1 W^T: S_cc = damp(U_cc) - sum_j W_cj Vinv_j
                    # W_cj^T over camera c's slots (a dead slot is in none,
                    # a frozen camera's W is 0)
                    P = reduce(_schur_coupling_diag(W, vinv, cam_sum))[0]
                    M_inv = _inv(Ud - P + 1e-6 * eye6)
                else:
                    # block-Jacobi preconditioner: damped U blocks; _damp's
                    # 1e-6 floor and this one are both kept, as in the JAX
                    # package
                    M_inv = _inv(Ud + 1e-6 * eye6)
                pcg_in = dict(Ud=Ud, M_inv=M_inv, rhs=rhs, W=W, vinv=vinv,
                              lm_cam=lm_cam, offsets=cslots.offsets,
                              slots=cslots.slots)
                if graphed:
                    d_cam = pcg_graph.run(
                        _pcg_key(Ud, W, cg_iterations),
                        functools.partial(_schur_pcg,
                                          iterations=cg_iterations), pcg_in)
                else:
                    d_cam = _schur_pcg(**pcg_in, iterations=cg_iterations,
                                       reduce=reduce)
            with span("ba.update"):
                d_cam = d_cam * cam_free_f[:, None]
                d_lm = op.back_substitute(g_lm, d_cam) * lm_free_f[:, None]
                rv_new, tv_new = apply_pose_update(rvec, tvec, d_cam[:, :3],
                                                   d_cam[:, 3:])
                xyz_new = xyz + d_lm
            blocks_new, new_cost = linearize(rv_new, tv_new, xyz_new)
            ok = (new_cost < cost) & torch.isfinite(new_cost)
            done = ok & (cost - new_cost < tol * torch.clamp(cost, min=1.0))
            ok, done = to_host(torch.Tensor.tolist, torch.stack([ok, done]))
            if ok:
                rvec, tvec, xyz, blocks, cost = (rv_new, tv_new, xyz_new,
                                                 blocks_new, new_cost)
                lam = max(lam / lam_down, 1e-9)
                accepted += 1
            else:
                lam = min(lam * lam_up, 1e6)
            if done:
                break
        dev = xyz.device
        count("implicit_sync", 2)  # the two stats' blocking copies
        return rvec, tvec, xyz, BAStats(
            cost0, cost, torch.tensor(lam, dtype=torch.float32, device=dev),
            torch.tensor(accepted, dtype=torch.int32, device=dev))


def run_large_ba(K, rvec, tvec, xyz, tables: ObsTables, *, cam_free,
                 lm_free, iterations: int = 15, cg_iterations: int = 25,
                 lam0: float = 1e-3, lam_up: float = 4.0,
                 lam_down: float = 2.0, huber_delta: float = 0.0,
                 tol: float = 1e-4, precond: str = "jacobi_u"
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            BAStats]:
    """Implicit-Schur LM: an outer damping loop, an inner block-Jacobi PCG
    on the reduced camera system.  cam_free [C] / lm_free [L] bool masks
    freeze parameters.  One linearisation (K2) per LM iteration, at the
    trial point; CG, the rhs and back-substitution go through K3; both
    kernels share one ``camera_slots`` index per call.  One host read per
    iteration (accept flag and early exit together).  ``precond``:
    "jacobi_u" inverts the damped U blocks; "schur_diag" the exact diagonal
    blocks of the reduced camera system, damp(U_cc) - sum_j W_cj V_j^-1
    W_cj^T, built each LM iteration from K2's W and the damped V^-1 (torch
    ops; for camera graphs with hub cameras)."""
    if precond not in ("jacobi_u", "schur_diag"):
        raise ValueError(f"unknown preconditioner {precond!r}")
    return _large_lm(
        K, rvec, tvec, xyz, tables.lm_cam, tables.lm_uv, tables.lm_w,
        cam_free.to(torch.float32), lm_free.to(torch.float32),
        iterations=iterations, cg_iterations=cg_iterations, lam0=lam0,
        lam_up=lam_up, lam_down=lam_down, huber_delta=huber_delta, tol=tol,
        precond=precond)
