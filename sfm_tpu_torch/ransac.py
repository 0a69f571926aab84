"""Batched-hypothesis RANSAC: a fixed batch of minimal samples is solved
and scored in parallel, then the best model is refit on its inliers.

All randomness enters through ``sample_masked`` (Gumbel top-k over the
valid entries) with an explicit ``torch.Generator``.  Every solver also
takes ``samples`` — an injected [n_hyp, sample_size] index tensor — so a
test can feed it the samples another implementation drew.  ``ransac_pnp``
also takes a fleet's batch ([B, ...] inputs, [B, n_hyp, s] samples)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .geometry.epipolar import (epiline_distance_sq,
                                homography_transfer_error_sq)
from .geometry.estimation import estimate_fundamental, estimate_homography
from .geometry.pnp import p3p, pnp_dlt, refine_pose, reprojection_errors
from .utils.profiling import count


def sample_masked(generator: Optional[torch.Generator], valid: torch.Tensor,
                  n_hyp: int, sample_size: int) -> torch.Tensor:
    """[n_hyp, sample_size] indices drawn from the valid entries without
    replacement within a hypothesis.  With fewer than sample_size valid
    entries invalid indices appear; callers guard on the valid count."""
    u = torch.rand((n_hyp, valid.shape[0]), generator=generator,
                   device=valid.device)
    return _gumbel_top(u, valid, sample_size)


def sample_masked_fleet(generators, valid: torch.Tensor, n_hyp: int,
                        sample_size: int) -> torch.Tensor:
    """``sample_masked`` for a fleet: valid [B, N] -> [B, n_hyp,
    sample_size], scan b's samples drawn from ``generators[b]`` alone
    (equal to ``sample_masked(generators[b], valid[b], ...)``)."""
    u = torch.stack([torch.rand((n_hyp, valid.shape[-1]), generator=g,
                                device=valid.device) for g in generators])
    return _gumbel_top(u, valid[:, None, :], sample_size)


def _gumbel_top(u, valid, sample_size: int) -> torch.Tensor:
    """Gumbel top-k of uniforms u [..., n_hyp, N] over the valid entries."""
    u = torch.clamp(u, min=torch.finfo(u.dtype).tiny)
    g = -torch.log(-torch.log(u))
    g = torch.where(valid, g, -torch.inf)
    return torch.sort(g, dim=-1, descending=True,
                      stable=True).indices[..., :sample_size]


def _sample_weights(samples, valid):
    """[..., n_hyp, N] 0/1 weights of the samples [..., n_hyp, s] among the
    valid entries [..., N]."""
    w = torch.zeros((*samples.shape[:-1], valid.shape[-1]),
                    dtype=torch.float32, device=valid.device)
    return w.scatter(-1, samples.to(torch.int64), 1.0) * valid[..., None, :]


class RansacModel(NamedTuple):
    model: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    score: torch.Tensor


def ransac_fundamental(generator, uv0, uv1, valid, *,
                       n_hypotheses: int = 128, threshold: float = 3.84,
                       samples=None) -> RansacModel:
    """8-point RANSAC for F (cv::findFundamentalMat(CV_FM_RANSAC))."""
    if samples is None:
        samples = sample_masked(generator, valid, n_hypotheses, 8)
    Fs = estimate_fundamental(uv0, uv1, _sample_weights(samples, valid))

    def inliers(F):
        d1, d0 = epiline_distance_sq(F, uv0, uv1)
        return (d1 < threshold) & (d0 < threshold) & valid

    count("implicit_sync")  # an index by a tensor on the card
    F0 = Fs[torch.argmax(inliers(Fs).sum(-1))]
    F = estimate_fundamental(uv0, uv1, inliers(F0).to(torch.float32))
    inl = inliers(F)
    n = inl.sum()
    return RansacModel(F, inl, n, n.to(torch.float32))


def ransac_homography(generator, uv0, uv1, valid, *,
                      n_hypotheses: int = 128, threshold: float = 5.99,
                      samples=None) -> RansacModel:
    """4-point RANSAC for H (cv::findHomography(RANSAC)): an inlier's
    squared transfer error is below ``threshold`` both ways."""
    if samples is None:
        samples = sample_masked(generator, valid, n_hypotheses, 4)
    Hs = estimate_homography(uv0, uv1, _sample_weights(samples, valid))

    def inliers(H):
        e_fwd, e_bwd = homography_transfer_error_sq(H, uv0, uv1)
        return (e_fwd < threshold) & (e_bwd < threshold) & valid

    H0 = Hs[torch.argmax(inliers(Hs).sum(-1))]
    H = estimate_homography(uv0, uv1, inliers(H0).to(torch.float32))
    inl = inliers(H)
    n = inl.sum()
    return RansacModel(H, inl, n, n.to(torch.float32))


class PnPResult(NamedTuple):
    rvec: torch.Tensor
    tvec: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    ok: torch.Tensor        # [] bool: enough inliers to trust the pose


def _pick(x, idx):
    """x[..., idx, :] per leading index: x [..., M, D], idx [...]."""
    return torch.take_along_dim(x, idx[..., None, None], dim=-2)[..., 0, :]


def ransac_pnp(generator, K, xyz, uv, valid, *, n_hypotheses: int = 64,
               sample_size: int = 6, threshold: float = 7.0,
               refine_iters: int = 10, min_inliers: int = 5,
               prior_rvec=None, prior_tvec=None,
               fast_path_ratio: float = 0.0, solver: str = "dlt",
               samples=None) -> PnPResult:
    """PnP RANSAC: ``n_hypotheses`` minimal-sample poses plus (optionally)
    the prior pose; the best by inlier count is refined with Gauss-Newton
    on its inliers twice (refine -> recount -> refine), then inliers
    recomputed.  ``solver`` "dlt" solves ``sample_size``-point DLTs; "p3p"
    takes 3-point samples and scores the 4 Grunert candidates of each (an
    invalid candidate counts -1 inliers).  fast_path_ratio > 0 also refines
    the prior alone and takes it where it explains that fraction of the
    valid matches (a ``torch.where``, no host branch).

    A fleet passes xyz [B, N, 3], uv [B, N, 2], valid [B, N] and priors
    [B, 3]: every scan is solved in the same ops, each from its own
    ``samples`` [B, n_hyp, s] (which a fleet draws per scan; a batch has no
    single ``generator``)."""
    if solver not in ("dlt", "p3p"):
        raise ValueError(f"unknown PnP solver {solver!r} (dlt or p3p)")
    lead = valid.shape[:-1]

    def refined(rv, tv):
        for _ in range(2):
            inl = (reprojection_errors(K, rv, tv, xyz, uv) < threshold) & valid
            rv, tv = refine_pose(K, rv, tv, xyz, uv, inl.to(torch.float32),
                                 iters=refine_iters)
        inl = (reprojection_errors(K, rv, tv, xyz, uv) < threshold) & valid
        return rv, tv, inl, inl.sum(-1)

    if samples is None:
        if lead:
            raise ValueError("ransac_pnp: a batch needs its samples")
        samples = sample_masked(generator, valid, n_hypotheses,
                                3 if solver == "p3p" else sample_size)
    samples = samples.to(torch.int64)
    xyz_h, uv_h = xyz[..., None, :, :], uv[..., None, :, :]
    if solver == "p3p":
        rvs, tvs, ok = p3p(K, torch.take_along_dim(xyz_h, samples[..., None],
                                                   dim=-2),
                           torch.take_along_dim(uv_h, samples[..., None],
                                                dim=-2))  # [..., n_hyp, 4, 3]
        err = reprojection_errors(K, rvs, tvs, xyz_h[..., None, :, :],
                                  uv_h[..., None, :, :])
        counts = torch.where(
            ok, ((err < threshold) & valid[..., None, None, :]).sum(-1), -1)
        rvs, tvs, counts = (rvs.flatten(-3, -2), tvs.flatten(-3, -2),
                            counts.flatten(-2))
    else:
        rvs, tvs = pnp_dlt(K, xyz_h, uv_h, _sample_weights(samples, valid))
        err = reprojection_errors(K, rvs, tvs, xyz_h, uv_h)
        counts = ((err < threshold) & valid[..., None, :]).sum(-1)
    if prior_rvec is not None:
        err_p = reprojection_errors(K, prior_rvec, prior_tvec, xyz, uv)
        n_p = ((err_p < threshold) & valid).sum(-1)
        rvs = torch.cat([rvs, prior_rvec[..., None, :]], -2)
        tvs = torch.cat([tvs, prior_tvec[..., None, :]], -2)
        counts = torch.cat([counts, n_p[..., None]], -1)
    best = torch.argmax(counts, -1)
    rv, tv, inl, n = refined(_pick(rvs, best), _pick(tvs, best))
    if prior_rvec is not None and fast_path_ratio > 0.0:
        rv_f, tv_f, inl_f, n_f = refined(prior_rvec, prior_tvec)
        good = (n_f >= fast_path_ratio * valid.sum(-1)) & (n_f >= min_inliers)
        rv = torch.where(good[..., None], rv_f, rv)
        tv = torch.where(good[..., None], tv_f, tv)
        inl = torch.where(good[..., None], inl_f, inl)
        n = torch.where(good, n_f, n)
    return PnPResult(rv, tv, inl, n, n >= min_inliers)
