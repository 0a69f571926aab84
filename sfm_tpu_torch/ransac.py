"""Batched-hypothesis RANSAC: a fixed batch of minimal samples is solved
and scored in parallel, then the best model is refit on its inliers.

All randomness enters through ``sample_masked`` (Gumbel top-k over the
valid entries) with an explicit ``torch.Generator``.  Every solver also
takes ``samples`` — an injected [n_hyp, sample_size] index tensor — so a
test can feed it the samples another implementation drew."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .geometry.epipolar import epiline_distance_sq
from .geometry.estimation import estimate_fundamental
from .geometry.pnp import p3p, pnp_dlt, refine_pose, reprojection_errors


def sample_masked(generator: Optional[torch.Generator], valid: torch.Tensor,
                  n_hyp: int, sample_size: int) -> torch.Tensor:
    """[n_hyp, sample_size] indices drawn from the valid entries without
    replacement within a hypothesis.  With fewer than sample_size valid
    entries invalid indices appear; callers guard on the valid count."""
    u = torch.rand((n_hyp, valid.shape[0]), generator=generator,
                   device=valid.device)
    u = torch.clamp(u, min=torch.finfo(u.dtype).tiny)
    g = -torch.log(-torch.log(u))
    g = torch.where(valid[None, :], g, -torch.inf)
    return torch.sort(g, dim=-1, descending=True,
                      stable=True).indices[:, :sample_size]


def _sample_weights(samples, valid):
    w = torch.zeros((samples.shape[0], valid.shape[0]), dtype=torch.float32,
                    device=valid.device)
    return w.scatter(1, samples.to(torch.int64), 1.0) * valid


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

    F0 = Fs[torch.argmax(inliers(Fs).sum(-1))]
    F = estimate_fundamental(uv0, uv1, inliers(F0).to(torch.float32))
    inl = inliers(F)
    n = inl.sum()
    return RansacModel(F, inl, n, n.to(torch.float32))


class PnPResult(NamedTuple):
    rvec: torch.Tensor
    tvec: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    ok: torch.Tensor        # [] bool: enough inliers to trust the pose


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
    invalid candidate counts -1 inliers).  fast_path_ratio > 0 tries the
    refined prior first and skips the batch when it explains that fraction
    of the valid matches."""
    if solver not in ("dlt", "p3p"):
        raise ValueError(f"unknown PnP solver {solver!r} (dlt or p3p)")

    def refined(rv, tv):
        for _ in range(2):
            inl = (reprojection_errors(K, rv, tv, xyz, uv) < threshold) & valid
            rv, tv = refine_pose(K, rv, tv, xyz, uv, inl.to(torch.float32),
                                 iters=refine_iters)
        inl = (reprojection_errors(K, rv, tv, xyz, uv) < threshold) & valid
        return rv, tv, inl, inl.sum()

    if prior_rvec is not None and fast_path_ratio > 0.0:
        rv, tv, inl, n = refined(prior_rvec, prior_tvec)
        if bool((n >= fast_path_ratio * valid.sum()) & (n >= min_inliers)):
            return PnPResult(rv, tv, inl, n, n >= min_inliers)

    if samples is None:
        samples = sample_masked(generator, valid, n_hypotheses,
                                3 if solver == "p3p" else sample_size)
    if solver == "p3p":
        idx = samples.to(torch.int64)
        rvs, tvs, ok = p3p(K, xyz[idx], uv[idx])        # [n_hyp, 4, ...]
        err = reprojection_errors(K, rvs, tvs, xyz, uv)
        counts = torch.where(ok, ((err < threshold) & valid).sum(-1), -1)
        rvs, tvs, counts = (rvs.reshape(-1, 3), tvs.reshape(-1, 3),
                            counts.reshape(-1))
    else:
        rvs, tvs = pnp_dlt(K, xyz, uv, _sample_weights(samples, valid))
        err = reprojection_errors(K, rvs, tvs, xyz, uv)
        counts = ((err < threshold) & valid).sum(-1)
    if prior_rvec is not None:
        err_p = reprojection_errors(K, prior_rvec, prior_tvec, xyz, uv)
        n_p = ((err_p < threshold) & valid).sum()
        rvs = torch.cat([rvs, prior_rvec[None]])
        tvs = torch.cat([tvs, prior_tvec[None]])
        counts = torch.cat([counts, n_p[None]])
    best = torch.argmax(counts)
    rv, tv, inl, n = refined(rvs[best], tvs[best])
    return PnPResult(rv, tv, inl, n, n >= min_inliers)
