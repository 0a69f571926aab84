"""Helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; data
crosses between them as numpy arrays.  Torch is held to one thread: the
suite runs several xdist workers on a few cores."""

from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(1)

TEST_K = np.array([[250., 0, 160], [0, 250., 120], [0, 0, 1]], np.float32)


def to_t(a, dtype=None) -> torch.Tensor:
    """numpy (or a JAX array) -> CPU tensor; uint32 words become int32
    with the same bits."""
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    t = torch.from_numpy(a)
    return t if dtype is None else t.to(dtype)


def to_np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def rand_desc(rng, n: int, words: int = 16) -> np.ndarray:
    """[n, words] uint32 random descriptors."""
    return rng.integers(0, 2 ** 32, (n, words), dtype=np.uint64).astype(
        np.uint32)


def noisy_copies(rng, desc: np.ndarray, rows: np.ndarray,
                 flip_p: float = 0.05) -> np.ndarray:
    """desc[rows] with each bit flipped with probability flip_p."""
    bits = np.unpackbits(desc[rows].view(np.uint8), axis=-1,
                         bitorder="little")
    bits ^= (rng.uniform(0, 1, bits.shape) < flip_p).astype(np.uint8)
    return np.packbits(bits, axis=-1, bitorder="little").view(np.uint32)


def match_case(rng, ns: int, nt: int, extent: float = 200.0,
               copy_p: float = 0.4):
    """A matcher case: targets, sources of which a share are noisy copies
    of targets placed near them.  Returns numpy (d0, xy0, v0, d1, xy1, v1)."""
    d1 = rand_desc(rng, nt)
    xy1 = rng.uniform(0, extent, (nt, 2)).astype(np.float32)
    d0 = rand_desc(rng, ns)
    xy0 = rng.uniform(0, extent, (ns, 2)).astype(np.float32)
    copy = rng.uniform(0, 1, ns) < copy_p
    pick = rng.integers(0, nt, ns)
    d0[copy] = noisy_copies(rng, d1, pick[copy])
    xy0[copy] = xy1[pick[copy]] + rng.normal(0, 6, (copy.sum(), 2))
    v0 = rng.uniform(0, 1, ns) < 0.9
    v1 = rng.uniform(0, 1, nt) < 0.9
    return d0, xy0.astype(np.float32), v0, d1, xy1, v1


def f32_d2(c, t):
    """The window test's d2 in float32, each step rounded (as K1's plain
    version and its kernel compute it)."""
    dx = np.float32(c[0]) - np.float32(t[0])
    dy = np.float32(c[1]) - np.float32(t[1])
    return np.float32(np.float32(dx * dx) + np.float32(dy * dy))


def cells_visit(c, t, max_r2) -> bool:
    """Whether K1's cells route visits target t from window centre c."""
    from sfm_tpu_torch.features import match_pallas as mp
    reach, inv = mp.window_geometry(max_r2)
    for k in range(2):
        lo, hi = mp.window_cells(np.float32(c[k]), reach, inv)
        cell = mp.cell_of(np.float32(t[k]), inv)
        if not lo <= cell <= hi:
            return False
    return True


def random_scene(rng, n_points=200, depth=(4.0, 8.0), spread=2.0):
    """Points in front of camera 0 (at the origin) and a second camera
    displaced and rotated; exact pixel projections under TEST_K."""
    from sfm_tpu_torch.np_geometry import project_np, rodrigues_np
    X = np.stack([rng.uniform(-spread, spread, n_points),
                  rng.uniform(-spread, spread, n_points),
                  rng.uniform(depth[0], depth[1], n_points)], 1)
    rvec1 = rng.uniform(-0.1, 0.1, 3)
    t1 = np.array([rng.uniform(0.3, 0.8), rng.uniform(-0.1, 0.1),
                   rng.uniform(-0.1, 0.1)])
    R1 = rodrigues_np(rvec1)
    uv0 = project_np(TEST_K, np.eye(3), np.zeros(3), X)
    uv1 = project_np(TEST_K, R1, t1, X)
    f = np.float32
    return dict(X=X.astype(f), rvec1=rvec1.astype(f), t1=t1.astype(f),
                uv0=uv0.astype(f), uv1=uv1.astype(f))


def texture(rng, h: int, w: int) -> np.ndarray:
    """A blocky random texture with corners at several scales."""
    img = np.full((h, w), 30.0, np.float32)
    for _ in range(60):
        s = int(rng.integers(6, 30))
        y, x = int(rng.integers(0, h - s)), int(rng.integers(0, w - s))
        img[y:y + s, x:x + s] = rng.uniform(40, 250)
    return img


def ba_scene(rng, n_cams: int, n_pts: int, max_obs: int, noise_px=0.0,
             outlier_p=0.0, dead_p=0.0, min_obs=1):
    """A BA problem under TEST_K: cameras strafing along x, each landmark
    seen by min_obs..max_obs consecutive cameras, observations listed in random
    order (a share dead, w == 0).  Returns numpy (truth, init, obs) with
    truth / init dicts of rv [C, 3], tv [C, 3], X [L, 3] and obs =
    (cam_idx, lm_idx, uv, w)."""
    from sfm_tpu_torch.np_geometry import rodrigues_np
    X = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                  rng.uniform(4, 8, n_pts)], 1)
    rv = rng.uniform(-0.05, 0.05, (n_cams, 3))
    tv = np.stack([-0.25 * np.arange(n_cams), rng.uniform(-.05, .05, n_cams),
                   rng.uniform(-.05, .05, n_cams)], 1)
    n_obs = rng.integers(min_obs, max_obs + 1, n_pts)
    first = rng.integers(0, np.maximum(n_cams - n_obs, 0) + 1)
    lm_idx = np.repeat(np.arange(n_pts), n_obs)
    cam_idx = np.concatenate([f + np.arange(n) for f, n in zip(first, n_obs)])
    cam_idx = np.minimum(cam_idx, n_cams - 1)
    Rs = np.stack([rodrigues_np(r) for r in rv])
    p = np.einsum("oab,ob->oa", Rs[cam_idx], X[lm_idx]) + tv[cam_idx]
    uv = p[:, :2] / p[:, 2:] @ TEST_K[:2, :2].T + TEST_K[:2, 2]
    uv = uv + rng.normal(0, noise_px, uv.shape) if noise_px else uv
    uv[rng.uniform(0, 1, len(uv)) < outlier_p] += 30.0
    w = (rng.uniform(0, 1, len(uv)) >= dead_p).astype(np.float32)
    order = rng.permutation(len(uv))
    f = np.float32
    obs = (cam_idx[order].astype(np.int32), lm_idx[order].astype(np.int32),
           uv[order].astype(f), w[order])
    truth = dict(rv=rv.astype(f), tv=tv.astype(f), X=X.astype(f))
    init = dict(rv=(rv + rng.normal(0, 0.01, rv.shape)).astype(f),
                tv=(tv + rng.normal(0, 0.02, tv.shape)).astype(f),
                X=(X + rng.normal(0, 0.05, X.shape)).astype(f))
    return truth, init, obs


# tests/test_engine.py's TEST_CFG, as keyword arguments for either package
TEST_CFG_KW = dict(
    max_keypoints=192, max_keyframes=8, max_landmarks=1024,
    image_height=240, image_width=320, pyramid_levels=3,
    ransac_hypotheses=64, pnp_hypotheses=32, ba_iterations=6,
    keyframe_min_tracked=15, keyframe_time_lag=6, min_init_matches=25)
# the float metrics (poses, reprojection error, guidance): compared to a
# tolerance; every other field exactly
FLOAT_METRICS = ("mean_reproj_err", "rvec", "tvec", "guid_centroid",
                 "guid_bbox_center", "guid_bbox_axes", "guid_bbox_extent")


def assert_metrics_match(m_t: dict, m_j, rtol=1e-4, atol=1e-4):
    """A port metric dict against a JAX StepMetrics: the same keys in the
    same order, the same dtypes and shapes, counters and flags equal,
    float fields to the tolerance (the guidance box axes each up to sign:
    an eigendecomposition fixes them no further)."""
    assert list(m_t) == list(m_j._fields)
    for k in m_j._fields:
        a, b = to_np(m_t[k]), np.asarray(getattr(m_j, k))
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype,
                                                           b.dtype)
        if k == "guid_bbox_axes":
            a = a * np.where(np.sum(a * b, -1) < 0, -1.0, 1.0)[:, None]
        if k in FLOAT_METRICS:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
