"""Pyramidal LK flow and flow-assisted tracking against the JAX package.

``lk_flow`` on two frames shifted by sub-pixel and integer amounts: a
smooth random texture (every window well conditioned), with points across
it and within 11 px of its border, where the 22x22 window starts where
``lax.dynamic_slice`` starts it; and a rendered sprite frame at its FAST
keypoints.  Tracked xy to 1e-3 px, the valid flags equal, the residual to
rtol 1e-4 (atol 1e-3 grey levels: it is a mean of small differences).
``associate_flow_to_features`` exactly, dedup ties included.  One
flow-assisted tracking step from a carried JAX state (the JAX PnP
samples injected), and a port-only flow scan that stays RUNNING."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_util import TEST_CFG_KW, TEST_K, to_np, to_t

from sfm_tpu.config import SfMConfig as JaxConfig
from sfm_tpu.engine import SfMEngine as JaxEngine
from sfm_tpu.engine.state import make_frame as jax_make_frame
from sfm_tpu.engine.tracking import tracking_step as jax_tracking_step
from sfm_tpu.features import flow as jf
from sfm_tpu.features.match import match_features as jax_match
from sfm_tpu.ransac import sample_masked as jax_sample_masked
from sfm_tpu.synthetic import SpriteScene, strafe_trajectory
from sfm_tpu_torch.config import SfMConfig
from sfm_tpu_torch.engine import (RUNNING, CameraParams, SfMEngine,
                                  state_from_numpy, tracking_step)
from sfm_tpu_torch.engine.state import frame_from_numpy
from sfm_tpu_torch.features import flow as tf
from sfm_tpu_torch.features.detect import detect

FLOW_KW = dict(TEST_CFG_KW, track_with_flow=True)
JCFG = JaxConfig(**FLOW_KW)
CFG = SfMConfig(**FLOW_KW)
H, W = 240, 320


def _cam():
    K = to_t(TEST_K)
    return CameraParams(K=K, d=to_t(np.zeros(5, np.float32)), Kopt=K)


def _texture(rng):
    """Blocky noise smoothed by a 3x3 box (tests/test_flow.py's texture at
    the full frame size)."""
    img = rng.normal(0, 1, (H // 4, W // 4)).repeat(4, 0).repeat(4, 1)
    pad = np.pad(img, 1, mode="edge")
    img = sum(pad[i:i + H, j:j + W] for i in range(3) for j in range(3)) / 9
    return (img * 40 + 128).astype(np.float32)


def _sprites():
    """A rendered sprite frame and its FAST keypoints."""
    scene = SpriteScene(np.random.default_rng(5), n_sprites=260, spread=2.4)
    img = scene.render(TEST_K, np.zeros(3), np.zeros(3), H, W)
    kps = detect(to_t(img), max_keypoints=256, levels=3, threshold=20.0,
                 nms_radius=3)
    return img, to_np(kps.xy)[to_np(kps.valid)]


def _shift(img, dx, dy):
    """img moved by (dx, dy) px: integer part by np.roll, the fraction by
    bilinear interpolation."""
    ix, iy = int(np.floor(dx)), int(np.floor(dy))
    fx, fy = dx - ix, dy - iy
    out = np.roll(img, (iy, ix), axis=(0, 1)).astype(np.float64)
    out = (1 - fx) * out + fx * np.roll(out, 1, axis=1)
    out = (1 - fy) * out + fy * np.roll(out, 1, axis=0)
    return out.astype(np.float32)


def _points(rng):
    """Points across the image and within 11 px of each border."""
    inner = rng.uniform([30, 30], [W - 30, H - 30], (120, 2))
    edge = np.concatenate([
        np.stack([rng.uniform(0, 11, 12), rng.uniform(0, H, 12)], -1),
        np.stack([rng.uniform(W - 11, W, 12), rng.uniform(0, H, 12)], -1),
        np.stack([rng.uniform(0, W, 12), rng.uniform(0, 11, 12)], -1),
        np.stack([rng.uniform(0, W, 12), rng.uniform(H - 11, H, 12)], -1)])
    return np.concatenate([inner, edge]).astype(np.float32)


_jax_lk = jax.jit(lambda a, b, p, v: jf.lk_flow(a, b, p, v, levels=3,
                                               iters=10))


@pytest.mark.parametrize("kind", ["texture", "sprites"])
@pytest.mark.parametrize("dx,dy", [(0.4, -0.3), (6.0, 3.0), (-9.6, 4.25)])
def test_lk_flow_matches_jax(kind, dx, dy):
    rng = np.random.default_rng(7)
    if kind == "texture":
        img0, pts = _texture(np.random.default_rng(1)), _points(rng)
    else:
        img0, pts = _sprites()
    img1 = _shift(img0, dx, dy)
    valid = rng.uniform(0, 1, len(pts)) < 0.9
    res = tf.lk_flow(to_t(img0), to_t(img1), to_t(pts), to_t(valid),
                     levels=3, iters=10)
    rj = jax.device_get(_jax_lk(jnp.asarray(img0), jnp.asarray(img1),
                                jnp.asarray(pts), jnp.asarray(valid)))
    np.testing.assert_array_equal(to_np(res.valid), np.asarray(rj.valid))
    np.testing.assert_allclose(to_np(res.xy), np.asarray(rj.xy), atol=1e-3)
    np.testing.assert_allclose(to_np(res.err), np.asarray(rj.err),
                               rtol=1e-4, atol=1e-3)
    # the flow is real: the valid points follow the shift
    ok = to_np(res.valid)
    assert ok.mean() > 0.5
    disp = to_np(res.xy)[ok] - pts[ok]
    np.testing.assert_allclose(np.median(disp, 0), [dx, dy], atol=0.3)


def test_associate_flow_to_features_matches_jax():
    rng = np.random.default_rng(11)
    feat = rng.uniform(0, 60, (80, 2)).astype(np.float32)
    fv = rng.uniform(0, 1, 80) < 0.9
    # endpoints near features (several per feature), a few exact ties and
    # far ones
    pick = rng.integers(0, 80, 150)
    flow = (feat[pick] + rng.normal(0, 0.6, (150, 2))).astype(np.float32)
    flow[:10] = feat[pick[:10]] + np.float32(0.25)
    flow[10:20] = flow[:10]                       # duplicate endpoints
    flow[140:] += 20.0
    flv = rng.uniform(0, 1, 150) < 0.9
    idx, ok = tf.associate_flow_to_features(to_t(flow), to_t(flv),
                                            to_t(feat), to_t(fv), 1.0)
    idx_j, ok_j = jf.associate_flow_to_features(
        jnp.asarray(flow), jnp.asarray(flv), jnp.asarray(feat),
        jnp.asarray(fv), 1.0)
    np.testing.assert_array_equal(to_np(ok), np.asarray(ok_j))
    np.testing.assert_array_equal(to_np(idx), np.asarray(idx_j))
    assert 20 < to_np(ok).sum() < 150
    used = to_np(idx)[to_np(ok)]
    assert len(np.unique(used)) == len(used)      # one endpoint per feature


@pytest.fixture(scope="module")
def flow_run():
    scene = SpriteScene(np.random.default_rng(3))
    rv, tv = strafe_trajectory(14)
    frames = [scene.render(TEST_K, rv[i], tv[i], H, W) for i in range(14)]
    eng = JaxEngine(TEST_K, (H, W), None, JCFG)
    for f in frames[:9]:
        eng.add_frame(f)
    return dict(eng=eng, frames=frames, tree=jax.device_get(eng.state))


def test_flow_tracking_step_matches_jax(flow_run):
    """One RUNNING step with track_with_flow from the carried JAX state
    (prev_image included): the same match count with the flow recall, the
    same inliers, the pose to 1e-4 and >= 99% of the links."""
    tree, eng = flow_run["tree"], flow_run["eng"]
    assert int(tree.status) == RUNNING
    assert np.asarray(tree.prev_image).std() > 1.0
    img = flow_run["frames"][9]
    cam = eng.cam
    fr = jax.device_get(jax.jit(lambda im: jax_make_frame(
        JCFG, cam, im, jnp.asarray(9, jnp.int32)))(jnp.asarray(img)))
    st_j, m_j = jax.device_get(jax.jit(lambda s, f, im: jax_tracking_step(
        JCFG, cam, s, f, None, image=im))(tree, fr, jnp.asarray(img)))
    # the JAX step's match mask with the flow recall, and its PnP samples
    prev = tree.prev
    src_valid = prev.kp_valid & (prev.landmark >= 0)
    res = jax_match(prev.desc, prev.xy, src_valid, fr.desc, fr.xy,
                    fr.kp_valid, min_radius=JCFG.match_min_radius,
                    max_radius=JCFG.match_max_radius,
                    max_distance=JCFG.match_max_distance,
                    ratio=JCFG.match_ratio)
    fl = _jax_lk(jnp.asarray(tree.prev_image), jnp.asarray(img),
                 jnp.asarray(prev.xy_dist), jnp.asarray(src_valid))
    fidx, fok = jf.associate_flow_to_features(
        fl.xy, fl.valid, jnp.asarray(fr.xy_dist), jnp.asarray(fr.kp_valid),
        max_dist=JCFG.flow_assoc_dist)
    mask, idx = np.asarray(res.mask), np.asarray(res.idx)
    fidx, fok = np.asarray(fidx), np.asarray(fok)
    taken = np.zeros(len(fr.kp_valid), bool)
    taken[idx[mask]] = True
    use = fok & ~mask & ~taken[np.where(fok, fidx, 0)]
    mask = mask | use
    assert mask.sum() == int(m_j.n_matches)
    safe = np.where(src_valid, prev.landmark, 0)
    pnp_valid = mask & np.asarray(tree.lms.valid)[safe]
    _, k_pnp = jax.random.split(tree.key)
    samples = jax_sample_masked(k_pnp, jnp.asarray(pnp_valid),
                                JCFG.pnp_hypotheses, JCFG.pnp_sample_size)
    st_t, m_t = tracking_step(CFG, _cam(), state_from_numpy(tree, "cpu"),
                              frame_from_numpy(fr, "cpu"), None,
                              pnp_samples=to_t(np.asarray(samples)),
                              image=to_t(img))
    assert int(m_t["n_matches"]) == int(m_j.n_matches)
    assert int(m_t["n_inliers"]) == int(m_j.n_inliers)
    np.testing.assert_allclose(to_np(st_t.prev.rvec),
                               np.asarray(st_j.prev.rvec), atol=1e-4)
    np.testing.assert_allclose(to_np(st_t.prev.tvec),
                               np.asarray(st_j.prev.tvec), atol=1e-4)
    links_t = to_np(st_t.prev.landmark)
    assert (links_t == np.asarray(st_j.prev.landmark)).mean() >= 0.99


def test_flow_scan_stays_running():
    """tests/test_flow.py's engine scan on the port: RUNNING to the end,
    and prev_image follows the reference frame."""
    scene = SpriteScene(np.random.default_rng(3))
    rv, tv = strafe_trajectory(14)
    eng = SfMEngine(TEST_K, (H, W), None, CFG, device="cpu")
    ms = [eng.add_frame(scene.render(TEST_K, rv[i], tv[i], H, W))
          for i in range(14)]
    assert eng.status == RUNNING
    assert int(ms[-1]["n_tracked"]) >= 15
    assert sum(int(m["status"]) == RUNNING for m in ms[2:]) == 12
    assert tuple(eng.state.prev_image.shape) == (H, W)
    assert float(eng.state.prev_image.std()) > 1.0
    # without flow the image is a [1, 1] placeholder
    off = SfMEngine(TEST_K, (H, W), None,
                    dataclasses.replace(CFG, track_with_flow=False),
                    device="cpu")
    assert tuple(off.state.prev_image.shape) == (1, 1)
