"""Scan guidance against the JAX package, RGB frames, and guidance in
the port's step.

Inputs are uint8-valued RGB (as a camera gives), so the 4x4 downscale
sums are exact in float32 in any order.  Tolerances: rgb_to_hs, the hull
mask, the downscale and the EMA histogram exact; centroid and bbox centre
rtol 1e-5; axes up to sign 1e-4; extent 1e-3 px."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (TEST_CFG_KW, TEST_K, assert_metrics_match,
                             to_np, to_t)

from sfm_tpu import guidance as jg
from sfm_tpu.config import SfMConfig as JaxConfig
from sfm_tpu.engine import SfMEngine as JaxEngine
from sfm_tpu.engine.state import make_frame as jax_make_frame
from sfm_tpu.synthetic import SpriteScene, strafe_trajectory
from sfm_tpu_torch import guidance as tg
from sfm_tpu_torch.config import SfMConfig
from sfm_tpu_torch.engine import (NOT_INITIALIZED, RUNNING, CameraParams,
                                  SfMEngine, make_frame, state_from_numpy,
                                  step_frame)

JCFG = JaxConfig(**TEST_CFG_KW)
CFG = SfMConfig(**TEST_CFG_KW)


def _cam():
    K = to_t(TEST_K)
    return CameraParams(K=K, d=to_t(np.zeros(5, np.float32)), Kopt=K)


def _scene(rng):
    """A tinted sprite frame (uint8 values) and landmarks on its sprites
    seen from a slightly moved camera."""
    scene = SpriteScene(rng)
    img = np.round(scene.render(TEST_K, np.zeros(3), np.zeros(3), 240, 320,
                                rgb=True)).astype(np.float32)
    xyz = scene.centers[rng.uniform(0, 1, len(scene.centers)) < 0.6]
    xyz = np.concatenate([xyz, rng.normal(0, 3, (20, 3))]).astype(np.float32)
    valid = rng.uniform(0, 1, len(xyz)) < 0.9
    return img, xyz, valid


def test_rgb_to_hs_matches_jax():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (4000, 3)).astype(np.float32)
    rgb[:200, 1] = rgb[:200, 0]          # ties between channels
    rgb[200:300] = rgb[200:300, :1]      # greys
    rgb[300:400, 0] = 255.0              # red maxima with g < b (wraps)
    h, s = tg.rgb_to_hs(to_t(rgb))
    hj, sj = jg.rgb_to_hs(jnp.asarray(rgb))
    np.testing.assert_array_equal(to_np(h), np.asarray(hj))
    np.testing.assert_array_equal(to_np(s), np.asarray(sj))


@pytest.mark.parametrize("n,nvalid", [(50, 40), (5, 2)])
def test_hull_mask_matches_jax(n, nvalid):
    rng = np.random.default_rng(n)
    pts = rng.uniform(-10, 90, (n, 2)).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[rng.permutation(n)[:nvalid]] = True
    m = tg.hull_mask(to_t(pts), to_t(valid), 60, 80)
    mj = jg.hull_mask(jnp.asarray(pts), jnp.asarray(valid), 60, 80)
    np.testing.assert_array_equal(to_np(m), np.asarray(mj))
    assert to_np(m).any() == (nvalid >= 3)


def test_downscale_matches_jax():
    img, _, _ = _scene(np.random.default_rng(1))
    np.testing.assert_array_equal(to_np(tg._downscale(to_t(img), 4)),
                                  np.asarray(jg._downscale(jnp.asarray(img),
                                                           4)))
    grey = img[..., 0]
    np.testing.assert_array_equal(
        to_np(tg._downscale(to_t(grey), 4)),
        np.asarray(jg._downscale(jnp.asarray(grey), 4)))


def _close_outputs(out, outj):
    np.testing.assert_array_equal(to_np(out.mask), np.asarray(outj.mask))
    np.testing.assert_allclose(to_np(out.centroid), np.asarray(outj.centroid),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to_np(out.bbox_center),
                               np.asarray(outj.bbox_center), rtol=1e-5)
    ax, axj = to_np(out.bbox_axes), np.asarray(outj.bbox_axes)
    for k in range(2):   # each axis up to sign
        sgn = np.sign(ax[k] @ axj[k])
        np.testing.assert_allclose(sgn * ax[k], axj[k], atol=1e-4)
    np.testing.assert_allclose(to_np(out.bbox_extent),
                               np.asarray(outj.bbox_extent), atol=1e-3)


def test_update_guidance_over_frames_matches_jax():
    """Three updates (the EMA blend) on three frames of a moving camera."""
    rng = np.random.default_rng(2)
    scene = SpriteScene(rng)
    xyz = scene.centers.astype(np.float32)
    valid = rng.uniform(0, 1, len(xyz)) < 0.8
    cfg = SfMConfig(image_height=240, image_width=320)
    jcfg = JaxConfig(image_height=240, image_width=320)
    st, stj = tg.init_guidance(cfg, "cpu"), jg.init_guidance(jcfg)
    K = TEST_K
    fn = jax.jit(lambda s, im, r, t: jg.update_guidance(
        jcfg, s, im, jnp.asarray(xyz), jnp.asarray(valid), jnp.asarray(K),
        r, t))
    for i in range(3):
        rv = np.array([0.0, 0.02 * i, 0.0], np.float32)
        tv = np.array([-0.1 * i, 0.0, 0.0], np.float32)
        img = np.round(scene.render(K, rv, tv, 240, 320, rgb=True)).astype(
            np.float32)
        st, out = tg.update_guidance(cfg, st, to_t(img), to_t(xyz),
                                     to_t(valid), to_t(K), to_t(rv),
                                     to_t(tv))
        stj, outj = fn(stj, jnp.asarray(img), jnp.asarray(rv),
                       jnp.asarray(tv))
        np.testing.assert_array_equal(to_np(st.hist), np.asarray(stj.hist))
        _close_outputs(out, outj)
        assert to_np(out.mask).sum() > 50
    assert bool(st.initialized)


def test_principal_axes_of_an_empty_segmentation_match_eigh():
    cov = torch.zeros((2, 2))
    np.testing.assert_array_equal(
        to_np(tg._principal_axes(cov)),
        np.asarray(jnp.linalg.eigh(jnp.zeros((2, 2)))[1].T[::-1]))


def test_rgb_make_frame_matches_jax():
    """An RGB frame: detection on its luma, keypoint colours from RGB."""
    scene = SpriteScene(np.random.default_rng(3))
    img = np.round(scene.render(TEST_K, np.zeros(3), np.zeros(3), 240, 320,
                                rgb=True)).astype(np.float32)
    eng = JaxEngine(TEST_K, (240, 320), None, JCFG)
    fr_j = jax.device_get(jax.jit(lambda im: jax_make_frame(
        JCFG, eng.cam, im, jnp.asarray(0, jnp.int32)))(jnp.asarray(img)))
    fr_t = make_frame(CFG, _cam(), to_t(img), to_t(np.int32(0)))
    np.testing.assert_array_equal(to_np(fr_t.kp_valid),
                                  np.asarray(fr_j.kp_valid))
    np.testing.assert_array_equal(to_np(fr_t.color), np.asarray(fr_j.color))
    col = to_np(fr_t.color)[to_np(fr_t.kp_valid)]
    assert (col[:, 0] != col[:, 1]).mean() > 0.5


def test_step_runs_guidance_on_running_rgb_frames():
    """Guidance metrics are zero until the engine runs, then filled; a
    grey frame or guidance_enabled=False leaves them zero."""
    scene = SpriteScene(np.random.default_rng(3))
    rv, tv = strafe_trajectory(5)
    frames = [scene.render(TEST_K, rv[i], tv[i], 240, 320, rgb=True)
              for i in range(5)]
    eng = SfMEngine(TEST_K, (240, 320), None, CFG, device="cpu")
    ms = [eng.add_frame(f) for f in frames]
    assert int(ms[0]["status"]) == NOT_INITIALIZED
    assert not ms[0]["guid_bbox_center"].any()
    assert int(ms[-1]["status"]) == RUNNING
    c = ms[-1]["guid_bbox_center"]
    assert 0 < c[0] < 320 and 0 < c[1] < 240
    assert np.isfinite(ms[-1]["guid_bbox_axes"]).all()
    assert bool(eng.state.guidance.initialized)
    pts, cols = eng.get_reconstruction()
    assert (cols[:, 0] != cols[:, 1]).any()

    off = SfMEngine(TEST_K, (240, 320), None,
                    dataclasses.replace(CFG, guidance_enabled=False),
                    device="cpu")
    ms = [off.add_frame(f) for f in frames]
    assert int(ms[-1]["status"]) == RUNNING
    assert not ms[-1]["guid_bbox_center"].any()
    assert not bool(off.state.guidance.initialized)
    _, cols = off.get_reconstruction()
    assert (cols[:, 0] == cols[:, 1]).all()


def test_step_guidance_matches_jax_on_a_carried_state():
    """From a carried RUNNING state, a blank RGB frame (the lost branch,
    no RANSAC) through both packages' steps: the same metrics, guidance
    fields included, and the same EMA histogram."""
    scene = SpriteScene(np.random.default_rng(3))
    rv, tv = strafe_trajectory(6)
    eng = JaxEngine(TEST_K, (240, 320), None, JCFG)
    for i in range(6):
        eng.add_frame(np.round(scene.render(TEST_K, rv[i], tv[i], 240, 320,
                                            rgb=True)))
    tree = jax.device_get(eng.state)
    assert bool(tree.guidance.initialized)
    blank = np.zeros((240, 320, 3), np.float32)
    blank[:, :, 0] = 40.0
    blank[60:180, 80:240] = (200.0, 30.0, 30.0)
    st_j, m_j = jax.device_get(eng._step(jax.device_put(tree),
                                         jnp.asarray(blank)))
    st_t, m_t = step_frame(CFG, _cam(), state_from_numpy(tree, "cpu"),
                           to_t(blank), None)
    assert int(m_j.status) == RUNNING and float(m_j.guid_bbox_extent[0]) > 0
    assert_metrics_match(m_t, m_j, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(to_np(st_t.guidance.hist),
                                  np.asarray(st_j.guidance.hist))
