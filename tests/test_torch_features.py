"""Detection, patch sampling and description against the JAX package.

Detection (canvas, FAST, NMS, top-K, subpixel) is exact: the same f32
operations in the same order.  Patches (K5's plain version) are held to
both JAX samplers within 1e-3 intensity (the selection matmul may fuse a
multiply-add).  Descriptors are compared by bit-flip rate: the orientation
and polar-resample matmuls sum in another order, which flips comparisons
that sit at zero."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import texture, to_np, to_t

from sfm_tpu.features.patches_pallas import extract_patches_pallas
from sfm_tpu.synthetic import SpriteScene, strafe_trajectory
from sfm_tpu_torch.features import descriptor
from sfm_tpu_torch.features.patches_pallas import extract_patches_plain

# the packages re-export functions under these module names
jdesc = importlib.import_module("sfm_tpu.features.descriptor")
jdet = importlib.import_module("sfm_tpu.features.detect")
detect = importlib.import_module("sfm_tpu_torch.features.detect")

K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]], np.float32)
# measured on this frame on a CPU: 9.5e-5 (25 of 262144 bits, in 23 of 512
# descriptors); the bound leaves room for other BLAS summation orders
FLIP_BOUND = 0.002


@pytest.fixture(scope="module")
def frame():
    scene = SpriteScene(np.random.default_rng(11), n_sprites=260, spread=2.4)
    rv, tv = strafe_trajectory(3, step=0.06, yaw_rate=0.001)
    return scene.render(K, rv[2], tv[2], 480, 640)


@pytest.fixture(scope="module")
def jax_detect(frame):
    fn = jax.jit(lambda im: jdet.detect(im, max_keypoints=512, levels=4,
                                        return_canvas=True))
    kps, canvas = fn(jnp.asarray(frame))
    return jax.device_get(kps), np.asarray(canvas)


def test_canvas_fast_nms_exact():
    img = texture(np.random.default_rng(0), 96, 128)
    can = detect.build_canvas(to_t(img), 3)
    canj = jdet.build_canvas(jnp.asarray(img), 3)
    np.testing.assert_array_equal(to_np(can), np.asarray(canj))
    raw = detect.fast_score(can, 20.0)
    np.testing.assert_array_equal(to_np(raw),
                                  np.asarray(jdet.fast_score(canj, 20.0)))
    np.testing.assert_array_equal(
        to_np(detect.nms(raw, 2)), np.asarray(jdet.nms(jnp.asarray(
            to_np(raw)), 2)))


def test_detect_exact(frame, jax_detect):
    kps_j, canvas_j = jax_detect
    kps, canvas = detect.detect(to_t(frame), max_keypoints=512, levels=4,
                                return_canvas=True)
    np.testing.assert_array_equal(to_np(canvas), canvas_j)
    assert int(kps.valid.sum()) > 300
    np.testing.assert_array_equal(to_np(kps.valid), np.asarray(kps_j.valid))
    np.testing.assert_array_equal(to_np(kps.level), np.asarray(kps_j.level))
    np.testing.assert_array_equal(to_np(kps.score), np.asarray(kps_j.score))
    np.testing.assert_array_equal(to_np(kps.xy), np.asarray(kps_j.xy))


def _patch_inputs(kps_j, canvas_j):
    canvas_s = np.asarray(jdesc.smooth(jnp.asarray(canvas_j)))
    lay = jdet.canvas_layout(480, 640, 4)
    lvl = np.asarray(kps_j.level)
    scale = 2.0 ** lvl
    lxy = (np.asarray(kps_j.xy) - 0.5 * (scale[:, None] - 1)) / scale[:, None]
    cx = (lxy[:, 0] + np.asarray(lay.offsets)[lvl]).astype(np.float32)
    cy = lxy[:, 1].astype(np.float32)
    return canvas_s, cx, cy, np.asarray(kps_j.valid)


def test_smooth_exact(jax_detect):
    _, canvas_j = jax_detect
    np.testing.assert_array_equal(
        to_np(descriptor.smooth(to_t(canvas_j))),
        np.asarray(jdesc.smooth(jnp.asarray(canvas_j))))


def test_patches_match_both_jax_samplers(jax_detect):
    canvas_s, cx, cy, valid = _patch_inputs(*jax_detect)
    ours = to_np(extract_patches_plain(to_t(canvas_s), to_t(cx), to_t(cy)))
    mm = np.asarray(jdesc._patches_matmul(jnp.asarray(canvas_s),
                                          jnp.asarray(cx), jnp.asarray(cy)))
    np.testing.assert_allclose(ours[valid], mm[valid], atol=1e-3)
    # the Pallas sampler clamps near the canvas bottom; compare the valid
    # keypoints its 48-row window reaches unclamped
    sel = valid & (np.floor(cy) - 16 <= canvas_s.shape[0] - 41)
    pal = np.asarray(extract_patches_pallas(
        jnp.asarray(canvas_s), jnp.asarray(cx[sel]), jnp.asarray(cy[sel]),
        interpret=True))
    np.testing.assert_allclose(ours[sel], pal, atol=1e-3)


def test_patches_read_zero_outside_canvas():
    canvas = torch.arange(20 * 30, dtype=torch.float32).reshape(20, 30)
    cx, cy = torch.tensor([2.25]), torch.tensor([3.5])
    ours = to_np(extract_patches_plain(canvas, cx, cy))
    ref = np.asarray(jdesc._patches_matmul(jnp.asarray(to_np(canvas)),
                                           jnp.asarray([2.25]),
                                           jnp.asarray([3.5])))
    np.testing.assert_allclose(ours, ref, atol=1e-3)
    assert ours[0, 0, 0] == 0.0


def test_tables_bit_equal():
    for ours, ref in zip(descriptor.tables(512), jdesc._tables(512)):
        np.testing.assert_array_equal(ours, ref)
    assert descriptor._make_pairs(512, 512).tolist() == \
        jdesc._make_pairs(512, 512).tolist()


def test_descriptor_bit_flip_rate(frame, jax_detect):
    kps_j, canvas_j = jax_detect
    ref = np.asarray(jax.jit(lambda c, k: jdesc.describe_canvas(
        c, k, 4, 640, 512))(jnp.asarray(canvas_j), kps_j))
    kps = detect.Keypoints(xy=to_t(kps_j.xy), score=to_t(kps_j.score),
                           level=to_t(kps_j.level), valid=to_t(kps_j.valid))
    ours = to_np(descriptor.describe_canvas(to_t(canvas_j), kps, 4, 640, 512))
    valid = np.asarray(kps_j.valid)
    a = np.unpackbits(ours[valid].view(np.uint8), axis=-1)
    b = np.unpackbits(ref[valid].view(np.uint32).view(np.uint8), axis=-1)
    rate = float((a != b).mean())
    assert rate < FLIP_BOUND, rate


@pytest.mark.parametrize("window", [3, 4])
def test_shi_tomasi_score(window):
    """rtol 1e-4 against the JAX package, on a texture and a SpriteScene
    frame; an even window pads as XLA's "SAME" does (one more row below).
    The response is a difference of two terms, so entries near zero get
    an absolute tolerance of 1e-4 of the largest response."""
    rng = np.random.default_rng(10)
    scene = SpriteScene(np.random.default_rng(3))
    rv, tv = strafe_trajectory(2)
    K = np.array([[250., 0, 160], [0, 250., 120], [0, 0, 1]], np.float32)
    for img in (texture(rng, 60, 80),
                scene.render(K, rv[1], tv[1], 120, 160).astype(np.float32)):
        ours = to_np(detect.shi_tomasi_score(to_t(img), window))
        ref = np.asarray(jdet.shi_tomasi_score(jnp.asarray(img), window))
        np.testing.assert_allclose(ours, ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
        assert ref.max() > 10.0
