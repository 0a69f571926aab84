"""The port's scan server and client (serving.py) against the JAX
package's: the wire format byte for byte, each package's client against
the other's server, and served scans equal to the same frames fed to an
in-process ``SfMEngine`` (all on the CPU, at tests/test_serving.py's
size)."""

import json

import numpy as np
import pytest

from torch_port_util import TEST_K

from sfm_tpu import serving as jserving
from sfm_tpu_torch import serving
from sfm_tpu_torch.config import SfMConfig
from sfm_tpu_torch.engine import SfMEngine
from sfm_tpu_torch.serving import ScanClient, ScanServer
from sfm_tpu_torch.synthetic import SpriteScene, strafe_trajectory

# tests/test_serving.py's configuration and scan
TEST_CONFIG = dict(max_keypoints=192, max_keyframes=8,
                   max_landmarks=1024, pyramid_levels=3,
                   ransac_hypotheses=64,
                   pnp_hypotheses=32, ba_iterations=6,
                   keyframe_min_tracked=15,
                   keyframe_time_lag=6,
                   min_init_matches=25)
N = 12
INTR = (240, 320, 250.0, 250.0, 160.0, 120.0)


def _frames(rgb=False):
    scene = SpriteScene(np.random.default_rng(3))
    rv, tv = strafe_trajectory(N, step=0.06, yaw_rate=0.001)
    return np.stack([scene.render(TEST_K, rv[i], tv[i], 240, 320, rgb=rgb)
                     for i in range(N)])


def _wire(metrics):
    """Metrics as a client receives them (the server's JSON)."""
    return json.loads(json.dumps(
        {k: (v.tolist() if hasattr(v, "tolist") else v)
         for k, v in metrics.items()}))


def _engine():
    cfg = SfMConfig(image_height=240, image_width=320, **TEST_CONFIG)
    return SfMEngine(TEST_K, (240, 320), None, cfg, device="cpu")


@pytest.fixture(scope="module")
def server():
    with ScanServer(device="cpu") as srv:
        yield srv


def test_wire_format_equals_jax():
    rng = np.random.default_rng(0)
    cases = [(rng.uniform(0, 255, (6, 5)).astype(np.float32), 0),
             (rng.uniform(0, 255, (6, 5)), 0),
             (rng.integers(0, 256, (6, 5, 3)).astype(np.uint8), 0),
             (rng.integers(0, 256, (4, 6, 5)).astype(np.uint8), 4),
             (rng.uniform(0, 255, (3, 6, 5, 3)).astype(np.float32), 3)]
    for arr, count in cases:
        ours = ScanClient._encode(arr, count)
        assert ours == jserving.ScanClient._encode(arr, count)
        a = serving._decode_frames(ours, (6, 5), count > 0)
        b = jserving._decode_frames(ours, (6, 5), count > 0)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    for code, ch, cnt in ((0, 1, 0), (1, 3, 7), (1, 1, 65535)):
        assert serving._frame_header(code, ch, cnt) \
            == jserving._frame_header(code, ch, cnt)
    for bad in (serving._frame_header(2, 1) + bytes(4),
                serving._frame_header(1, 2) + bytes(30),
                serving._frame_header(1, 1) + bytes(29)):
        with pytest.raises(ValueError) as e_ours:
            serving._decode_frames(bad, (6, 5), False)
        with pytest.raises(ValueError) as e_jax:
            jserving._decode_frames(bad, (6, 5), False)
        assert str(e_ours.value) == str(e_jax.value)
    assert [getattr(serving, n) for n in dir(jserving) if n.startswith(
        ("MSG_", "DTYPE_"))] == [getattr(jserving, n) for n in dir(jserving)
                                  if n.startswith(("MSG_", "DTYPE_"))]


def test_jax_client_against_the_port_server(server):
    frames = _frames()
    cli = jserving.ScanClient("127.0.0.1", server.port)
    assert cli.init(*INTR, config=TEST_CONFIG)["ready"]
    eng = _engine()
    for f in frames:
        assert cli.add_frame(f) == _wire(eng.add_frame(f))
    assert eng.status == 1
    xyz, rgb = cli.get_cloud()
    pts, cols = eng.get_reconstruction()
    np.testing.assert_array_equal(xyz, pts)
    np.testing.assert_array_equal(rgb, cols)
    assert len(xyz) > 30
    cli.close()


def test_port_client_grey_rgb_and_chunks(server):
    grey = _frames()
    rgb = np.clip(_frames(rgb=True), 0, 255).astype(np.uint8)
    lag = TEST_CONFIG["keyframe_time_lag"]
    # grey float frames by FRAME, uint8 RGB by FRAME, uint8 grey by FRAMES
    for mode, frames in (("frame", grey), ("frame", rgb),
                         ("frames", grey.astype(np.uint8))):
        cli = ScanClient("127.0.0.1", server.port)
        cli.init(*INTR, config=TEST_CONFIG)
        eng = _engine()
        if mode == "frame":
            for f in frames:
                assert cli.add_frame(f) == _wire(
                    eng.add_frame(f.astype(np.float32)))
        else:
            for s in range(0, N, lag):
                got = cli.add_frames(frames[s:s + lag])
                want = eng.add_frames(frames[s:s + lag].astype(np.float32))
                assert got == [_wire(m) for m in want]
        assert eng.status == 1
        xyz, cols = cli.get_cloud()
        pts, want_cols = eng.get_reconstruction()
        np.testing.assert_array_equal(xyz, pts)
        np.testing.assert_array_equal(cols, want_cols)
        assert len(xyz) > 30
        if frames is rgb:
            # the sprite tints are chromatic: real colours, not grey
            spread = cols.astype(int).max(1) - cols.astype(int).min(1)
            assert (spread > 10).mean() > 0.3
        cli.close()


def _init_error(port, client_cls):
    cli = client_cls("127.0.0.1", port)
    with pytest.raises(RuntimeError) as e:
        cli.init(*INTR, config=dict(TEST_CONFIG, image_height=240))
    cli._sock.close()
    return str(e.value)


def test_init_with_an_image_size_override_is_an_error(server):
    """The JAX server builds SfMConfig(image_height=h, image_width=w,
    **overrides): an override that holds the image size is a duplicate
    keyword, reported as MSG_ERROR.  The port keeps that behaviour."""
    with jserving.ScanServer() as jsrv:
        want = _init_error(jsrv.port, jserving.ScanClient)
        # the port's client against the JAX server too
        assert _init_error(jsrv.port, ScanClient) == want
    assert "multiple values for keyword argument 'image_height'" in want
    # the same text but for the package that names the config class
    want = want.replace("sfm_tpu.", "sfm_tpu_torch.")
    assert _init_error(server.port, ScanClient) == want
    assert _init_error(server.port, jserving.ScanClient) == want


def _frame_before_init(port):
    cli = ScanClient("127.0.0.1", port)
    with pytest.raises(RuntimeError, match="FRAME before INIT"):
        cli.add_frame(np.zeros((240, 320), np.float32))
    cli._sock.close()


def test_frame_before_init_is_an_error(server):
    _frame_before_init(server.port)
    with jserving.ScanServer() as jsrv:
        _frame_before_init(jsrv.port)


def test_the_default_device_is_the_card():
    import torch
    if torch.cuda.is_available():
        with ScanServer() as srv:
            assert srv._srv.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ScanServer()
