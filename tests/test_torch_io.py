"""The port's host I/O against the JAX package, exactly.

PLY files byte for byte (the C++ runtime and numpy, with and without
colour) and both readers; the frame sources (y4m in Python and C++, npy,
npz, an image directory) value for value; checkpoints both ways (a JAX
checkpoint loads into the port as ``state_from_numpy`` gives it, a port
checkpoint loads into JAX leaf for leaf) and the refusals of a wrong
shape or leaf count; the debug overlay pixel for pixel; and ``cli scan``
end to end on the CPU (PLY, metrics, checkpoint, resume, video, chunks)
with ``info``."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from torch_port_util import TEST_K

from sfm_tpu import viz as jviz
from sfm_tpu.config import SfMConfig as JaxConfig
from sfm_tpu.engine.state import StepMetrics
from sfm_tpu.engine.state import init_state as jax_init_state
from sfm_tpu.guidance import GuidanceOutput
from sfm_tpu.io import checkpoint as jck
from sfm_tpu.io import ply as jply
from sfm_tpu.io import video as jvideo
from sfm_tpu.synthetic import SpriteScene, strafe_trajectory
from sfm_tpu_torch import cli, viz
from sfm_tpu_torch.config import SfMConfig
from sfm_tpu_torch.engine import SfMEngine, state_from_numpy
from sfm_tpu_torch.io import (NativeY4MSource, NpyStackSource, PointCloud,
                              Y4MSource, load_state, open_source, read_ply,
                              runtime, save_state)
from sfm_tpu_torch.io.video import ImageDirSource

SMALL = dict(max_keypoints=32, max_keyframes=4, max_landmarks=64,
             image_height=48, image_width=64, track_with_flow=True)


@pytest.fixture(autouse=True)
def jax_native(monkeypatch):
    """The JAX package's C++ path loads the library that the port's runtime
    built from the same sources (an atomic build), rather than running
    ``make`` inside ``sfm_tpu/native/``, where another test process may be
    building it at the same moment."""
    monkeypatch.setattr(jply, "_LIB_PATH", str(runtime.build()))
    monkeypatch.setattr(jply, "_lib", None)


def _cloud(rng, n=300):
    return (rng.normal(3, 2, (n, 3)).astype(np.float32),
            rng.integers(0, 256, (n, 3)).astype(np.uint8))


def _jax_write(path, xyz, rgb, native, monkeypatch):
    """The JAX package's writer through its C++ runtime, or (with the
    runtime hidden) its numpy version."""
    with monkeypatch.context() as m:
        if not native:
            m.setattr(jply, "_native", lambda: None)
        jply.PointCloud(xyz.copy(), rgb).center().scale(500.0) \
            .write_ply(str(path))


@pytest.mark.parametrize("colour", [True, False])
@pytest.mark.parametrize("native", [True, False])
def test_ply_bytes_match_jax(tmp_path, monkeypatch, native, colour):
    xyz, rgb = _cloud(np.random.default_rng(0))
    rgb = rgb if colour else None
    ref = tmp_path / "jax.ply"
    _jax_write(ref, xyz, rgb, native, monkeypatch)
    out = tmp_path / "port.ply"
    PointCloud(xyz.copy(), rgb, native=native).center().scale(500.0) \
        .write_ply(str(out))
    assert out.read_bytes() == ref.read_bytes()
    for nat in (True, False):
        x, c = read_ply(str(out), native=nat)
        xj, cj = jply.read_ply(str(ref))
        np.testing.assert_array_equal(x, xj)
        if colour:
            np.testing.assert_array_equal(c, cj)
        else:
            assert c is None and cj is None


def test_cloud_ops_match_jax(monkeypatch):
    """add_points, center, scale and normalize: each version of the port
    against the JAX package's same version (the C++ runtime sums in
    double, numpy in float32: the two differ in the last bits)."""
    rng = np.random.default_rng(1)
    (a, ca), (b, cb) = _cloud(rng, 40), _cloud(rng, 25)
    for native in (True, False):
        c = PointCloud(a, ca, native=native).add_points(b, cb)
        c.center().scale(7.5).normalize()
        with monkeypatch.context() as m:
            if not native:
                m.setattr(jply, "_native", lambda: None)
            cj = jply.PointCloud(a, ca).add_points(b, cb).center() \
                .scale(7.5).normalize()
        np.testing.assert_array_equal(c.xyz, cj.xyz)
        np.testing.assert_array_equal(c.colors, cj.colors)


def _write_y4m_420(path, rng, w=32, h=16, n=3):
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F25:1 Ip A1:1 C420\n".encode())
        for _ in range(n):
            f.write(b"FRAME\n")
            f.write(rng.integers(0, 256, h * w + 2 * (h // 2) * (w // 2))
                    .astype(np.uint8).tobytes())


def _same_frames(port, ref, n):
    port, ref = list(port), list(ref)
    assert len(port) == len(ref) == n
    for (g, c), (gj, cj) in zip(port, ref):
        assert g.dtype == gj.dtype
        np.testing.assert_array_equal(g, gj)
        if cj is None:
            assert c is None
        else:
            np.testing.assert_array_equal(c, cj)


def test_y4m_sources_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    p420 = str(tmp_path / "a.y4m")
    _write_y4m_420(p420, rng)
    p444 = str(tmp_path / "b.y4m")
    w = jviz.Y4MWriter(p444, 64, 48, scale=1.0)
    for _ in range(4):
        w.write(rng.integers(0, 256, (48, 64, 3)).astype(np.uint8))
    w.close()
    for p, n in ((p420, 3), (p444, 4)):
        _same_frames(Y4MSource(p), jvideo.Y4MSource(p), n)
        _same_frames(NativeY4MSource(p, prefetch=2), jvideo.Y4MSource(p), n)
    assert isinstance(open_source(p420, native=False), Y4MSource)
    assert isinstance(open_source(p420, native=True), NativeY4MSource)


def test_stack_and_image_dir_sources_match_jax(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(3)
    grey = rng.integers(0, 256, (3, 20, 30)).astype(np.uint8)
    rgb = rng.integers(0, 256, (3, 20, 30, 3)).astype(np.uint8)
    np.save(tmp_path / "g.npy", grey)
    np.savez(tmp_path / "c.npz", frames=rgb)
    for name in ("g.npy", "c.npz"):
        p = str(tmp_path / name)
        _same_frames(NpyStackSource(p), jvideo.NpyStackSource(p), 3)
    d = tmp_path / "frames"
    d.mkdir()
    for i in range(3):
        Image.fromarray(rgb[i]).save(d / f"f{i:03d}.png")
    Image.fromarray(grey[0]).save(d / "f003.png")
    _same_frames(ImageDirSource(str(d)), jvideo.ImageDirSource(str(d)), 4)
    assert isinstance(open_source(str(d)), ImageDirSource)
    with pytest.raises(ValueError):
        open_source(str(tmp_path / "x.mp4"))


def _random_jax_state(cfg, rng):
    """A JAX init_state with every leaf filled with random values of its
    dtype (the key too), so a mix-up of two leaves shows."""
    def fill(leaf):
        a = np.asarray(leaf)
        if a.dtype == np.bool_:
            return rng.uniform(0, 1, a.shape) < 0.5
        if a.dtype.kind in "iu":
            return rng.integers(0, 1000, a.shape).astype(a.dtype)
        return rng.normal(0, 1, a.shape).astype(a.dtype)
    return jax.tree.map(fill, jax_init_state(cfg))


def test_checkpoint_from_jax(tmp_path):
    tree = _random_jax_state(JaxConfig(**SMALL), np.random.default_rng(4))
    p = str(tmp_path / "j.npz")
    jck.save_state(p, tree)
    st = load_state(p, SfMConfig(**SMALL), "cpu")
    ref = state_from_numpy(tree, "cpu")
    from sfm_tpu_torch.io.checkpoint import _leaves
    got, want = list(_leaves(st)), list(_leaves(ref))
    assert [k for k, _ in got] == [k for k, _ in want]
    assert len(got) == len(jax.tree.leaves(tree)) - 1      # the key
    for (k, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype, k
        assert torch.equal(a, b), k


def test_checkpoint_to_jax(tmp_path):
    tree = _random_jax_state(JaxConfig(**SMALL), np.random.default_rng(5))
    p = str(tmp_path / "t.npz")
    save_state(p, state_from_numpy(tree, "cpu"))
    back = jck.load_state(p, JaxConfig(**SMALL))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    np.testing.assert_array_equal(np.asarray(back.key),
                                  np.asarray(jax.random.PRNGKey(0)))
    for a, b in zip(jax.tree.leaves(back._replace(key=tree.key)),
                    jax.tree.leaves(tree)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_refusals(tmp_path):
    cfg = SfMConfig(**SMALL)
    p = str(tmp_path / "c.npz")
    save_state(p, SfMEngine(np.eye(3), (48, 64), None, cfg,
                            device="cpu").state)
    with pytest.raises(ValueError, match="shape"):
        load_state(p, SfMConfig(**dict(SMALL, max_keypoints=48)), "cpu")
    with pytest.raises(ValueError, match="shape"):     # prev_image [1, 1]
        load_state(p, SfMConfig(**dict(SMALL, track_with_flow=False)),
                   "cpu")
    z = dict(np.load(p))
    z["n"] = np.asarray(int(z["n"]) + 1)
    np.savez(tmp_path / "bad.npz", **z)
    with pytest.raises(ValueError, match="leaves"):
        load_state(str(tmp_path / "bad.npz"), cfg, "cpu")


def test_overlay_matches_jax():
    rng = np.random.default_rng(6)
    gray = rng.uniform(0, 255, (60, 80)).astype(np.float32)
    kp = rng.uniform(-5, 85, (40, 2)).astype(np.float32)
    kp_mask = rng.uniform(0, 1, 40) < 0.8
    rp = rng.uniform(0, 80, (30, 2)).astype(np.float32)
    rp_mask = rng.uniform(0, 1, 30) < 0.7
    g = GuidanceOutput(centroid=np.zeros(3, np.float32),
                       bbox_center=np.array([40.0, 30.0], np.float32),
                       bbox_axes=np.array([[0.8, 0.6], [-0.6, 0.8]],
                                          np.float32),
                       bbox_extent=np.array([20.0, 9.0], np.float32),
                       mask=np.zeros((15, 20), np.float32))
    for status in (0, 1, 2):
        kw = dict(reproj_xy=rp, reproj_mask=rp_mask, kp_xy=kp,
                  kp_mask=kp_mask, guidance=g)
        out = viz.overlay_frame(gray, {"status": status}, **kw)
        ref = jviz.overlay_frame(gray, {"status": status}, **kw)
        assert out.dtype == ref.dtype
        np.testing.assert_array_equal(out, ref)


@pytest.fixture(scope="module")
def scan_npy(tmp_path_factory):
    """tests/test_io.py's 14-frame CLI scan, as RGB frames."""
    d = tmp_path_factory.mktemp("scan")
    scene = SpriteScene(np.random.default_rng(3))
    rv, tv = strafe_trajectory(14, step=0.06, yaw_rate=0.001)
    stack = np.stack([scene.render(TEST_K, rv[i], tv[i], 240, 320, rgb=True)
                      for i in range(14)]).astype(np.uint8)
    np.save(d / "scan.npy", stack)
    return d


_FLAGS = ["--fx", "250", "--fy", "250", "--cx", "160", "--cy", "120",
          "--max-keypoints", "192", "--max-keyframes", "8",
          "--max-landmarks", "1024", "--device", "cpu"]


def _metric_lines(path):
    lines = [json.loads(ln) for ln in open(path)]
    for ln in lines:
        assert list(ln) == list(StepMetrics._fields)
    return lines


def test_cli_scan_end_to_end(scan_npy, capsys):
    d = scan_npy
    out, met, ck, vid = (str(d / n) for n in ("c.ply", "m.jsonl", "s.npz",
                                              "v.y4m"))
    assert cli.main(["scan", "--input", str(d / "scan.npy"), "--output",
                     out, "--metrics", met, "--checkpoint", ck, "--video",
                     vid, "--guidance", *_FLAGS]) == 0
    xyz, rgb = read_ply(out, native=False)
    assert len(xyz) > 30 and rgb is not None
    assert abs(np.abs(xyz).max() - 500.0) < 1.0            # scaled volume
    # the engine saw grey frames, as the JAX CLI feeds it: grey colours
    assert (rgb[:, 0] == rgb[:, 1]).all()
    lines = _metric_lines(met)
    assert len(lines) == 14 and lines[-1]["status"] == 1
    # guidance runs in the CLI, not in the step: the metrics keep zeros
    assert not any(ln["guid_bbox_center"][0] for ln in lines)
    assert len(list(Y4MSource(vid))) == 14
    # resume from the checkpoint and run the scan's frames again
    out2, met2 = str(d / "c2.ply"), str(d / "m2.jsonl")
    assert cli.main(["scan", "--input", str(d / "scan.npy"), "--output",
                     out2, "--metrics", met2, "--resume", ck,
                     "--max-frames", "4", *_FLAGS]) == 0
    lines2 = _metric_lines(met2)
    assert len(lines2) == 4 and lines2[0]["status"] == 1
    assert lines2[0]["n_landmarks"] >= lines[-1]["n_landmarks"] - 5
    capsys.readouterr()
    assert cli.main(["info", "--input", out]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["n_points"] == len(xyz) and info["has_color"]


def test_cli_chunked_scan(scan_npy):
    """--chunk pads the tail chunk and drops the padded frames' metrics:
    one line per input frame."""
    d = scan_npy
    met = str(d / "mc.jsonl")
    assert cli.main(["scan", "--input", str(d / "scan.npy"), "--output",
                     str(d / "cc.ply"), "--metrics", met, "--chunk", "4",
                     *_FLAGS]) == 0
    lines = _metric_lines(met)
    assert len(lines) == 14 and lines[-1]["status"] == 1
    assert os.path.getsize(d / "cc.ply") > 100


def test_cli_refuses_a_missing_device(scan_npy):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["scan", "--input", str(scan_npy / "scan.npy"),
                  "--output", str(scan_npy / "x.ply"),
                  *_FLAGS[:-2], "--device", "cuda"])
