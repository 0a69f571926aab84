"""The port's twin of tests/test_sanitizers.py: the same small scan through
the port's engine on the CPU must be NaN-free in every lane.

The JAX package checks its scan under ``jax_debug_nans``.  The port has no
such switch, so after every frame the test walks every floating tensor of
``eng.state`` (every slot, valid or not) and the frame's metrics
(``engine.state.nonfinite_fields``, the walk chip_smoke.py applies on the
card) and asserts: no NaN anywhere; an infinity only in a field where the
JAX engine's state after the same frame holds one too (checked against
``sfm_tpu`` on the CPU, frame by frame); and the scan reaches RUNNING, as
the JAX test requires."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from render import SpriteScene, strafe_trajectory
from torch_port_util import chip_smoke

from sfm_tpu.config import SfMConfig as JaxConfig
from sfm_tpu.engine import SfMEngine as JaxEngine
from sfm_tpu_torch.config import SfMConfig
from sfm_tpu_torch.engine import RUNNING, SfMEngine
from sfm_tpu_torch.engine.state import nonfinite_fields

# tests/test_sanitizers.py's configuration, camera and scan
CFG = JaxConfig(max_keypoints=96, max_keyframes=6, max_landmarks=512,
                image_height=120, image_width=160, pyramid_levels=2,
                ransac_hypotheses=32, pnp_hypotheses=16,
                ba_iterations=3, keyframe_min_tracked=20,
                keyframe_time_lag=4, min_init_matches=20,
                mapping_tri_keyframes=3, mapping_reobs_keyframes=3,
                guidance_enabled=False)
K = np.array([[120.0, 0, 80.0], [0, 120.0, 60.0], [0, 0, 1]], np.float32)
N_FRAMES = 16


def _jax_infinite(tree) -> set:
    """Paths (as ``nonfinite_fields`` writes them) of the JAX tree's
    floating leaves that hold an infinity; a NaN fails."""
    out = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(leaf)
        if not np.issubdtype(a.dtype, np.floating):
            continue
        name = jax.tree_util.keystr(path).lstrip(".")
        assert not np.isnan(a).any(), f"the JAX engine's {name} holds NaN"
        if np.isinf(a).any():
            out.add(name)
    return out


@pytest.fixture(scope="module")
def scans():
    scene = SpriteScene(np.random.default_rng(3), n_sprites=60, spread=1.8)
    rvecs, tvecs = strafe_trajectory(N_FRAMES, step=0.05)
    frames = [scene.render(K, rvecs[i], tvecs[i], 120, 160)
              for i in range(N_FRAMES)]
    port = SfMEngine(K, (120, 160), config=SfMConfig(
        **dataclasses.asdict(CFG)), device="cpu")
    ref = JaxEngine(K, (120, 160), config=CFG)
    per_frame = []
    for i, f in enumerate(frames):
        m_t = port.add_frame(f)
        m_j = ref.add_frame(f)
        per_frame.append(dict(
            frame=i, status=int(m_t["status"]),
            state=nonfinite_fields(port.state),
            metrics=nonfinite_fields(m_t),
            jax_state=_jax_infinite(jax.device_get(ref.state)),
            jax_metrics=_jax_infinite(jax.device_get(m_j))))
    return port, per_frame


def test_port_scan_is_nan_free(scans):
    port, per_frame = scans
    nan = [(r["frame"], what, path) for r in per_frame
           for what in ("state", "metrics")
           for path, (n_nan, _, _) in r[what].items() if n_nan]
    assert not nan, f"NaN after (frame, tree, field): {nan}"
    # the scan exercised bootstrap, tracking and mapping, as the JAX
    # test's scan does
    assert port.status == RUNNING
    assert sum(r["status"] == RUNNING for r in per_frame) >= N_FRAMES // 2
    assert int(port.state.kfs.valid.sum()) >= 3


def test_port_infinities_only_where_jax_has_them(scans):
    _, per_frame = scans
    extra = [(r["frame"], what, path) for r in per_frame
             for what in ("state", "metrics")
             for path, (_, pos, neg) in r[what].items()
             if (pos or neg) and path not in r[f"jax_{what}"]]
    assert not extra, f"+-inf the JAX engine does not hold: {extra}"


# chip_smoke.py's kernel driver (``--sanitize-target``, the "sanitize"
# phase), rehearsed on the CPU: each case built at its shape, with the
# plain version in the kernel's place, through the guarded check; and the
# guard bands shown to catch what they are there for
SMOKE = chip_smoke()


@pytest.mark.parametrize("name", list(SMOKE.SANITIZE_CASES))
def test_sanitize_case_rehearsed(name):
    subs = SMOKE.SANITIZE_CASES[name](torch, "cpu")
    assert subs
    for sub in subs:
        assert set(sub["functions"]) <= set(SMOKE.SANITIZE_FUNCTIONS)
        SMOKE.sanitize_check(torch, dict(sub, kernel=sub["plain"]))


def _sub(kernel, plain=lambda x: (x * 2.0,)):
    return dict(label="fake", inputs=(torch.arange(8.0),), kernel=kernel,
                plain=plain, functions=(), exact=True)


def test_guard_passes_a_clean_call():
    def kernel(x):
        out = torch.empty((8,), dtype=torch.float32, device=x.device)
        return (torch.mul(x, 2.0, out=out),)
    assert SMOKE.sanitize_check(torch, _sub(kernel)) == 0


def test_guard_catches_a_write_past_an_output():
    def kernel(x):
        out = torch.empty((8,), dtype=torch.float32, device=x.device)
        torch.mul(x, 2.0, out=out)
        out.as_strided((9,), (1,))[8] = 0.0
        return (out,)
    with pytest.raises(AssertionError, match="after"):
        SMOKE.sanitize_check(torch, _sub(kernel))


def test_guard_catches_a_write_to_an_input():
    def kernel(x):
        x[3] = 7.0
        return (x * 2.0,)
    with pytest.raises(AssertionError, match="input 0"):
        SMOKE.sanitize_check(torch, _sub(kernel))


def test_guard_catches_an_unwritten_output():
    def kernel(x):
        out = torch.empty((8,), dtype=torch.float32, device=x.device)
        out[:7] = x[:7] * 2.0
        return (out,)
    with pytest.raises(AssertionError, match="two poisons"):
        SMOKE.sanitize_check(torch, _sub(kernel))


def test_guard_catches_a_read_past_an_input():
    def kernel(x):
        nxt = x.as_strided((8,), (1,), x.storage_offset() + 1)
        return (x * 2.0 + 0.0 * nxt,)
    with pytest.raises(AssertionError):
        SMOKE.sanitize_check(torch, _sub(kernel))


def test_pose_check_rehearsed(monkeypatch):
    """chip_smoke's pose check (``pose_faults``) with the plain versions,
    summing over the points in reverse order, in the kernels' place: such
    another float32 order of sums passes it for every far-started pose,
    while one iteration fewer, and the gated mode's first round alone,
    fail it for some."""
    from sfm_tpu_torch import ransac
    from sfm_tpu_torch.geometry import pnp

    def refine(K, rv, tv, xyz, uv, w, iters=10, damping=1e-4):
        return pnp.refine_pose_plain(K, rv, tv, xyz.flip(-2), uv.flip(-2),
                                     w.flip(-1), iters, damping)

    def refined(K, rv, tv, xyz, uv, valid, *, threshold, iters):
        rv, tv, inl, n = ransac.refined_plain(
            K, rv, tv, xyz.flip(-2), uv.flip(-2), valid.flip(-1),
            threshold=threshold, iters=iters)
        return rv, tv, inl.flip(-1), n
    monkeypatch.setattr(pnp, "refine_pose_kernel", refine)
    monkeypatch.setattr(ransac, "refined_kernel", refined)
    shares = SMOKE.pose_faults(torch, "cpu")
    assert shares["refine kernel"] == shares["gated kernel"] == 0
    assert shares["refine, one iteration fewer"] > 0
    assert shares["gated, round one alone"] > 0
