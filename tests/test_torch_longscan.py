"""The long-scan path's pieces that need no card: the ``LONGSCAN`` preset
and the long-scan scene against benchmarks/bench_longscan.py, and
chip_smoke.py's "longscan" and "cg" phases rehearsed on the CPU at
TEST_CFG size (the same functions that run on the card at full size; on
the CPU the kernels' plain versions run, so wrappers count their calls
where the kernels count launches)."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from torch_port_util import TEST_CFG_KW, TEST_K

from sfm_tpu_torch import native
from sfm_tpu_torch.ba import large
from sfm_tpu_torch.ba import linearize_pallas as lp
from sfm_tpu_torch.ba import schur_pallas as sp
from sfm_tpu_torch.config import LONGSCAN, SfMConfig
from sfm_tpu_torch.features import match_pallas as mp
from sfm_tpu_torch.synthetic import longscan_scene, serpentine_trajectory

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# LONGSCAN at TEST_CFG's image size and detector, with capacities and
# schedules cut to a 48-frame scan: 16 keyframes, 2048 landmarks, global
# BA every 3 insertions
REHEARSAL_KW = dict(
    LONGSCAN, **{k: TEST_CFG_KW[k] for k in (
        "max_keypoints", "image_height", "image_width", "pyramid_levels",
        "ransac_hypotheses", "pnp_hypotheses", "min_init_matches")},
    max_keyframes=16, max_landmarks=2048, ba_landmark_capacity=512,
    mapping_reobs_capacity=512, ba_local_window=4, global_ba_every=3,
    global_ba_iterations=4, global_ba_cg_iterations=10)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench_longscan():
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    try:
        import bench_longscan
    finally:
        sys.path.pop(0)
    return bench_longscan


@pytest.fixture
def counted(monkeypatch):
    """K1's and K2's dispatches count their calls on the CPU; the counts
    are zeroed afterwards (other files' tests read them)."""
    real_k1, real_k2 = mp.hamming_match, large.ba_linearize

    def k1(*a):
        native.LAUNCHES["hamming_match"] += 1
        return real_k1(*a)

    def k2(*a, **kw):
        native.LAUNCHES["ba_linearize"] += 1
        return real_k2(*a, **kw)
    monkeypatch.setattr(mp, "hamming_match", k1)
    monkeypatch.setattr(large, "ba_linearize", k2)
    yield
    native.reset_launch_counts()


def test_longscan_preset_is_bench_longscan_large(bench_longscan):
    assert LONGSCAN == bench_longscan.LARGE
    cfg = SfMConfig(**LONGSCAN)
    assert (cfg.max_keyframes, cfg.max_landmarks, cfg.global_ba_every,
            cfg.loop_detect_every) == (512, 65536, 32, 0)


def test_longscan_scene_is_bench_longscans(bench_longscan):
    """The port's copy renders bench_longscan's frames."""
    rv, tv = serpentine_trajectory(300)
    rv_j, tv_j = bench_longscan.serpentine_trajectory(300)
    np.testing.assert_array_equal(rv, rv_j)
    np.testing.assert_array_equal(tv, tv_j)
    scene, rv, tv = longscan_scene(1024)
    scene_j, rv_j, tv_j = bench_longscan.make_scene(1024)
    np.testing.assert_array_equal(scene.centers, scene_j.centers)
    np.testing.assert_array_equal(scene.textures, scene_j.textures)
    np.testing.assert_array_equal(tv, tv_j)
    K = np.array([[131.25, 0, 80.0], [0, 131.25, 60.0], [0, 0, 1]],
                 np.float32)
    for i in (0, 517):
        np.testing.assert_array_equal(
            scene.render(K, rv[i], tv[i], 120, 160),
            scene_j.render(K, rv_j[i], tv_j[i], 120, 160))


def test_longscan_phase(smoke, counted, monkeypatch):
    """run_longscan at TEST size: every check of the phase holds, global
    BA runs after every 3 insertions, K2 runs in each call, K1's calls
    are recorded by call site (one record a launch, the replay's input),
    and the K2 arguments it records (the last mapping pass's, the last
    global BA's) feed ba_kernel_rows (the kernels swapped for their plain
    versions), whose gradient check reads every g_cam and g_lm entry."""
    cfg = SfMConfig(**REHEARSAL_KW)
    k1_calls = []
    out = smoke.run_longscan(torch, "cpu", cfg, ("hamming_match",),
                             gba_kernels=("ba_linearize",), K=TEST_K,
                             n_frames=48, min_keyframes=8, workers=0,
                             k1_calls=k1_calls)
    assert len(k1_calls) == out["launches"]["hamming_match"] \
        == sum(out["k1_sites"].values()) > 0
    assert {s for s, _ in k1_calls} == set(out["k1_sites"]) >= {
        "tracking.tracking_step", "tracking.widen_tracks"}
    assert all(len(a) == 10 for _, a in k1_calls)
    assert out["periodic_global_ba_calls"] == out["keyframes_inserted"] // 3
    assert len(out["global_ba_calls"]) == out["periodic_global_ba_calls"] + 2
    assert out["mapping_passes"] == out["keyframes_inserted"] - 1
    assert out["ate_pct"] < 2.0
    assert all(c["lm_iterations"] >= 1 for c in out["global_ba_calls"])
    assert set(out["split_s"]) == {"tracking", "mapping passes",
                                   "global BA (periodic)",
                                   "global BA (final two)"}

    def schur(mode, lm_cam, W, Vinv=None, g=None, x=None, z=None,
              n_cams=None, slots=None):
        if mode == "full":
            return sp.schur_apply_fused_plain(
                lm_cam, W, Vinv, g, x, n_cams if x is None else x.shape[0])
        if mode == "gather":
            return sp.schur_gather_plain(lm_cam, W, Vinv, g, x)
        return sp.schur_scatter_plain(lm_cam, W, z, n_cams)
    monkeypatch.setattr(sp, "schur_kernel", schur)
    monkeypatch.setattr(lp, "ba_linearize_kernel",
                        lambda *a, slots=None: lp.ba_linearize_plain(*a))
    recorded = out["keep"]["recorded"]
    for key, kmax, L in (("global", 16, 2048), ("mapping", 8, 512)):
        args, cs = recorded[key]
        assert args[1].shape[0] == 16 and args[6].shape == (L, kmax)
        assert int(cs.offsets[-1]) == int((args[8] != 0).sum()) > 0
        rows = smoke.ba_kernel_rows(torch, key, args, cs, False,
                                    smoke.GLOBAL_BA_KERNELS, witness=True)
        assert set(rows) == set(smoke.GLOBAL_BA_KERNELS)
        assert all(r["max_abs_err"] == 0 and r["bound_ms"] > 0
                   and len(r["from_f64"]) in (1, 2, 6)
                   for r in rows.values())
        grad = rows["ba_linearize"]["gradients"]
        assert set(grad) == {"g_cam", "g_lm"}
        for out, g in grad.items():
            # the kernel is the plain version here
            assert g["max"]["kernel"] == g["max"]["f32 plain"] \
                <= smoke.GRAD_TOL[out]
            assert g["max"]["kernel terms"] == g["max"]["f32 terms"]
            assert g["obs"] > 0 and g["scale"] > 0


@pytest.mark.parametrize("fault", ["g_cam", "g_lm"])
def test_gradient_check_catches_one_missing_observation(smoke, fault,
                                                       monkeypatch):
    """chip_smoke's entry-by-entry gradient check passes the plain version
    and fails a "kernel" whose g_cam (or g_lm) lacks one observation's
    term in one camera (or landmark): a fault that an rms over all
    entries dilutes by the square root of their count (196608 g_lm
    entries in the long scan's global BA)."""
    from sfm_tpu_torch.geometry.rotations import exp_so3
    monkeypatch.setattr(lp, "ba_linearize_kernel",
                        lambda *a, slots=None: lp.ba_linearize_plain(*a))
    pr = smoke.ba_problem(torch, "cpu", 8, 400, 4, noise_px=1.0, spread=0.2)
    tb = pr["tables"]
    args = (pr["K"], exp_so3(pr["rv"]).contiguous(), pr["tv"], pr["X"],
            pr["lm_free"].float(), pr["cam_free"].float(), tb.lm_cam,
            tb.lm_uv, tb.lm_w, 2.0)
    plain = lp.ba_linearize_plain(*args)
    exact = lp.ba_linearize_plain(*smoke._to_f64(torch, *args))
    smoke.gradient_witness(torch, "plain", args, plain, plain, exact)
    cam, lm, tc, tl, *_ = smoke._gradient_terms(torch, args, torch.float32)
    o = int(torch.nonzero(tb.lm_w.reshape(-1) != 0)[len(cam) // 3])
    bad = list(plain)
    if fault == "g_cam":
        bad[4] = plain[4].index_add(0, cam[o:o + 1], -tc[o:o + 1])
    else:
        bad[2] = plain[2].index_add(0, lm[o:o + 1], -tl[o:o + 1])
    with pytest.raises(AssertionError, match=fault):
        smoke.gradient_witness(torch, "fault", args, bad, plain, exact)


def test_cg_phase(smoke, counted):
    """The "cg" phase (run_slice with ba_solver="cg") at TEST size."""
    cfg = SfMConfig(**dict(TEST_CFG_KW, ba_solver="cg"))
    out = smoke.run_slice(torch, "cpu", cfg, "cg", ("hamming_match",),
                          K=TEST_K, n_frames=24)
    assert out["keyframes"] >= 4 and out["map_ms"] > 0
    assert out["launches"]["ba_linearize"] == 0
