"""The multi-scan fleet on its own (no JAX): each batched function against
its single-scan call scan by scan, the isolation of the scans in a fleet,
the driver's chunk semantics, and the mirrors of tests/test_parallel.py's
TestMultiScanDriver, at the same small size (120x160, 3 scans)."""

import copy
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from torch_port_util import to_np, to_t

from sfm_tpu_torch.ba.core import compact_landmarks
from sfm_tpu_torch.config import SfMConfig
from sfm_tpu_torch.engine import SfMEngine, tracking
from sfm_tpu_torch.engine.loop import LoopProbe
from sfm_tpu_torch.engine.mapping import mapping_pass
from sfm_tpu_torch.engine.state import (LOST, RUNNING, CameraParams,
                                        index_state, init_batched_state,
                                        init_state, make_frame, make_frames,
                                        stack_states, state_to_numpy,
                                        write_scan)
from sfm_tpu_torch.features import descriptor
from sfm_tpu_torch.features.patches_pallas import extract_patches_plain
from sfm_tpu_torch.mapstore import (_set_drop, add_descriptors, add_views,
                                    increment_age, insert_keyframe)
from sfm_tpu_torch.parallel import (MultiScanDriver, build_batched_step,
                                    scan_generator)
from sfm_tpu_torch.ransac import ransac_pnp, sample_masked
from sfm_tpu_torch.synthetic import SpriteScene, strafe_trajectory

# the module: the package re-exports the function ``detect`` under its name
detect = importlib.import_module("sfm_tpu_torch.features.detect")

CFG = SfMConfig(max_keypoints=96, max_keyframes=4, max_landmarks=256,
                image_height=120, image_width=160, pyramid_levels=2,
                ransac_hypotheses=32, pnp_hypotheses=16, ba_iterations=3,
                keyframe_min_tracked=10, keyframe_time_lag=4,
                min_init_matches=15, mapping_tri_keyframes=2,
                mapping_reobs_keyframes=2)
K = np.array([[130., 0, 80], [0, 130., 60], [0, 0, 1]], np.float32)
B, T = 3, 4


def cam():
    return CameraParams(K=to_t(K), d=torch.zeros(5), Kopt=to_t(K))


def chunks(n_frames=12, rgb=False, n=B):
    """test_parallel's fleet as [T, n, H, W(, 3)] float32 chunks."""
    scenes = [SpriteScene(np.random.default_rng(20 + b), n_sprites=80)
              for b in range(n)]
    rv, tv = strafe_trajectory(n_frames, step=0.08)
    return [np.stack([np.stack([s.render(K, rv[c * T + i], tv[c * T + i],
                                         120, 160, rgb=rgb) for s in scenes])
                      for i in range(T)]).astype(np.float32)
            for c in range(n_frames // T)]


def driver(**kw):
    return MultiScanDriver(dataclasses.replace(CFG, **kw), cam(), batch=B,
                           bucket=2, device="cpu")


def assert_trees_equal(a, b):
    if isinstance(a, dict):
        for k in a:
            assert_trees_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# each batched function against its single-scan call, scan by scan
# ---------------------------------------------------------------------------

def test_batched_detect_and_frames_equal_single():
    imgs = to_t(chunks()[1][0])
    kps, canvas = detect.detect(imgs, max_keypoints=96, levels=2,
                                return_canvas=True)
    fno = to_t(np.array([3, 5, 8], np.int32))
    frames = make_frames(CFG, cam(), imgs, fno)
    for b in range(B):
        one, c1 = detect.detect(imgs[b], max_keypoints=96, levels=2,
                                return_canvas=True)
        for x, y in zip(kps, one):
            assert torch.equal(x[b], y)
        assert torch.equal(canvas[b], c1)
        fr = make_frame(CFG, cam(), imgs[b], fno[b])
        for f in dataclasses.fields(fr):
            assert torch.equal(getattr(frames, f.name)[b],
                               getattr(fr, f.name)), f.name
    assert int(frames.kp_valid.sum(-1).min()) > 40
    # RGB frames: detection on the luma, colours from RGB
    rgb = to_t(chunks(rgb=True)[1][0])
    frames = make_frames(CFG, cam(), rgb, fno)
    for b in range(B):
        fr = make_frame(CFG, cam(), rgb[b], fno[b])
        assert torch.equal(frames.color[b], fr.color)
        assert torch.equal(frames.desc[b], fr.desc)


def test_batched_patches_equal_single_with_windows_off_every_side():
    """K5's plain version over a batch: each scan samples its own canvas;
    taps outside it read 0, never the next canvas's rows."""
    rng = np.random.default_rng(4)
    hc, wc, n = 40, 50, 64
    canvas = to_t(rng.uniform(0, 255, (B, hc, wc)).astype(np.float32))
    cx = rng.uniform(-20, wc + 20, (B, n)).astype(np.float32)
    cy = rng.uniform(-20, hc + 20, (B, n)).astype(np.float32)
    cx[:, :4] = [-17.5, wc + 16.25, wc / 2, 3.5]
    cy[:, :4] = [hc / 2, hc / 2, hc + 5.75, -12.5]
    out = extract_patches_plain(canvas, to_t(cx), to_t(cy))
    assert out.shape == (B, n, 33, 33)
    for b in range(B):
        assert torch.equal(out[b], extract_patches_plain(
            canvas[b], to_t(cx[b]), to_t(cy[b])))
    # the window below canvas 0's last row reads zeros
    assert float(out[0, 2, -8:].abs().max()) == 0.0
    descs = descriptor.bits_from_patches(out, 512)
    for b in range(B):
        assert torch.equal(descs[b], descriptor.bits_from_patches(out[b],
                                                                  512))


def test_compact_landmarks_batched():
    rng = np.random.default_rng(5)
    valid = to_t(rng.uniform(0, 1, (B, 300)) < 0.3)
    rank, inv = compact_landmarks(valid, 64)
    for b in range(B):
        r1, i1 = compact_landmarks(valid[b], 64)
        assert torch.equal(rank[b], r1) and torch.equal(inv[b], i1)


@pytest.mark.parametrize("solver", ["dlt", "p3p"])
def test_ransac_pnp_batched_equals_single(solver):
    """Injected samples: the batched solve against each scan's own call
    (the same ops over a leading axis), with the fast path on and a prior
    near the truth for scans 0 and 2 and far off for scan 1.  Inlier sets
    exactly; poses within 1e-5: batched and single products and
    eigensolves may round the last bits apart (the fleet isolation test
    below holds a fleet to fleets of one exactly)."""
    rng = np.random.default_rng(6)
    n = 80
    X = rng.uniform([-2, -1.5, 4], [2, 1.5, 8], (B, n, 3)).astype(np.float32)
    rv_true = rng.normal(0, 0.05, (B, 3)).astype(np.float32)
    tv_true = rng.normal(0, 0.2, (B, 3)).astype(np.float32)
    from sfm_tpu_torch.geometry.camera import project
    uv = project(to_t(K), to_t(rv_true), to_t(tv_true), to_t(X))
    uv = uv + to_t(rng.normal(0, 0.5, (B, n, 2)).astype(np.float32))
    uv[:, :15] += 40.0                                    # outliers
    valid = to_t(rng.uniform(0, 1, (B, n)) < 0.9)
    prior_rv = to_t(rv_true + 0.02)
    prior_tv = to_t(tv_true + 0.05)
    prior_rv[1] += 0.3                                    # scan 1: bad prior
    s = 3 if solver == "p3p" else 6
    samples = torch.stack([sample_masked(torch.Generator().manual_seed(b),
                                         valid[b], 16, s) for b in range(B)])
    kw = dict(n_hypotheses=16, sample_size=6, threshold=4.0, min_inliers=8,
              solver=solver, fast_path_ratio=0.8)
    res = ransac_pnp(None, to_t(K), to_t(X), uv, valid, prior_rvec=prior_rv,
                     prior_tvec=prior_tv, samples=samples, **kw)
    for b in range(B):
        one = ransac_pnp(None, to_t(K), to_t(X[b]), uv[b], valid[b],
                         prior_rvec=prior_rv[b], prior_tvec=prior_tv[b],
                         samples=samples[b], **kw)
        for x, y in zip(res[:2], one[:2]):
            torch.testing.assert_close(x[b], y, rtol=0, atol=1e-5)
        for x, y in zip(res[2:], one[2:]):
            assert torch.equal(x[b], y)
        assert int(one.n_inliers) >= 0.7 * int(valid[b, 15:].sum())
    with pytest.raises(ValueError):
        ransac_pnp(None, to_t(K), to_t(X), uv, valid, **kw)


def test_state_helpers():
    """init_batched_state is B fresh states stacked; index_state and
    write_scan take and put one scan's row, the others untouched."""
    st = init_batched_state(CFG, B, "cpu")
    one = init_state(CFG, "cpu")
    assert_trees_equal(state_to_numpy(st),
                       state_to_numpy(stack_states([one] * B)))
    sub = index_state(st, 1).replace(status=torch.tensor(RUNNING,
                                                         dtype=torch.int32))
    sub = sub.replace(lms=sub.lms.replace(xyz=sub.lms.xyz + 2.0))
    before = copy.deepcopy(state_to_numpy(st))
    write_scan(st, 1, sub)
    assert to_np(st.status).tolist() == [0, RUNNING, 0]
    assert (to_np(st.lms.xyz)[1] == 2.0).all()
    for b in (0, 2):
        assert_trees_equal(state_to_numpy(index_state(st, b)),
                           _row(before, b))


def test_mapstore_ops_batched_never_write_another_scan():
    st = init_batched_state(CFG, B, "cpu")
    rng = np.random.default_rng(7)
    L = CFG.max_landmarks
    lms = st.lms.replace(
        valid=to_t(rng.uniform(0, 1, (B, L)) < 0.5),
        xyz=to_t(rng.normal(0, 1, (B, L, 3)).astype(np.float32)))
    # scan 0 writes only its sentinel row; the others their own rows
    ids = to_t(rng.integers(0, L, (B, 40)).astype(np.int32))
    ids[0] = L
    vals = to_t(rng.normal(0, 1, (B, 40, 3)).astype(np.float32))
    out = _set_drop(lms.xyz, ids, vals)
    assert torch.equal(out[0], lms.xyz[0])
    for b in range(B):
        assert torch.equal(out[b], _set_drop(lms.xyz[b], ids[b], vals[b]))
    ids = torch.where(to_t(rng.uniform(0, 1, (B, 40)) < 0.7),
                      to_t(rng.integers(0, L, (B, 40)).astype(np.int32)), -1)
    ids[2] = -1
    desc = to_t(rng.integers(-2 ** 31, 2 ** 31, (B, 40, 16)).astype(
        np.int32))
    cols = to_t(rng.uniform(0, 255, (B, 40, 3)).astype(np.float32))
    v = add_views(lms, ids)
    d = add_descriptors(lms, ids, desc, colors=cols)
    a = increment_age(lms, to_t(np.array([[1], [0], [2]], np.int32)), 1)
    for b in range(B):
        one = index_state(lms, b)
        assert torch.equal(v.n_views[b], add_views(one, ids[b]).n_views)
        d1 = add_descriptors(one, ids[b], desc[b], colors=cols[b])
        for name in ("desc_votes", "n_desc", "color_sum"):
            assert torch.equal(getattr(d, name)[b], getattr(d1, name))
        assert torch.equal(a.t_alive[b],
                           increment_age(one, [1, 0, 2][b], 1).t_alive)
    assert torch.equal(d.desc_votes[2], lms.desc_votes[2])
    # keyframe insertion: scan 0 inserts, scan 1 does not want to, scan 2's
    # store is full
    frames = make_frames(CFG, cam(), to_t(chunks()[0][0]),
                         to_t(np.array([4, 4, 4], np.int32)))
    kfs = st.kfs.replace(valid=to_t(np.array([[True, False, True, False],
                                              [False] * 4, [True] * 4])))
    want = to_t(np.array([True, False, True]))
    new, slot = insert_keyframe(kfs, frames, want)
    assert slot.tolist() == [1, -1, -1]
    for b in range(B):
        one, s1 = insert_keyframe(index_state(kfs, b),
                                  index_state(frames, b))
        if want[b]:
            assert int(s1) == int(slot[b])
            ref = one
        else:
            ref = index_state(kfs, b)
        assert torch.equal(new.valid[b], ref.valid)
        for f in dataclasses.fields(ref.frames):
            assert torch.equal(getattr(new.frames, f.name)[b],
                               getattr(ref.frames, f.name)), f.name


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

def test_fleet_isolation():
    """A fleet of three equals three fleets of one with the scans' own
    generators: every frame's status, keyframe flag and pose, exactly (the
    batched ops compute each scan as its own call does)."""
    data = chunks()
    fleet = driver()
    ms = [fleet.step_chunk(ch) for ch in data]
    for b in range(B):
        one = MultiScanDriver(CFG, cam(), batch=1, device="cpu")
        one.generators = [scan_generator(7, b, "cpu")]
        m1 = [one.step_chunk(ch[:, b:b + 1]) for ch in data]
        for m, n in zip(ms, m1):
            for k in ("status", "keyframe_added", "n_inliers", "rvec",
                      "tvec"):
                assert torch.equal(m[k][:, b], n[k][:, 0]), (b, k)
        assert_trees_equal(state_to_numpy(index_state(fleet.states, b)),
                           state_to_numpy(index_state(one.states, 0)))


@pytest.mark.parametrize("case,frame_i", [("plain", 7), ("flow", 7),
                                          ("keyframe", 5)])
def test_fleet_of_one_equals_tracking_step(case, frame_i, monkeypatch):
    """The two tracking drivers held to each other: ``fleet_tracking_step``
    on a fleet of one against ``tracking_step`` on the same RUNNING state
    and frame of scan 0, with inline mapping and the same PnP samples
    injected into both, on a plain frame, a frame tracked with LK flow,
    and a frame that inserts a keyframe and maps it.  Status, keyframe
    flag, counts, links, view counts and the map exactly; the PnP poses
    within 1e-5, as the batched PnP above.  The refined poses within
    1e-3 rad / m, as against the JAX fleet: on the plain frame the pose
    refinement's four iterations take the PnP poses' 6.9e-7 m apart to
    3.6e-4 m apart (from one start they end 2.4e-7 m apart; measured on
    a CPU)."""
    cfg = dataclasses.replace(CFG, track_with_flow=case == "flow")
    c = cam()
    eng = SfMEngine(K, (120, 160), config=cfg, device="cpu")
    imgs = to_t(np.concatenate([ch[:, 0] for ch in chunks()]))
    for img in imgs[:frame_i]:
        eng.add_frame(img)
    st, img = eng.state, imgs[frame_i]
    assert int(st.status) == RUNNING
    frame = make_frame(cfg, c, img, st.frame_count)
    mapping_fn = lambda s, slot: mapping_pass(cfg, c, s, slot)  # noqa: E731
    # each PnP call's validity mask and result
    seen, real = [], tracking.ransac_pnp

    def pnp(*a, **kw):
        out = real(*a, **kw)
        seen.append((a[4], out))
        return out
    monkeypatch.setattr(tracking, "ransac_pnp", pnp)
    # the samples: drawn once over the validity mask the PnP is given
    tracking.tracking_step(cfg, c, st, frame, mapping_fn,
                           torch.Generator().manual_seed(0), image=img)
    samples = sample_masked(torch.Generator().manual_seed(1), seen[0][0],
                            cfg.pnp_hypotheses, cfg.pnp_sample_size)

    st_s, m_s = tracking.tracking_step(cfg, c, st, frame, mapping_fn,
                                       pnp_samples=samples, image=img)
    st_f, m_f = tracking.fleet_tracking_step(
        cfg, c, stack_states([st]), make_frames(cfg, c, img[None],
                                                st.frame_count[None]),
        None, mapping_fn, pnp_samples=samples[None], images=img[None])
    (_, pnp_s), (_, pnp_f) = seen[1:]
    for x, y in zip(pnp_f[:2], pnp_s[:2]):
        torch.testing.assert_close(x[0], y, rtol=0, atol=1e-5)
    for x, y in zip(pnp_f[2:], pnp_s[2:]):
        assert torch.equal(x[0], y)
    assert bool(m_s["keyframe_added"]) == (case == "keyframe")
    for k in ("status", "keyframe_added", "n_matches", "n_inliers",
              "n_tracked", "n_landmarks", "n_keyframes"):
        assert torch.equal(m_f[k][0], m_s[k]), k
    for k in ("rvec", "tvec", "mean_reproj_err"):
        torch.testing.assert_close(m_f[k][0], m_s[k], rtol=0, atol=1e-3)
    one = index_state(st_f, 0)
    for name in ("status", "lost_count", "last_kf_frame_no",
                 "last_kf_tracked", "pending_map_slot"):
        assert torch.equal(getattr(one, name), getattr(st_s, name)), name
    assert torch.equal(one.prev.landmark, st_s.prev.landmark)
    assert torch.equal(one.kfs.valid, st_s.kfs.valid)
    assert torch.equal(one.kfs.frames.landmark, st_s.kfs.frames.landmark)
    assert torch.equal(one.lms.valid, st_s.lms.valid)
    assert torch.equal(one.lms.n_views, st_s.lms.n_views)


def test_lost_mid_chunk_drops_the_rest_of_the_chunk():
    """A RUNNING scan that goes LOST within a chunk no-ops on its remaining
    frames (their metrics are zeros but status and n_detected, and its
    frame count stays), is not re-stepped in that chunk, and relocalizes
    from the next chunk on through the full step."""
    data = chunks(16)
    data[2][1:, 1] = 25.0                     # blank frames for scan 1
    drv = driver(max_lost_frames=0)
    ms = [drv.step_chunk(ch) for ch in data[:3]]
    st = to_np(ms[2]["status"])
    assert st[:, 1].tolist() == [RUNNING, LOST, LOST, LOST]
    assert (st[:, [0, 2]] == RUNNING).all()
    assert to_np(drv.states.frame_count).tolist() == [12, 10, 12]
    assert to_np(ms[2]["n_matches"])[2:, 1].tolist() == [0, 0]
    assert not to_np(ms[2]["rvec"])[2:, 1].any()
    assert int(drv.states.status[1]) == LOST
    m = drv.step_chunk(data[3])
    # the tracking steps no-op the LOST scan; the full steps take its frames
    assert to_np(m["status"])[:, 1].tolist() == [LOST] * T
    assert to_np(drv.states.frame_count).tolist() == [16, 14, 16]
    assert int(drv.states.status[1]) == RUNNING


def test_step_and_step_chunk():
    """tests/test_parallel.py's bucketed-dispatch and chunked-stepping
    checks: both bootstrap, track and map the fleet."""
    data = chunks()
    for per_frame in (True, False):
        drv = driver()
        for ch in data:
            if per_frame:
                for img in ch:
                    m = drv.step(img)
            else:
                m = {k: v[-1] for k, v in drv.step_chunk(ch).items()}
        assert (to_np(m["status"]) == RUNNING).sum() >= 2
        assert (to_np(drv.states.pending_map_slot) == -1).all()
        assert to_np(m["n_keyframes"]).max() >= 3
        assert m["status"].shape == (B,)


def test_uint8_staging_matches_f32():
    data = [np.floor(ch) for ch in chunks(8)]
    out = []
    for dtype in (np.float32, np.uint8):
        drv = driver()
        for ch in data:
            drv.step_chunk(ch.astype(dtype))
        out.append(state_to_numpy(drv.states))
    assert_trees_equal(*out)


def test_rgb_fleet_runs_guidance():
    drv = driver()
    for ch in chunks(rgb=True):
        m = drv.step_chunk(ch)
    run = to_np(m["status"])[-1] == RUNNING
    assert run.sum() >= 1
    ext = to_np(m["guid_bbox_extent"])[-1]
    assert (ext[run].max(axis=1) > 0).all()
    assert not ext[~run].any()


def test_build_batched_step_maps_inline():
    """The full step of every scan with inline mapping: no slot is left
    pending, and the fleet bootstraps and inserts keyframes."""
    step = build_batched_step(CFG, cam())
    st = init_batched_state(CFG, B, "cpu")
    for ch in chunks():
        for img in ch:
            st, m = step(st, to_t(img))
            assert (to_np(st.pending_map_slot) == -1).all()
    assert (to_np(st.status) == RUNNING).all()
    assert to_np(m["n_keyframes"]).min() >= 3


def test_probe_loops_noop_and_injected_closure():
    drv = driver(loop_min_inliers=10, loop_min_drift=0.01)
    for ch in chunks():
        drv.step_chunk(ch)
    assert (to_np(drv.states.status) == RUNNING).sum() >= 2
    assert drv.probe_loops() == [] and drv.loop_closures == []
    # copies: on the CPU the numpy arrays share the state's memory, and the
    # driver writes a scan back in place
    before = copy.deepcopy(state_to_numpy(drv.states))
    fns = np.where(before["kfs"]["valid"], before["kfs"]["frames"]["frame_no"],
                   -1)
    slots = fns.argmax(axis=1)
    tgt = 1
    rv_t = before["kfs"]["frames"]["rvec"][tgt, slots[tgt]]
    tv_t = before["kfs"]["frames"]["tvec"][tgt, slots[tgt]]
    N = CFG.max_keypoints
    mk = lambda x: np.stack([np.asarray(x, np.float32)] * B)  # noqa: E731
    probes = LoopProbe(
        ok=np.array([False, True, False]), rvec=mk(rv_t),
        tvec=mk(tv_t + np.array([0.05, 0, 0])),
        n_inliers=np.full(B, 20, np.int32), drift=np.full(B, 0.05,
                                                          np.float32),
        links=np.full((B, N), -1, np.int32),
        min_lm_birth=np.zeros(B, np.int32), scale=np.ones(B, np.float32),
        scale_ok=np.zeros(B, bool), n_pairs=np.zeros(B, np.int32))
    closed = drv.probe_loops(probes=probes, slots=slots)
    assert len(closed) == 1 and closed[0][0] == tgt
    assert drv.loop_closures == closed
    after = state_to_numpy(drv.states)
    for i in (0, 2):
        assert_trees_equal(state_to_numpy(index_state(drv.states, i)),
                           _row(before, i))
    assert np.abs(after["kfs"]["frames"]["tvec"][tgt]
                  - before["kfs"]["frames"]["tvec"][tgt]).max() > 1e-4


def _row(tree, i):
    return {k: _row(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def test_driver_refuses_a_long_chunk_and_a_missing_card():
    drv = driver()
    with pytest.raises(ValueError):
        drv.step_chunk(np.zeros((CFG.keyframe_time_lag + 1, B, 120, 160),
                                np.float32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            MultiScanDriver(CFG, cam(), batch=B)


def test_chip_smoke_fleet_phase_rehearsed(monkeypatch):
    """chip_smoke's "fleet" phase at TEST size (240x320, 3 scans, 24
    frames, the frames rendered here): every check passes, with K1's and
    K5's dispatches counting their calls on the CPU, and K1's calls in
    the timed tracking steps recorded by call site."""
    import importlib.util
    import os

    from torch_port_util import TEST_CFG_KW, TEST_K

    from sfm_tpu_torch import native
    from sfm_tpu_torch.features import match_pallas as mp
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    real_k1, real_k5 = mp.hamming_match, descriptor.extract_patches_pallas

    def k1(*a):
        native.LAUNCHES["hamming_match"] += 1
        return real_k1(*a)

    def k5(*a):
        native.LAUNCHES["patch_sampler"] += 1
        return real_k5(*a)
    monkeypatch.setattr(mp, "hamming_match", k1)
    monkeypatch.setattr(descriptor, "extract_patches_pallas", k5)
    calls = []
    try:
        out = smoke.run_fleet(torch, "cpu", SfMConfig(**TEST_CFG_KW),
                              K=TEST_K, batch=3, n_frames=24, orbit=24,
                              workers=0, k1_calls=calls, single_fps=1.0)
    finally:
        native.reset_launch_counts()
    steps = out["tracking_steps"]
    assert steps == 18
    assert out["k1_sites"] == {"tracking.fleet_tracking_step": steps,
                               "tracking.widen_tracks": steps}
    assert len(calls) == 2 * steps
    assert {a[0].shape[0] for _, a in calls} == {3}
    assert out["alone"]["keyframes"] == out["alone"]["fleet_keyframes"]
    assert out["keep"]["chunk"].dtype == torch.uint8
