"""Loop closure (engine/loop.py and the engine's schedule) against the JAX
package.

- The host helpers (SE(3) log / exp, ``interpolate_corrections``) on
  random poses, fractions 0 and 1, rotations near pi, scale 1 and 1.5.
- ``_masked_median`` and ``_scale_from_pairs`` on seeded pairs with
  outliers, an empty mask and too few pairs.
- ``retriangulate_landmarks`` on tests/test_loop.py's recovery state and
  on a state carried from a JAX scan; ``close_loop`` on its drifted
  chain, with and without scale and with an overlapping corrected span.
- ``build_loop_probe`` on a JAX scan's carried state made into a loop
  (half of the newest keyframe's links cleared, the other half relinked
  to young twins shrunk by 1.3, its pose shifted), with the JAX RANSAC
  samples injected.

The engine's side is in tests/test_torch_loop_engine.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (LOOP_KW, TEST_K, jax_loop_scan,
                             jitted_jax_retriangulation, loop_state, to_np,
                             to_t)

from sfm_tpu.config import SfMConfig as JaxConfig
from sfm_tpu.engine import loop as jloop
from sfm_tpu.engine.state import CameraParams as JaxCam
from sfm_tpu.engine.state import init_state as jax_init_state
from sfm_tpu.features.match import match_features as jax_match
from sfm_tpu.ransac import sample_masked as jax_sample_masked
from sfm_tpu_torch.config import SfMConfig
from sfm_tpu_torch.engine import (CameraParams, LoopProbe, build_loop_probe,
                                  close_loop, interpolate_corrections,
                                  retriangulate_landmarks, state_from_numpy)
from sfm_tpu_torch.engine import loop as tloop
from sfm_tpu_torch.np_geometry import rodrigues_np

@pytest.fixture(scope="module")
def jax_scan():
    return jax_loop_scan()


@pytest.fixture(autouse=True)
def jitted_retriangulation(monkeypatch):
    jitted_jax_retriangulation(monkeypatch)


def _port_cam(K=TEST_K):
    K = to_t(K)
    return CameraParams(K=K, d=to_t(np.zeros(5, np.float32)), Kopt=K)


def _jax_cam(K=TEST_K):
    return JaxCam(K=jnp.asarray(K), d=jnp.zeros(5), Kopt=jnp.asarray(K))


# ------------------------------------------------------------ host helpers

def _near_pi_rotations(rng):
    out = []
    for axis in ([0, 0, 1.0], [1.0, 0, 0], [0.3, -0.8, 0.52]):
        k = np.asarray(axis) / np.linalg.norm(axis)
        out += [k * th for th in (np.pi, np.pi - 1e-5, np.pi - 9e-5)]
    return out + list(rng.normal(0, 1.0, (6, 3)))


def test_se3_helpers_equal_jax():
    rng = np.random.default_rng(0)
    for r in _near_pi_rotations(rng):
        R = tloop._rodr(r)
        assert np.abs(R - jloop._rodr(r)).max() <= 1e-12
        assert np.abs(tloop._log_so3(R) - jloop._log_so3(R)).max() <= 1e-12
    assert np.array_equal(tloop._log_so3(np.eye(3)), np.zeros(3))


@pytest.mark.parametrize("scale", [1.0, 1.5])
def test_interpolate_corrections_equals_jax(scale):
    """Random poses (some rotations within 1e-4 of pi), fractions with 0
    and 1, a correction near pi too: float64 numpy on both sides."""
    rng = np.random.default_rng(int(scale * 10))
    rv = np.concatenate([np.stack(_near_pi_rotations(rng)),
                         rng.normal(0, 0.3, (5, 3))])
    tv = rng.normal(0, 1.0, rv.shape)
    fracs = np.concatenate([[0.0, 1.0, 1.0, 0.0],
                            rng.uniform(0, 1, len(rv) - 4)])
    for d_rvec in (np.array([0.02, -0.3, 0.1]),
                   np.array([0.0, np.pi - 5e-5, 0.0])):
        dt = rng.normal(0, 1.0, 3)
        got = interpolate_corrections(rv, tv, fracs, d_rvec, dt, scale=scale)
        ref = jloop.interpolate_corrections(rv, tv, fracs, d_rvec, dt,
                                            scale=scale)
        for a, b in zip(got, ref):
            assert a.dtype == np.float64
            assert np.abs(a - b).max() <= 1e-12
        # fraction 0 leaves the pose bit-exact
        np.testing.assert_array_equal(got[0][0], rv[0])
        np.testing.assert_array_equal(got[1][3], tv[3])


# ------------------------------------------------------- median and scale

def test_masked_median_equals_jax():
    rng = np.random.default_rng(1)
    vals = rng.uniform(0, 5, 97).astype(np.float32)
    for mask in (rng.uniform(0, 1, 97) < 0.4, np.ones(97, bool),
                 np.zeros(97, bool), np.arange(97) == 5):
        got = float(tloop._masked_median(to_t(vals), to_t(mask)))
        ref = float(jloop._masked_median(jnp.asarray(vals),
                                         jnp.asarray(mask)))
        assert got == ref and not np.isnan(got)
    assert float(tloop._masked_median(to_t(vals), to_t(np.zeros(97, bool)))) \
        == np.inf


def _pairs(rng, n, s, noise=0.01, outliers=5):
    """Old positions and their drifted twins x_drift = dR^T (x_old - dt) / s
    with noise and gross outliers (tests/test_loop.py's construction)."""
    Xo = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                   rng.uniform(4, 9, n)], 1)
    R = jloop._rodr(np.array([0.1, -0.2, 0.05]))
    Xc = (R.T @ ((Xo - np.array([0.7, -0.3, 1.1])) / s).T).T
    Xc = Xc + rng.normal(0, noise, Xc.shape)
    Xc[rng.choice(n, outliers, replace=False)] += rng.normal(0, 3.0,
                                                             (outliers, 3))
    return Xo.astype(np.float32), Xc.astype(np.float32)


@pytest.mark.parametrize("case", ["outliers", "sparse", "empty", "few",
                                  "junk", "long"])
def test_scale_from_pairs_equals_jax(case):
    """Seeded pairs with outliers (all rows matched, a sparse mask over
    100 rows, more than the 64 rows kept), an empty mask, fewer than
    min_pairs, and incoherent pairs: ok and n_points equal, s within
    1e-6 relative, no NaN."""
    rng = np.random.default_rng(["outliers", "sparse", "empty", "few",
                                 "junk", "long"].index(case))
    n = {"sparse": 100, "long": 150}.get(case, 40)
    Xo, Xc = _pairs(rng, n, 1.4)
    mask = np.ones(n, bool)
    if case == "sparse":
        mask = rng.uniform(0, 1, n) < 0.3
    elif case == "empty":
        mask[:] = False
    elif case == "few":
        mask = np.arange(n) < 5
    elif case == "junk":
        Xc = Xc[rng.permutation(n)]
    s, ok, n_pts = tloop._scale_from_pairs(to_t(Xo), to_t(Xc), to_t(mask))
    sj, okj, nj = jloop._scale_from_pairs(jnp.asarray(Xo), jnp.asarray(Xc),
                                          jnp.asarray(mask))
    assert bool(ok) == bool(okj) and int(n_pts) == int(nj)
    assert np.isfinite(float(s))
    np.testing.assert_allclose(float(s), float(sj), rtol=1e-6)
    assert bool(ok) == (case in ("outliers", "sparse", "long"))
    if bool(ok):
        assert abs(float(s) - 1.4) < 0.1


# --------------------------------------------- states for the host steps

def _retri_state():
    """tests/test_loop.py::TestSim3Correction::
    test_recovers_points_from_poses's state (4 keyframes see 8 points at
    positions 0.5 off), with two more landmarks, seen once and never.
    Returns (config keywords, K, parts, true points)."""
    cfg = dict(max_keypoints=16, max_keyframes=4, max_landmarks=32,
               image_height=96, image_width=128, pyramid_levels=2, ba_kmax=4)
    K = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]], np.float32)
    rng = np.random.default_rng(1)
    X = np.stack([rng.uniform(-1, 1, 10), rng.uniform(-0.7, 0.7, 10),
                  rng.uniform(3, 5, 10)], 1).astype(np.float32)
    landmark = np.full((4, 16), -1, np.int32)
    xy = np.zeros((4, 16, 2), np.float32)
    tvs = np.stack([np.array([0.3 * c, 0, 0], np.float32) for c in range(4)])
    for c in range(4):
        p = X + tvs[c]
        xy[c, :10] = (p[:, :2] / p[:, 2:]) * 100.0 + np.array([64.0, 48.0])
        landmark[c, :8] = np.arange(8)
    landmark[0, 8] = 8           # landmark 8: one observation
    xyz = np.pad(X + rng.normal(0, 0.5, X.shape), ((0, 22), (0, 0)))
    return cfg, K, dict(landmark=landmark, xy=xy,
                        rvec=np.zeros((4, 3), np.float32), tvec=tvs,
                        kp_valid=np.arange(16)[None].repeat(4, 0) < 10,
                        frame_no=np.arange(4, dtype=np.int32),
                        kf_valid=np.ones(4, bool),
                        lm_valid=np.arange(32) < 10,
                        xyz=xyz.astype(np.float32)), X


def _drifted_state(s_end):
    """tests/test_loop.py::TestSim3Correction's chain: 6 keyframes whose
    stored centres shrink progressively toward 1 / s_end of the truth
    while their observations are those of the true cameras."""
    cfg = dict(max_keypoints=32, max_keyframes=8, max_landmarks=64,
               image_height=96, image_width=128, pyramid_levels=2, ba_kmax=8)
    K = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]], np.float32)
    rng = np.random.default_rng(2)
    nk, nl = 6, 24
    X = np.stack([rng.uniform(-2, 2, nl), rng.uniform(-1.5, 1.5, nl),
                  rng.uniform(5, 8, nl)], 1).astype(np.float32)
    c_true = np.stack([np.array([0.45 * k, 0, 0]) for k in range(nk)])
    gamma = 1.0 / np.linspace(1.0, s_end, nk)
    landmark = np.full((8, 32), -1, np.int32)
    xy = np.zeros((8, 32, 2), np.float32)
    tvs = np.zeros((8, 3), np.float32)
    for k in range(nk):
        tvs[k] = -gamma[k] * c_true[k]
        p = X - c_true[k]
        xy[k, :nl] = (p[:, :2] / p[:, 2:]) * 100.0 + np.array([64.0, 48.0])
        landmark[k, :nl] = np.arange(nl)
    return cfg, K, dict(
        landmark=landmark, xy=xy, rvec=np.zeros((8, 3), np.float32),
        tvec=tvs, kp_valid=np.arange(32)[None].repeat(8, 0) < nl,
        frame_no=np.arange(8, dtype=np.int32), kf_valid=np.arange(8) < nk,
        lm_valid=np.arange(64) < nl,
        xyz=np.pad(X / s_end, ((0, 40), (0, 0))).astype(np.float32)), \
        c_true, nk


def _both_states(cfg_kw, parts, prev_slot=None):
    """The JAX package's state (numpy leaves) and the port's on the CPU,
    from the same parts."""
    st = jax.device_get(jax_init_state(JaxConfig(**cfg_kw)))
    fr = st.kfs.frames._replace(**{k: parts[k] for k in (
        "landmark", "xy", "rvec", "tvec", "kp_valid", "frame_no")})
    st = st._replace(
        kfs=st.kfs._replace(frames=fr, valid=parts["kf_valid"]),
        lms=st.lms._replace(valid=parts["lm_valid"], xyz=parts["xyz"]))
    if prev_slot is not None:
        st = st._replace(prev=jax.tree.map(lambda x: x[prev_slot], fr))
    return st, state_from_numpy(st, "cpu")


def _assert_retriangulated(xyz_t, xyz_j, before, n_obs):
    """Positions within 1e-4 of each landmark's norm; landmarks with
    fewer than two observations bit-equal to their old positions."""
    multi = n_obs >= 2
    assert multi.sum() > 0 and (~multi).sum() > 0
    err = np.linalg.norm(xyz_t - xyz_j, axis=1)[multi]
    assert np.all(err <= 1e-4 * np.linalg.norm(xyz_j[multi], axis=1)), \
        err.max()
    np.testing.assert_array_equal(xyz_t[~multi], before[~multi])
    np.testing.assert_array_equal(xyz_j[~multi], before[~multi])


def _n_obs(tree):
    """Observations per landmark slot in a numpy state."""
    fr = tree.kfs.frames
    obs = (fr.landmark >= 0) & fr.kp_valid & tree.kfs.valid[:, None]
    L = tree.lms.valid.shape[0]
    n = np.bincount(fr.landmark[obs], minlength=L)[:L]
    return np.where(tree.lms.valid, n, 0)


def test_retriangulate_recovery_state_equals_jax():
    cfg_kw, K, parts, X = _retri_state()
    st_j, st_t = _both_states(cfg_kw, parts)
    out_j = jax.device_get(jloop.retriangulate_landmarks(
        JaxConfig(**cfg_kw), _jax_cam(K), jax.tree.map(jnp.asarray, st_j)))
    out_t = retriangulate_landmarks(SfMConfig(**cfg_kw), _port_cam(K), st_t)
    xyz_t = to_np(out_t.lms.xyz)
    _assert_retriangulated(xyz_t, np.asarray(out_j.lms.xyz), parts["xyz"],
                           _n_obs(st_j))
    # the points come back from their exact observations
    np.testing.assert_allclose(xyz_t[:8], X[:8], atol=1e-2)


def test_retriangulate_jax_scan_state_equals_jax(jax_scan):
    """On the JAX scan's carried state (ba_kmax 16): hundreds of
    landmarks with 2-6 views."""
    tree = jax_scan["tree"]
    st_j = jloop.retriangulate_landmarks(JaxConfig(**LOOP_KW),
                                         jax_scan["cam"],
                                         jax.tree.map(jnp.asarray, tree))
    st_t = retriangulate_landmarks(SfMConfig(**LOOP_KW), _port_cam(),
                                   state_from_numpy(tree, "cpu"))
    n_obs = _n_obs(tree)
    assert (n_obs >= 2).sum() > 100
    _assert_retriangulated(to_np(st_t.lms.xyz), np.asarray(st_j.lms.xyz),
                           np.asarray(tree.lms.xyz), n_obs)


# ------------------------------------------------------------- close_loop

def _probes(c_true, nk, scale, min_lm_birth=0):
    """The same probe for both packages (tests/test_loop.py's): the PnP
    pose at the true last centre, a drift of 1 m, two links."""
    links = np.full(32, -1, np.int32)
    links[24:26] = [3, 7]
    vals = dict(ok=True, rvec=np.zeros(3, np.float32),
                tvec=(-c_true[nk - 1]).astype(np.float32), n_inliers=30,
                drift=np.float32(1.0), links=links,
                min_lm_birth=min_lm_birth, scale=np.float32(scale),
                scale_ok=scale != 1.0, n_pairs=20)
    return (jloop.LoopProbe(**{k: jnp.asarray(v) for k, v in vals.items()}),
            LoopProbe(**{k: to_t(np.asarray(v)) for k, v in vals.items()}))


@pytest.mark.parametrize("scale,spans", [(1.5, None), (1.0, None),
                                         (1.5, [(2, 4)])])
def test_close_loop_equals_jax(scale, spans):
    """The drifted chain closed with scale 1.5, 1.0, and 1.5 over a span
    that overlaps an earlier closure (scale then forced to 1): poses and
    ``prev`` within 1e-5, links equal, landmarks within 1e-4 relative."""
    cfg_kw, K, parts, c_true, nk = _drifted_state(1.5)
    st_j, st_t = _both_states(cfg_kw, parts, prev_slot=nk - 1)
    pj, pt = _probes(c_true, nk, scale)
    out_j = jax.device_get(jloop.close_loop(
        JaxConfig(**cfg_kw), _jax_cam(K), jax.tree.map(jnp.asarray, st_j),
        nk - 1, pj, corrected_spans=spans))
    out_t = close_loop(SfMConfig(**cfg_kw), _port_cam(K), st_t, nk - 1, pt,
                       corrected_spans=spans)
    for name in ("rvec", "tvec"):
        np.testing.assert_allclose(to_np(getattr(out_t.kfs.frames, name)),
                                   np.asarray(getattr(out_j.kfs.frames,
                                                      name)), atol=1e-5)
        np.testing.assert_allclose(to_np(getattr(out_t.prev, name)),
                                   np.asarray(getattr(out_j.prev, name)),
                                   atol=1e-5)
        assert getattr(out_t.kfs.frames, name).dtype == torch.float32
    np.testing.assert_array_equal(to_np(out_t.kfs.frames.landmark),
                                  np.asarray(out_j.kfs.frames.landmark))
    assert to_np(out_t.kfs.frames.landmark)[nk - 1, 24] == 3
    xyz_j = np.asarray(out_j.lms.xyz)
    np.testing.assert_allclose(to_np(out_t.lms.xyz), xyz_j, rtol=1e-4,
                               atol=1e-4 * np.abs(xyz_j).max())
    # the first keyframe (fraction 0) keeps its pose bit for bit
    np.testing.assert_array_equal(to_np(out_t.kfs.frames.tvec)[0],
                                  parts["tvec"][0])


def test_close_loop_near_half_a_turn():
    """Keyframes turned by ~pi - 0.035 rad (float32, as the store holds
    them) and a correction that takes some past pi - 3e-4: the port's
    close_loop, in float64, returns every keyframe turned by exactly its
    share of the correction (1e-5 rad); the JAX package's, on float32
    copies, turns some by far more (the fault its ring run hits at half a
    turn)."""
    cfg_kw, K, parts, c_true, nk = _drifted_state(1.0)
    rng = np.random.default_rng(6)
    parts["rvec"][:nk] = (np.array([1e-3, 3.1066, 2e-3])
                          + rng.normal(0, 1e-3, (nk, 3))).astype(np.float32)
    st_j, st_t = _both_states(cfg_kw, parts, prev_slot=nk - 1)
    R_o = tloop._rodr(parts["rvec"][nk - 1].astype(np.float64))
    R_p = R_o @ tloop._rodr(np.array([0.0, 0.0868, 0.0]))
    pj, pt = _probes(c_true, nk, 1.0)
    r_p = tloop._log_so3(R_p).astype(np.float32)
    pj, pt = pj._replace(rvec=jnp.asarray(r_p)), pt._replace(rvec=to_t(r_p))
    out_t = close_loop(SfMConfig(**cfg_kw), _port_cam(K), st_t, nk - 1, pt)
    out_j = jax.device_get(jloop.close_loop(
        JaxConfig(**cfg_kw), _jax_cam(K), jax.tree.map(jnp.asarray, st_j),
        nk - 1, pj))
    dR = R_p.T @ tloop._rodr(parts["rvec"][nk - 1].astype(np.float64))
    w = tloop._log_so3(dR)

    def err(rv, i):
        want = tloop._rodr(parts["rvec"][i].astype(np.float64)) \
            @ tloop._rodr(w * i / (nk - 1)).T
        got = tloop._rodr(np.asarray(rv[i], np.float64))
        return np.arccos(np.clip((np.trace(got @ want.T) - 1) / 2, -1, 1))
    errs_t = [err(to_np(out_t.kfs.frames.rvec), i) for i in range(nk)]
    errs_j = [err(np.asarray(out_j.kfs.frames.rvec), i) for i in range(nk)]
    assert max(errs_t) < 1e-5, errs_t
    assert max(errs_j) > 0.01, errs_j


def test_sim3_beats_se3_on_scale_drift():
    """tests/test_loop.py's check on the port: with progressive scale
    drift, the sim(3) correction lands the chain on the truth, where the
    SE(3) special case cannot."""
    errs = {}
    for scale in (1.5, 1.0):
        cfg_kw, K, parts, c_true, nk = _drifted_state(1.5)
        _, st = _both_states(cfg_kw, parts, prev_slot=nk - 1)
        out = close_loop(SfMConfig(**cfg_kw), _port_cam(K), st, nk - 1,
                         _probes(c_true, nk, scale)[1])
        rv = to_np(out.kfs.frames.rvec)[:nk]
        tv = to_np(out.kfs.frames.tvec)[:nk]
        cs = np.stack([-rodrigues_np(rv[i]).T @ tv[i] for i in range(nk)])
        errs[scale] = float(np.abs(cs - c_true).max())
    assert errs[1.5] < 0.05, errs
    assert errs[1.5] < errs[1.0] / 3, errs


# ------------------------------------------------------------------ probe

# (loop_min_age, loop_min_inliers, probe ok): a loop found; the same with
# fewer old landmarks (PnP under its inlier gate); the scan as it is
PROBE_CASES = {"loop": (2, 25, True), "too_few": (4, 25, False),
               "no_loop": (2, 25, False)}


@pytest.mark.parametrize("case", list(PROBE_CASES))
def test_loop_probe_equals_jax(jax_scan, case):
    """build_loop_probe on the carried state, JAX's samples injected (its
    draw from fold_in(state.key, 17)): both windowless K1 results equal;
    ok, n_inliers, min_lm_birth, n_pairs and scale_ok equal; links >= 99%
    equal; pose, drift and scale within 1e-4."""
    age, min_inl, ok = PROBE_CASES[case]
    tree = jax_scan["tree"]
    if case == "no_loop":
        slot = int(np.argmax(np.where(tree.kfs.valid,
                                      tree.kfs.frames.frame_no, -1)))
    else:
        tree, slot = loop_state(tree)
    kw = dict(LOOP_KW, loop_min_age=age, loop_min_inliers=min_inl)
    jcfg, cfg = JaxConfig(**kw), SfMConfig(**kw)
    pj = jax.device_get(jax.jit(jloop.build_loop_probe(
        jcfg, jax_scan["cam"]))(jax.tree.map(jnp.asarray, tree),
                                jnp.asarray(slot)))
    # JAX's two matches and its RANSAC draw
    fr, lms, L = tree.kfs.frames, tree.lms, tree.lms.valid.shape[0]
    old = lms.valid & (lms.kf_alive >= age)
    linked = fr.landmark[slot] >= 0
    res_j = [jax_match(tree.rep_desc, jnp.zeros((L, 2)), old,
                       fr.desc[slot], fr.xy[slot], fr.kp_valid[slot] & m,
                       min_radius=0.0, max_radius=1e9,
                       max_distance=jcfg.match_max_distance,
                       ratio=jcfg.match_ratio) for m in (~linked, linked)]
    samples = jax_sample_masked(jax.random.fold_in(tree.key, 17),
                                res_j[0].mask & old, jcfg.pnp_hypotheses, 3)
    st = state_from_numpy(tree, "cpu")
    calls = []
    real = tloop.match_features_pallas

    def spy(*a, **k):
        calls.append(real(*a, **k))
        return calls[-1]
    tloop.match_features_pallas = spy
    try:
        pt = build_loop_probe(cfg, _port_cam())(
            st, slot, pnp_samples=to_t(np.asarray(samples)))
    finally:
        tloop.match_features_pallas = real
    assert len(calls) == 2
    for r_t, r_j in zip(calls, res_j):
        np.testing.assert_array_equal(to_np(r_t.mask), np.asarray(r_j.mask))
        np.testing.assert_array_equal(to_np(r_t.idx), np.asarray(r_j.idx))
    assert bool(pt.ok) == bool(pj.ok) == ok
    for name in ("n_inliers", "min_lm_birth", "n_pairs", "scale_ok"):
        assert int(getattr(pt, name)) == int(getattr(pj, name)), name
    links_t, links_j = to_np(pt.links), np.asarray(pj.links)
    assert (links_t == links_j).mean() >= 0.99
    for name in ("rvec", "tvec", "drift", "scale"):
        np.testing.assert_allclose(to_np(getattr(pt, name)),
                                   np.asarray(getattr(pj, name)), atol=1e-4,
                                   err_msg=name)
    if case == "loop":
        assert int(pt.n_inliers) >= 25 and (links_t >= 0).sum() >= 25
        assert bool(pt.scale_ok) and abs(float(pt.scale) - 1.3) < 0.01
        assert float(pt.drift) > cfg.loop_min_drift
