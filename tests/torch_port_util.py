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


# tests/test_torch_loop*.py: TEST_CFG with a loop probe every 2 keyframe
# insertions (no landmark reaches the default loop_min_age in the 30-frame
# scan, so it probes and never closes) and tests/test_torch_global_ba.py's
# global BA settings
LOOP_KW = dict(TEST_CFG_KW, loop_detect_every=2, global_ba_iterations=6,
               global_ba_cg_iterations=15, ba_huber_delta=2.0)
LOOP_FRAMES = 30


def record_probes(eng, frame):
    """Wrap ``eng.probe_loop_closure``: each call appends the frame index
    in ``frame[0]`` to the returned list."""
    calls, real = [], eng.probe_loop_closure

    def wrapped():
        calls.append(frame[0])
        return real()
    eng.probe_loop_closure = wrapped
    return calls


def jax_loop_scan():
    """The JAX engine at LOOP_KW over LOOP_FRAMES frames of the TEST strafe
    scan (add_frame): the frames, the camera, the frames after which it
    probed, and its final state (numpy leaves)."""
    import jax

    from sfm_tpu.config import SfMConfig
    from sfm_tpu.engine import SfMEngine
    from sfm_tpu_torch.synthetic import SpriteScene, strafe_trajectory
    scene = SpriteScene(np.random.default_rng(3))
    rvecs, tvecs = strafe_trajectory(LOOP_FRAMES)
    frames = [scene.render(TEST_K, rvecs[i], tvecs[i], 240, 320)
              for i in range(LOOP_FRAMES)]
    eng = SfMEngine(TEST_K, (240, 320), None, SfMConfig(**LOOP_KW))
    frame = [0]
    probes = record_probes(eng, frame)
    for i, f in enumerate(frames):
        frame[0] = i
        eng.add_frame(f)
    return dict(frames=frames, cam=eng.cam, probes=probes,
                tree=jax.device_get(eng.state))


def loop_state(tree, scale=1.3, shift=0.2):
    """A scan's numpy state made into a loop at its newest keyframe: every
    other linked keypoint unlinked (its landmark is then found again by
    the loop probe's first match), the rest relinked to young twins at
    1 / ``scale`` of their landmark's position (the pairs of the scale
    estimate), and the keyframe's stored pose shifted by ``shift``.
    Returns (a copy of the state, the keyframe slot)."""
    import copy
    t = copy.deepcopy(tree)
    fr, lms = t.kfs.frames, t.lms
    s = int(np.argmax(np.where(t.kfs.valid, fr.frame_no, -1)))
    linked = np.nonzero((fr.landmark[s] >= 0) & fr.kp_valid[s])[0]
    free = np.nonzero(~lms.valid)[0]
    for j, k in enumerate(linked):
        if j % 2 == 0:
            fr.landmark[s, k] = -1
        else:
            n = free[j // 2]
            lms.xyz[n] = lms.xyz[fr.landmark[s, k]] / scale
            lms.valid[n], lms.kf_alive[n] = True, 0
            fr.landmark[s, k] = n
    fr.tvec[s] = fr.tvec[s] + np.float32([shift, 0, 0])
    return t, s


def jitted_jax_retriangulation(monkeypatch):
    """Patch the JAX package's ``loop.retriangulate_landmarks`` with the
    same function jitted (eagerly it compiles every op on its first call,
    ~10 s a shape), also where its ``close_loop`` calls it."""
    import jax

    from sfm_tpu.engine import loop
    real, jitted = loop.retriangulate_landmarks, {}

    def retriangulate(cfg, cam, state):
        if cfg not in jitted:
            jitted[cfg] = jax.jit(lambda c, s: real(cfg, c, s))
        return jitted[cfg](cam, state)
    monkeypatch.setattr(loop, "retriangulate_landmarks", retriangulate)


def far_ba_problem(seed, n_cams=12, n_pts=300, kmax=6,
                   shift=(200.0, 100.0, -50.0), device="cpu"):
    """``ba_scene``'s problem moved ``shift`` away from the world's origin
    (X + shift, t - R shift: the same residuals in exact arithmetic), as a
    long scan's late keyframes lie far from its first: |R X| ~ 230 over
    depths of 4-8.  Returns K2's arguments (K, R, t, X, lm_free, cam_free,
    lm_cam, lm_uv, lm_w, Huber delta 2) as float32 tensors on ``device``."""
    from sfm_tpu_torch.ba.large import build_lm_tables_device
    from sfm_tpu_torch.ba.residuals import Observations
    from sfm_tpu_torch.np_geometry import rodrigues_np
    rng = np.random.default_rng(seed)
    _, init, obs = ba_scene(rng, n_cams, n_pts, kmax, noise_px=0.7,
                            outlier_p=0.05)
    d = np.asarray(shift)
    R = np.stack([rodrigues_np(r) for r in init["rv"].astype(np.float64)])
    t = init["tv"] - np.einsum("cab,b->ca", R, d)
    o = Observations(*(to_t(a).to(device) for a in obs))
    o = o._replace(cam_idx=o.cam_idx.long(), lm_idx=o.lm_idx.long())
    lm_cam, lm_uv, lm_w, _ = build_lm_tables_device(o, n_pts, kmax)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.tensor(TEST_K, **f32), torch.tensor(R, **f32),
            torch.tensor(t, **f32), torch.tensor(init["X"] + d, **f32),
            torch.ones(n_pts, **f32), torch.ones(n_cams, **f32), lm_cam,
            lm_uv, lm_w, 2.0)


def gradient_distances(args, g_lm, g_cam):
    """K2's g_lm and g_cam (``args`` its arguments) entry by entry: the
    largest distance from the plain version run in float64 over the
    entry's own term magnitude, sum |J|^T w (|r| + |uv|) with J the
    weighted Jacobian block (the measure of chip_smoke.py's
    ``gradient_witness``).  Returns (g_lm's, g_cam's)."""
    from sfm_tpu_torch.ba.linearize_pallas import ba_linearize_plain
    from sfm_tpu_torch.ba.residuals import (Observations, huber_weights,
                                            residuals_and_jacobians)
    a64 = [a.double() if torch.is_tensor(a) and a.is_floating_point() else a
           for a in args]
    K, R, t, X, lm_free, cam_free, lm_cam, lm_uv, lm_w, huber = a64
    C, (L, kmax) = R.shape[0], lm_cam.shape
    cam = lm_cam.reshape(-1).long().clamp(0, C - 1)
    lm = torch.arange(L, device=X.device).repeat_interleave(kmax)
    uv = lm_uv.reshape(-1, 2)
    r, A, B = residuals_and_jacobians(K, R, t, X,
                                      Observations(cam, lm, uv,
                                                   lm_w.reshape(-1)))
    w = lm_w.reshape(-1) * huber_weights(r, huber)
    m = ((r.abs() + uv.abs()) * w[:, None])[:, :, None]
    mag_c = (A.abs() * (w * cam_free[cam])[:, None, None]).transpose(1, 2) @ m
    mag_l = (B.abs() * (w * lm_free[lm])[:, None, None]).transpose(1, 2) @ m
    ref = ba_linearize_plain(*a64)
    out = []
    for g, j, idx, mag, n in ((g_lm, 2, lm, mag_l, L),
                              (g_cam, 4, cam, mag_c, C)):
        scale = torch.zeros((n, mag.shape[1]), dtype=torch.float64,
                            device=X.device).index_add_(0, idx, mag[..., 0])
        out.append(float(((g.double() - ref[j]).abs()
                          / scale.clamp(min=1e-30)).max()))
    return tuple(out)


# ---------------------------------------------------------------------------
# ranks of a torch.distributed world, spawned under gloo.  The workers
# live here (spawn re-imports this module, which imports no JAX in
# the children); each writes its results to a file for the test.
# ---------------------------------------------------------------------------

def spawn_ranks(fn, world: int, args, tmp_path, timeout: float = 180.0,
                init: bool = True, device="cpu"):
    """``fn(rank, world, *args)`` in ``world`` spawned processes on
    ``device``, joined in a gloo world through a ``file://`` store under
    ``tmp_path`` (with ``init``; otherwise ``fn`` joins one itself), by
    chip_smoke.py's ``spawn_world``.  A rank that raises fails the whole
    spawn; one still running after ``timeout`` seconds is killed, and the
    spawn raises TimeoutError."""
    chip_smoke().spawn_world(fn, world, args,
                             str(tmp_path / "rendezvous") if init else None,
                             device, timeout)


def chip_smoke():
    """chip_smoke.py, imported by its module name (the spawned ranks find
    its functions by that name)."""
    import importlib
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


def load_ranks(out_dir, name: str, world: int):
    """The ``world`` ranks' result files ``{name}.{rank}.npz``."""
    return [dict(np.load(out_dir / f"{name}.{r}.npz")) for r in range(world)]


def dist_solver_worker(rank, world, out_dir, jobs, device="cpu"):
    """Each job (name, solver "dense" or "large", its build keywords, the
    numpy arguments of the returned fn) on a (1, world) mesh over "map",
    its tensors on ``device``; writes {name}.{rank}.npz with rvec, tvec,
    xyz (this rank's shard), the stats, the rank's position on "map" and
    this rank's launches of K2, K3 and K3-gather."""
    from sfm_tpu_torch import native
    from sfm_tpu_torch.ba.large import ObsTables
    from sfm_tpu_torch.ba.residuals import Observations
    from sfm_tpu_torch.parallel import (build_dist_ba, build_dist_large_ba,
                                        make_scan_map_mesh)
    mesh = make_scan_map_mesh(1, device=device)
    dev = lambda a: to_t(a).to(device)  # noqa: E731
    for name, solver, kw, a in jobs:
        if solver == "dense":
            build, tab = build_dist_ba, Observations(*map(dev, a["obs"]))
        else:
            build = build_dist_large_ba
            tab = ObsTables(*(None if x is None else dev(x)
                              for x in a["tables"]))
        fn = build(mesh, "map", **kw)
        native.reset_launch_counts()
        rv, tv, X, st = fn(dev(a["K"]), dev(a["rv"]), dev(a["tv"]),
                           dev(a["X"]), tab, dev(a["cam_free"]),
                           dev(a["lm_free"]))
        launches = [native.LAUNCHES[k] for k in ("ba_linearize",
                                                 "schur_apply",
                                                 "schur_gather")]
        np.savez(out_dir / f"{name}.{rank}.npz", rv=to_np(rv), tv=to_np(tv),
                 X=to_np(X), initial_cost=to_np(st.initial_cost),
                 final_cost=to_np(st.final_cost), lam=to_np(st.lam),
                 accepted=to_np(st.accepted),
                 map_rank=mesh.get_local_rank("map"), launches=launches)


def torchrun_worker(rank, world, out_dir, port):
    """Joins a gloo world through torchrun's variables alone (env://) with
    ``initialize_hosts(device="cpu")``, then all-reduces its rank."""
    import os

    import torch.distributed as dist

    from sfm_tpu_torch.parallel import initialize_hosts
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    initialize_hosts(device="cpu")
    try:
        t = torch.tensor([float(rank + 1)])
        dist.all_reduce(t)
        np.savez(out_dir / f"torchrun.{rank}.npz",
                 world=dist.get_world_size(), rank=dist.get_rank(),
                 backend=dist.get_backend(), total=float(t))
    finally:
        dist.destroy_process_group()


def mesh_worker(rank, world, out_dir, local_world):
    """``make_scan_map_mesh`` on a gloo world with ``LOCAL_WORLD_SIZE``:
    the default shape, and the shape asked with n_scan=3; and an
    all-reduce over each axis of the default mesh."""
    import os

    import torch.distributed as dist

    from sfm_tpu_torch.parallel import make_scan_map_mesh
    os.environ["LOCAL_WORLD_SIZE"] = str(local_world)
    mesh = make_scan_map_mesh(device="cpu")
    three = make_scan_map_mesh(3, device="cpu")
    sums = []
    for axis in ("scan", "map"):
        t = torch.tensor([float(rank)])
        dist.all_reduce(t, group=mesh.get_group(axis))
        sums.append(float(t))
    np.savez(out_dir / f"mesh.{rank}.npz", shape=tuple(mesh.mesh.shape),
             three=tuple(three.mesh.shape),
             names=np.array(mesh.mesh_dim_names),
             pos=(mesh.get_local_rank("scan"), mesh.get_local_rank("map")),
             sums=sums)


def flat_tree(tree, prefix="") -> dict:
    """A nested dict of arrays as one dict with dotted keys."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def fleet_trace(step, states, frames) -> dict:
    """Step a fleet through frames [T, B, ...]: each frame's metrics and
    the final state, flattened (``flat_tree``) with keys "m{t}.*" and
    "state.*"."""
    from sfm_tpu_torch.engine.state import state_to_numpy
    out = {}
    for t, images in enumerate(frames):
        states, m = step(states, images)
        out.update({f"m{t}.{k}": to_np(v) for k, v in m.items()})
    out.update(flat_tree(state_to_numpy(states), "state."))
    return out


def sharded_fleet_worker(rank, world, out_dir, cfg_kw, K, frames):
    """A fleet of frames.shape[1] scans split over ``world`` ranks on the
    "scan" axis of a (world, 1) mesh, stepped through ``frames`` by
    ``build_sharded_step``; writes its block's ``fleet_trace`` and whether
    a batch that does not split raises."""
    from sfm_tpu_torch.config import SfMConfig
    from sfm_tpu_torch.engine.state import CameraParams, init_batched_state
    from sfm_tpu_torch.parallel import (build_sharded_step,
                                        make_scan_map_mesh,
                                        shard_batched_state)
    cfg = SfMConfig(**cfg_kw)
    cam = CameraParams(K=to_t(K), d=torch.zeros(5), Kopt=to_t(K))
    mesh = make_scan_map_mesh(world, device="cpu")
    B = frames.shape[1]
    states = shard_batched_state(init_batched_state(cfg, B, "cpu"), mesh)
    images = [shard_batched_state(to_t(f), mesh) for f in frames]
    out = fleet_trace(build_sharded_step(cfg, cam, mesh), states, images)
    try:
        shard_batched_state(init_batched_state(cfg, world + 1, "cpu"), mesh)
        out["odd_batch_raised"] = np.array(False)
    except ValueError:
        out["odd_batch_raised"] = np.array(True)
    np.savez(out_dir / f"fleet.{rank}.npz", **out)


def dryrun_worker(rank, world, out_dir):
    """``entry.dryrun_multichip(world, device="cpu")``; writes its
    metrics and the two solvers' costs."""
    from sfm_tpu_torch.entry import dryrun_multichip
    out = dryrun_multichip(world, device="cpu")
    np.savez(out_dir / f"dryrun.{rank}.npz",
             status=to_np(out["metrics"]["status"]),
             n_detected=to_np(out["metrics"]["n_detected"]),
             dense=[float(out["dist_ba"][3].initial_cost),
                    float(out["dist_ba"][3].final_cost)],
             large=[float(out["dist_large_ba"][3].initial_cost),
                    float(out["dist_large_ba"][3].final_cost)],
             rv=to_np(out["dist_large_ba"][0]),
             engine_status=to_np(out["large_engine"]["status"]))
