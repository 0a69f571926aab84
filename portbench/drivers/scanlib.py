"""What the scan drivers share: the scene pool a traffic file describes,
rendered on the host in the main process, a fresh engine per scan, the
final map read back after the window, and the comparison with the ground
truth.

A traffic file fixes the scenes (``scene_seed``, ``scenes``, ``n_sprites``,
``spread``, ``sprite_size``) and the camera path (``frames_per_scan``,
``step``, ``yaw_rate``); ``--seed`` picks the order in which the scans
come and seeds each engine's random draws, so every seed does the same
work in another order."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import scan_judge
from portbench.reference.synthetic import SpriteScene, strafe_trajectory

RUNNING, LOST = 1, 2


def camera(ctx):
    """(K [3, 3] float32, (H, W))."""
    return (np.asarray(ctx.config["K"], np.float32),
            tuple(ctx.config["image_size"]))


def scene(traffic, k: int) -> SpriteScene:
    rng = np.random.default_rng([int(traffic["scene_seed"]), k])
    return SpriteScene(rng, n_sprites=int(traffic["n_sprites"]),
                       spread=float(traffic["spread"]),
                       sprite_size=float(traffic.get("sprite_size", 0.4)))


def trajectory(traffic, n_frames=None):
    return strafe_trajectory(n_frames or int(traffic["frames_per_scan"]),
                             step=float(traffic["step"]),
                             yaw_rate=float(traffic["yaw_rate"]))


def render(sc, K, rv, tv, size, rgb: bool) -> np.ndarray:
    """Frames [n, H, W] (or [n, H, W, 3]) as uint8, as a camera gives
    them."""
    H, W = size
    return np.stack([np.clip(sc.render(K, rv[i], tv[i], H, W, rgb=rgb),
                             0, 255) for i in range(len(rv))]
                    ).astype(np.uint8)


def scene_pool(ctx, rgb: bool):
    """[(scene, frames)] for every scene of the traffic file, and the true
    poses (rv, tv) of the camera path they share."""
    K, size = camera(ctx)
    rv, tv = trajectory(ctx.traffic)
    pool = []
    for k in range(int(ctx.traffic["scenes"])):
        sc = scene(ctx.traffic, k)
        pool.append((sc, render(sc, K, rv, tv, size, rgb)))
    return pool, (rv, tv)


def scan_order(ctx, n_scenes: int):
    """The scenes in the order this seed feeds them, repeated."""
    rng = np.random.default_rng([int(ctx.seed) % (1 << 63), 1])
    order = rng.permutation(n_scenes)

    def nth(i):
        return int(order[i % n_scenes])
    return nth


def engine_seed(ctx, i: int) -> int:
    return int((int(ctx.seed) * 1000003 + 7919 * i) % (1 << 31))


# the control (``--control 1``): the port's two float32 solvers whose
# outputs are judged, the tracker's pose refinement (a frame's pose) and
# the mapping pass's BA (the map), each replaced by the plain reference
# computed in bfloat16, the precision below the configuration's
CONTROL_BF16 = 1
_PROGRAM = {}


def new_engine(ctx, i: int):
    """A fresh engine on the configuration as stated, with the solvers
    that ``ctx.control`` asks for."""
    from sfm_tpu_torch.config import SfMConfig
    from sfm_tpu_torch.engine import SfMEngine
    _use_solvers(ctx.control == CONTROL_BF16)
    K, size = camera(ctx)
    return SfMEngine(K, size, config=SfMConfig(**ctx.config["engine"]),
                     device=ctx.device, seed=engine_seed(ctx, i))


def _use_solvers(bf16: bool):
    import importlib
    tracking = importlib.import_module("sfm_tpu_torch.engine.tracking")
    mapping = importlib.import_module("sfm_tpu_torch.engine.mapping")
    if not _PROGRAM:
        _PROGRAM.update(refine_pose=tracking.refine_pose,
                        run_large_ba=mapping.run_large_ba)
    tracking.refine_pose = _pose_in_bf16 if bf16 else _PROGRAM["refine_pose"]
    mapping.run_large_ba = _ba_in_bf16 if bf16 else _PROGRAM["run_large_ba"]


def _pose_in_bf16(K, rvec, tvec, xyz, uv, w, iters=10, damping=1e-4):
    from portbench.reference import pose_refine
    return pose_refine.refine(K, rvec, tvec, xyz, uv, w, iters,
                              dtype=torch.bfloat16, damping=damping)


def _ba_in_bf16(K, rvec, tvec, xyz, tables, *, cam_free, lm_free,
                iterations, cg_iterations, huber_delta, **_):
    """The mapping pass's BA by the reference in bfloat16, from the same
    tables, start and settings."""
    from sfm_tpu_torch.ba.core import BAStats
    from portbench.reference import ba_lm
    L, kmax = tables.lm_cam.shape
    pr = dict(K=K, rv=rvec, tv=tvec, X=xyz, cam_free=cam_free,
              lm_free=lm_free, cam_idx=tables.lm_cam.reshape(-1),
              lm_idx=torch.arange(L, device=xyz.device
                                  ).repeat_interleave(kmax),
              uv=tables.lm_uv.reshape(-1, 2), w=tables.lm_w.reshape(-1))
    rv, tv, X, c0, c1, acc = ba_lm.solve(
        pr, iterations=iterations, cg_iterations=cg_iterations,
        huber_delta=huber_delta, dtype=torch.bfloat16)
    f = lambda v: torch.tensor(v, device=xyz.device)  # noqa: E731
    return rv.float(), tv.float(), X.float(), BAStats(
        f(c0), f(c1), f(0.0), f(acc))


def answers(outs: list, first_frame_no: int, segment: int = 0) -> list:
    """The entry's per-frame metric dicts as the judge reads them;
    ``segment`` counts the mapping passes that ran before these frames."""
    return [dict(frame_no=first_frame_no + i, status=int(m["status"]),
                 rvec=np.asarray(m["rvec"], np.float64),
                 tvec=np.asarray(m["tvec"], np.float64),
                 keyframe_added=bool(m["keyframe_added"]), segment=segment)
            for i, m in enumerate(outs)]


def snapshot(eng) -> dict:
    """The final map of an engine, on the host."""
    st = eng.state
    fr = st.kfs.frames
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    return dict(kf_valid=host(st.kfs.valid), kf_rvec=host(fr.rvec),
                kf_tvec=host(fr.tvec), kf_frame_no=host(fr.frame_no),
                kf_xy=host(fr.xy), kf_landmark=host(fr.landmark),
                kf_kp_valid=host(fr.kp_valid), lm_xyz=host(st.lms.xyz),
                lm_valid=host(st.lms.valid))


def failed_frames(frames: list, bootstrap_frames: int) -> int:
    """Frames after the scan's bootstrap chunk that ended LOST (neither
    RUNNING nor still bootstrapping)."""
    return sum(1 for f in frames[bootstrap_frames:] if f["status"] == LOST)


def judge(ctx, scans: list, gt) -> dict:
    """The widest reading of each number over the scans: each scan a dict
    with ``frames``, ``snap``, ``scene`` and ``partial``."""
    K, _ = camera(ctx)
    rv, tv = gt
    whole, cut = [], []
    for s in scans:
        nums = scan_judge.judge_scan(s["frames"], rv, tv, s["snap"],
                                     s["scene"], K)
        ctx.log(f"scan of {len(s['frames'])} frames"
                f"{' (cut by the window)' if s['partial'] else ''}: "
                + ", ".join(f"{k} {v:.4g}" if v is not None else f"{k} none"
                            for k, v in nums.items()))
        (cut if s["partial"] else whole).append(nums)
    return scan_judge.widest(whole, cut)
