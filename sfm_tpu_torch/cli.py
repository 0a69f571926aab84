"""Desktop CLI: frames in -> PLY point cloud out (the PyTorch engine).

The flags of ``python -m sfm_tpu.cli`` plus ``--device`` (default
``cuda``): the engine runs on that device or the command fails; it never
moves to the CPU on its own.  ``--feature-dtype`` is accepted and, as in
``SfMConfig``, a no-op.

As the JAX CLI does, ``scan`` feeds the engine grey frames and runs scan
guidance (``--guidance``) in the CLI on the RGB frame, so the PLY colours
are grey; ``--chunk`` pads a short tail chunk by repeating its last frame
and drops the padded frames' metrics.

Usage:
    python -m sfm_tpu_torch.cli scan --input frames_dir/ --output cloud.ply \\
        --fx 525 --fy 525 --cx 320 --cy 240 [--dist k1 k2 p1 p2 k3] \\
        [--checkpoint state.npz] [--resume state.npz] [--metrics out.jsonl] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _json_line(m: dict) -> str:
    return json.dumps({k: (v.tolist() if hasattr(v, "tolist") else v)
                       for k, v in m.items()}) + "\n"


def cmd_scan(args) -> int:
    import torch
    from .config import SfMConfig
    from .engine import SfMEngine
    from .engine.state import resolve_device
    from .guidance import init_guidance, update_guidance
    from .io import PointCloud, load_state, open_source, save_state

    dev = resolve_device(args.device)
    src = open_source(args.input)
    first = next(iter(src))
    h, w = first[0].shape

    cfg = SfMConfig(image_height=h, image_width=w,
                    max_keypoints=args.max_keypoints,
                    max_keyframes=args.max_keyframes,
                    max_landmarks=args.max_landmarks,
                    pnp_solver=args.pnp_solver,
                    feature_dtype=args.feature_dtype,
                    track_with_flow=args.flow)
    K = np.array([[args.fx, 0, args.cx], [0, args.fy, args.cy], [0, 0, 1]],
                 np.float32)
    eng = SfMEngine(K, (h, w), args.dist, cfg, device=dev)
    if args.resume:
        eng.state = load_state(args.resume, cfg, dev)

    gstate = init_guidance(cfg, dev)
    gout = None
    metrics_f = open(args.metrics, "w") if args.metrics else None
    writer = None
    if args.video:
        from .viz import Y4MWriter
        writer = Y4MWriter(args.video, width=w, height=h)
    # throughput mode: --chunk batches frames through the deferred-mapping
    # chunked step, only when nothing needs per-frame host state
    chunked = args.chunk > 1 and writer is None and not args.guidance
    if args.chunk > 1 and not chunked:
        print("--chunk ignored: per-frame mode required for "
              "--video/--guidance", file=sys.stderr)
    chunk_n = min(args.chunk, cfg.keyframe_time_lag)
    buf = []

    n = 0
    t0 = time.time()

    def flush_chunk():
        nonlocal n
        if not buf:
            return
        real = len(buf)
        # a short tail chunk is padded to the full chunk by repeating its
        # last frame (near-zero-motion frames: no keyframe, negligible map
        # effect); the padded frames' metrics are dropped
        frames = buf + [buf[-1]] * (chunk_n - real)
        ms = eng.add_frames(np.stack(frames))[:real]
        buf.clear()
        if metrics_f:
            metrics_f.writelines(_json_line(mm) for mm in ms)
        n += real

    if chunked:
        for gray, _ in src:
            buf.append(gray)
            if args.max_frames and n + len(buf) >= args.max_frames:
                del buf[args.max_frames - n:]   # honour --max-frames exactly
                break
            if len(buf) == chunk_n:
                flush_chunk()
        flush_chunk()
    for gray, rgb in ([] if chunked else src):
        m = eng.add_frame(gray)
        if rgb is not None and int(m["status"]) == 1 and args.guidance:
            gstate, gout = update_guidance(
                cfg, gstate, torch.as_tensor(rgb.astype(np.float32),
                                             device=dev),
                eng.state.lms.xyz, eng.state.lms.valid, eng.cam.Kopt,
                eng.state.prev.rvec, eng.state.prev.tvec)
        if writer is not None:
            writer.write(_overlay(eng, gray, m,
                                  gout if args.guidance else None))
        if metrics_f:
            metrics_f.write(_json_line(m))
        n += 1
        if args.max_frames and n >= args.max_frames:
            break
    if writer is not None:
        writer.close()
    dt = time.time() - t0
    print(f"processed {n} frames in {dt:.1f}s ({n / max(dt, 1e-9):.1f} fps), "
          f"status={eng.status}", file=sys.stderr)

    if metrics_f:
        metrics_f.close()
    if args.checkpoint:
        save_state(args.checkpoint, eng.state)

    pts, colors = eng.get_reconstruction()
    cloud = PointCloud(pts, colors)
    cloud.center().scale(args.scale)
    cloud.write_ply(args.output)
    print(f"wrote {len(pts)} points to {args.output}", file=sys.stderr)
    return 0


def _overlay(eng, gray, m, guidance):
    """The debug overlay of one frame: detections, reprojected map points
    (while RUNNING) and the guidance box."""
    from .np_geometry import rodrigues_np
    from .viz import overlay_frame
    st = eng.state
    reproj = reproj_mask = None
    if int(m["status"]) == 1:
        lms_xyz = st.lms.xyz.cpu().numpy()
        R = rodrigues_np(st.prev.rvec.cpu().numpy())
        camp = lms_xyz @ R.T + st.prev.tvec.cpu().numpy()
        z = np.maximum(camp[:, 2], 1e-6)
        Kopt = eng.cam.Kopt.cpu().numpy()
        reproj = (camp[:, :2] / z[:, None]) @ Kopt[:2, :2].T + Kopt[:2, 2]
        reproj_mask = st.lms.valid.cpu().numpy() & (camp[:, 2] > 0)
    if guidance is not None:
        guidance = guidance._replace(**{
            k: getattr(guidance, k).cpu().numpy()
            for k in ("bbox_center", "bbox_axes", "bbox_extent")})
    return overlay_frame(gray, m, reproj_xy=reproj, reproj_mask=reproj_mask,
                         kp_xy=st.prev.xy_dist.cpu().numpy(),
                         kp_mask=st.prev.kp_valid.cpu().numpy(),
                         guidance=guidance)


def cmd_tum(args) -> int:
    """Run a TUM RGB-D sequence (monocular) and report sim(3) ATE."""
    from .config import SfMConfig
    from .engine import SfMEngine
    from .engine.state import resolve_device
    from .io.tum import TUM_INTRINSICS, TUMSequence, ate_sim3
    from .np_geometry import rodrigues_np

    dev = resolve_device(args.device)
    seq = TUMSequence(args.seq)
    intr = TUM_INTRINSICS[args.camera]
    first = next(seq.frames())
    h, w = first[1].shape
    cfg = SfMConfig(image_height=h, image_width=w,
                    max_keypoints=args.max_keypoints,
                    max_keyframes=args.max_keyframes,
                    max_landmarks=args.max_landmarks)
    K = np.array([[intr["fx"], 0, intr["cx"]],
                  [0, intr["fy"], intr["cy"]], [0, 0, 1]], np.float32)
    eng = SfMEngine(K, (h, w), intr.get("dist"), cfg, device=dev)
    kf_ts = {}
    n = 0
    for ts, gray, _ in seq.frames():
        m = eng.add_frame(gray)
        if bool(m["keyframe_added"]):
            kf_ts[int(eng.state.frame_count) - 1] = ts
        n += 1
        if args.max_frames and n >= args.max_frames:
            break
    kfs = eng.state.kfs
    valid = kfs.valid.cpu().numpy()
    out = {"frames": n, "status": eng.status,
           "n_keyframes": int(valid.sum()),
           "n_landmarks": int(eng.state.lms.valid.sum())}
    if seq.gt_ts is not None and out["n_keyframes"] >= 3:
        fns = kfs.frames.frame_no.cpu().numpy()[valid]
        rv = kfs.frames.rvec.cpu().numpy()[valid]
        tv = kfs.frames.tvec.cpu().numpy()[valid]
        order = np.argsort(fns)
        ts_arr = np.array([kf_ts.get(int(f), seq.rgb[min(int(f),
                           len(seq.rgb) - 1)][0]) for f in fns[order]])
        gt_c = seq.gt_positions_at(ts_arr)
        est_c = np.stack([-rodrigues_np(rv[i]).T @ tv[i] for i in order])
        out["ate_m"] = round(ate_sim3(est_c, gt_c), 4)
    print(json.dumps(out))
    return 0


def cmd_info(args) -> int:
    from .io import read_ply
    xyz, rgb = read_ply(args.input)
    print(json.dumps({
        "n_points": int(len(xyz)),
        "has_color": rgb is not None,
        "bbox_min": xyz.min(0).tolist() if len(xyz) else None,
        "bbox_max": xyz.max(0).tolist() if len(xyz) else None,
    }))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sfm_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("scan", help="run a scan: frames -> PLY")
    ps.add_argument("--input", required=True,
                    help="frame source: image dir, .npy/.npz, or .y4m")
    ps.add_argument("--output", required=True, help="output .ply path")
    ps.add_argument("--fx", type=float, required=True)
    ps.add_argument("--fy", type=float, required=True)
    ps.add_argument("--cx", type=float, required=True)
    ps.add_argument("--cy", type=float, required=True)
    ps.add_argument("--dist", type=float, nargs="*", default=None,
                    help="distortion k1 k2 p1 p2 [k3]")
    ps.add_argument("--scale", type=float, default=500.0,
                    help="output volume scale (ref: scaleVolume(500))")
    ps.add_argument("--max-keypoints", type=int, default=512)
    ps.add_argument("--max-keyframes", type=int, default=32)
    ps.add_argument("--max-landmarks", type=int, default=8192)
    ps.add_argument("--max-frames", type=int, default=0)
    ps.add_argument("--pnp-solver", choices=["dlt", "p3p"], default="dlt",
                    help="PnP minimal solver (p3p: 3-pt Grunert, tolerates"
                         " lower inlier ratios)")
    ps.add_argument("--feature-dtype", choices=["float32", "bfloat16"],
                    default="float32",
                    help="accepted for compatibility; a no-op here (the "
                         "descriptor runs in float32)")
    ps.add_argument("--checkpoint", default=None,
                    help="save engine state npz at the end")
    ps.add_argument("--resume", default=None,
                    help="resume engine state npz before scanning")
    ps.add_argument("--metrics", default=None,
                    help="write per-frame metrics JSONL")
    ps.add_argument("--chunk", type=int, default=1,
                    help="batch N frames per add_frames call (deferred "
                    "mapping; capped at the keyframe lag; incompatible "
                    "with --video/--guidance)")
    ps.add_argument("--flow", action="store_true",
                    help="flow-assisted tracking: LK-track features whose "
                         "descriptor match failed (blur/low-texture recall)")
    ps.add_argument("--guidance", action="store_true",
                    help="run scan-guidance segmentation on color frames")
    ps.add_argument("--video", default=None,
                    help="write a debug overlay video (.y4m)")
    ps.add_argument("--device", default="cuda",
                    help="torch device of the engine (default cuda; no "
                         "fallback to the CPU)")
    ps.set_defaults(fn=cmd_scan)

    pi = sub.add_parser("info", help="inspect a PLY file")
    pi.add_argument("--input", required=True)
    pi.set_defaults(fn=cmd_info)

    pt = sub.add_parser("tum", help="run a TUM sequence and report ATE")
    pt.add_argument("--seq", required=True, help="TUM sequence directory")
    pt.add_argument("--camera", default="fr3", choices=["fr1", "fr2", "fr3"])
    pt.add_argument("--max-keypoints", type=int, default=512)
    pt.add_argument("--max-keyframes", type=int, default=32)
    pt.add_argument("--max-landmarks", type=int, default=8192)
    pt.add_argument("--max-frames", type=int, default=0)
    pt.add_argument("--device", default="cuda",
                    help="torch device of the engine (default cuda)")
    pt.set_defaults(fn=cmd_tum)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
